"""Multi-host entry point.

The reference has no distributed backend at all (single CUcontext,
SURVEY §2.7); this design scales over a `jax.sharding.Mesh` whose devices
may span hosts. This module is the process bootstrap: every process runs the
same program and calls `initialize()` before touching jax.devices(), with an
explicit coordinator address, process count and process id.
"""
from __future__ import annotations

import os
from typing import Optional

import jax

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Bring up jax.distributed for multi-host meshes.

    - Pass coordinator/num_processes/id, or set JAX_COORDINATOR_ADDRESS /
      JAX_NUM_PROCESSES / JAX_PROCESS_ID. Every process must call this
      before any device op.
    - Safe no-op (returns False) without a coordinator address, or when
      already initialized.
    """
    global _initialized
    if _initialized:
        return False
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    num_processes = num_processes if num_processes is not None else (
        int(os.environ["JAX_NUM_PROCESSES"])
        if "JAX_NUM_PROCESSES" in os.environ else None)
    process_id = process_id if process_id is not None else (
        int(os.environ["JAX_PROCESS_ID"])
        if "JAX_PROCESS_ID" in os.environ else None)
    # no backend probe here: any backend-initializing JAX API
    # (jax.devices(), ...) before jax.distributed.initialize() makes it raise
    # "must be called before any backend is initialized"
    if coordinator_address is None:
        return False  # single-process: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def process_info() -> dict:
    """Host/topology summary for logs (≙ the reference's device printout)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
