"""Frame statistics and profiling.

JAX equivalent of the reference's observability stack (SURVEY §5.1):
`Timer` (`Framework/Timer.h`), per-stage `FrameStats`
(`Renderer/LumenRenderer.h:29-34`, filled across `TraceFrame`), and the
ImGui `Profiler`'s rolling window (`ToolUI/Profiler.h:6-41`). Because the
frame is one fused XLA program, per-stage wall times come either from
whole-frame timing (cheap, default) or `jax.profiler` traces (deep dives).
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, Optional

import jax


class Timer:
    """≙ Framework/Timer.h stopwatch."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def measure_s(self) -> float:
        return time.perf_counter() - self._t0

    def measure_ms(self) -> float:
        return self.measure_s() * 1e3


class FrameStats:
    """Named stage timings for one frame (≙ LumenRenderer::FrameStats)."""

    def __init__(self, frame_id: int = 0):
        self.frame_id = frame_id
        self.times_ms: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t = Timer()
        yield
        if block_on is not None:
            jax.block_until_ready(block_on)
        self.times_ms[name] = self.times_ms.get(name, 0.0) + t.measure_ms()


class Profiler:
    """Rolling per-stage history (≙ ToolUI::Profiler 5-min deque)."""

    def __init__(self, window: int = 1024):
        self.window = window
        self.history: deque = deque(maxlen=window)

    def add(self, stats: FrameStats):
        self.history.append(stats)

    def mean_ms(self, stage: str) -> float:
        vals = [s.times_ms[stage] for s in self.history if stage in s.times_ms]
        return sum(vals) / len(vals) if vals else 0.0

    def summary(self) -> Dict[str, float]:
        stages = {k for s in self.history for k in s.times_ms}
        return {k: self.mean_ms(k) for k in sorted(stages)}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler device trace (XPlane) for deep perf dives —
    the substitute for the reference's per-kernel CUDA timings."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_memory_stats(device: Optional[object] = None) -> Dict[str, int]:
    """VRAM-accounting analogue (≙ ReSTIR VRAM prints, `ReSTIR.cpp:281-289`)."""
    d = device or jax.devices()[0]
    stats = getattr(d, "memory_stats", lambda: None)()
    return dict(stats) if stats else {}
