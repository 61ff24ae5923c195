"""TRS transform hierarchy with dirty-propagation callbacks.

JAX equivalent of the reference's `Lumen::Transform`
(`ModelLoading/Transform.h:12-150`): translation/quaternion-rotation/scale
with parent/child chaining, lazy world matrices, and a dependent-callback
system that lets scene instances react to edits (the reference uses it to
trigger AS rebuilds, `PTMeshInstance.cpp:36-40`). Host-side (numpy) — device
work only sees baked matrices.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = np.asarray(q, np.float64)
    n = max(np.sqrt(x * x + y * y + z * z + w * w), 1e-12)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def quat_from_axis_angle(axis, angle_rad: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-12)
    s = np.sin(angle_rad / 2)
    return np.array([*(axis * s), np.cos(angle_rad / 2)], np.float32)


class Transform:
    """Mutable TRS node; world matrix = parent.world @ local."""

    def __init__(self, translation=(0, 0, 0), rotation=(0, 0, 0, 1), scale=(1, 1, 1)):
        self._t = np.asarray(translation, np.float32)
        self._r = np.asarray(rotation, np.float32)
        self._s = np.asarray(scale, np.float32)
        self._parent: Optional["Transform"] = None
        self._children: List["Transform"] = []
        self._dependents: List[Callable[[], None]] = []
        self._local: Optional[np.ndarray] = None
        self._world: Optional[np.ndarray] = None

    # -- hierarchy ---------------------------------------------------------
    def set_parent(self, parent: Optional["Transform"]):
        if self._parent is not None:
            self._parent._children.remove(self)
        self._parent = parent
        if parent is not None:
            parent._children.append(self)
        self._invalidate()

    # -- edits (≙ Transform setters marking dependents dirty) --------------
    @property
    def translation(self):
        return self._t

    @translation.setter
    def translation(self, v):
        self._t = np.asarray(v, np.float32)
        self._invalidate()

    @property
    def rotation(self):
        return self._r

    @rotation.setter
    def rotation(self, q):
        self._r = np.asarray(q, np.float32)
        self._invalidate()

    @property
    def scale(self):
        return self._s

    @scale.setter
    def scale(self, v):
        self._s = np.asarray(v, np.float32)
        self._invalidate()

    def add_dependent(self, cb: Callable[[], None]):
        """≙ Transform::AddDependent → PTMeshInstance::DependencyCallback."""
        self._dependents.append(cb)

    # -- matrices ----------------------------------------------------------
    @property
    def local_matrix(self) -> np.ndarray:
        if self._local is None:
            m = np.eye(4, dtype=np.float32)
            m[:3, :3] = quat_to_matrix(self._r) * self._s[None, :]
            m[:3, 3] = self._t
            self._local = m
        return self._local

    @property
    def world_matrix(self) -> np.ndarray:
        if self._world is None:
            if self._parent is None:
                self._world = self.local_matrix.copy()
            else:
                self._world = self._parent.world_matrix @ self.local_matrix
        return self._world

    def _invalidate(self):
        self._local = None
        self._world = None
        for cb in self._dependents:
            cb()
        for c in self._children:
            c._invalidate_world()

    def _invalidate_world(self):
        self._world = None
        for cb in self._dependents:
            cb()
        for c in self._children:
            c._invalidate_world()
