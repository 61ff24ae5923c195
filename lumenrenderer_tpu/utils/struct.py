"""Frozen dataclasses that are JAX pytrees.

`@struct.dataclass` makes a frozen dataclass whose fields are pytree leaves,
except those declared with `struct.field(static=True)`, which ride in the
treedef (hashable, compared on retrace). Instances get `.replace(**kw)`.
Built on `jax.tree_util.register_dataclass`.
"""
from __future__ import annotations

import dataclasses

import jax


def field(static: bool = False, **kwargs):
    """A dataclass field; `static=True` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **kw: dataclasses.replace(self, **kw)
    return cls
