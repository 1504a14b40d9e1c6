"""Tiny frozen-dataclass helper.

Every model/parameter container in the port is a frozen dataclass whose
tensor fields are its data. Fields marked with :func:`static_field` are
configuration (resolution ints, flags) rather than tensors; the mark
is kept so that code which walks a container's tensors
(:func:`tensor_fields`) can skip them, as JAX's pytree registration
does in the reference package.
"""

from __future__ import annotations

import dataclasses
from typing import Any


def static_field(**kwargs: Any) -> dataclasses.Field:
    """A dataclass field holding static (non-tensor) metadata."""
    metadata = dict(kwargs.pop("metadata", {}))
    metadata["static"] = True
    return dataclasses.field(metadata=metadata, **kwargs)


def tensor_fields(obj) -> tuple[str, ...]:
    """Names of the non-static fields of a :func:`pytree_dataclass`."""
    return tuple(f.name for f in dataclasses.fields(obj)
                 if not f.metadata.get("static", False))


def pytree_dataclass(cls: type) -> type:
    """Decorator: frozen dataclass with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)

    cls.replace = replace
    return cls
