"""Tiny frozen-dataclass helpers and a pytree walk over them.

Every model/parameter container in the port is a frozen dataclass whose
tensor fields are its data. Fields marked with :func:`static_field` are
configuration (resolution ints, flags) rather than tensors; the mark
is kept so that code which walks a container's tensors
(:func:`tensor_fields`) can skip them, as JAX's pytree registration
does in the reference package. :func:`tree_map`, :func:`tree_leaves` and
:func:`tree_unflatten` walk such containers (nested in dataclasses,
tuples, NamedTuples, lists and dicts) the way ``jax.tree_util`` walks
pytrees: tensors are the leaves, static fields and other values stay.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


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


def tree_map(fn: Callable, tree):
    """``tree`` with every tensor ``t`` replaced by ``fn(t)``: dataclasses
    are rebuilt through ``dataclasses.replace`` (their non-static fields
    mapped), tuples, NamedTuples, lists and dicts keep their type, any
    other value (None, a flag, a float) stays as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            name: tree_map(fn, getattr(tree, name))
            for name in tensor_fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def tree_unflatten(like, leaves):
    """``like`` with its tensors replaced, in order, by ``leaves`` (as
    many as :func:`tree_leaves` of ``like`` gives)."""
    leaves = list(leaves)
    want = len(tree_leaves(like))
    if len(leaves) != want:
        raise ValueError(f"tree_unflatten: {len(leaves)} leaves for a "
                         f"template of {want}")
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
