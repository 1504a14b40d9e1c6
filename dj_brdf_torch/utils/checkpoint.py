"""Checkpoint/resume for fitted parameters and tabulated models.

The reference has no persistence beyond Mitsuba's plugin serialize()
(which rebuilds the fitted BRDF from scratch on load,
mitsuba/dj_brdf.cpp:307-316); here any pytree of the port
(MicrofacetParams, Tabular/TabularAnisotropic tables, Fresnel splines,
materials, envmaps, whole fit states, nested in dicts and tuples)
round-trips through ``torch.save``.

Counterpart of ``dj_brdf_tpu/utils/checkpoint.py``: orbax becomes
``torch.save`` of the tree with its dataclasses as dicts of their
fields, read back by ``torch.load(..., weights_only=True)``, which
unpickles tensors and plain containers only. ``like=`` restores the
container types through :mod:`dj_brdf_torch.core.pytree`. Where the
tensors land is the caller's ``map_location``.
"""

from __future__ import annotations

import dataclasses

import torch

from dj_brdf_torch.core.pytree import tensor_fields, tree_leaves, \
    tree_unflatten


def _plain(tree):
    """``tree`` with its dataclasses as dicts of their non-static fields
    and its tuples (NamedTuples too) as lists: containers
    ``weights_only`` loading takes; tensors detached."""
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {name: _plain(getattr(tree, name))
                for name in tensor_fields(tree)}
    if isinstance(tree, (tuple, list)):
        return [_plain(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, tree) -> None:
    """Save a pytree of tensors to ``path`` (one file)."""
    torch.save(_plain(tree), path)


def load_checkpoint(path: str, like=None, map_location=None):
    """Load a pytree saved by :func:`save_checkpoint`: nested dicts and
    lists of tensors, or, given ``like`` (a template pytree), the
    template's containers, dataclasses and static fields holding the
    saved tensors in order. ``map_location`` as in ``torch.load``
    (``"cpu"``, ``"cuda"``)."""
    tree = torch.load(path, map_location=map_location, weights_only=True)
    if like is None:
        return tree
    return tree_unflatten(like, tree_leaves(_as_tuples(tree)))


def _as_tuples(tree):
    """Saved lists back as tuples and dicts as dicts, so that
    :func:`tree_leaves` walks them in the order they were saved."""
    if isinstance(tree, list):
        return tuple(_as_tuples(x) for x in tree)
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tree
