"""Carry fit parameters between the JAX package and this port.

The JAX side is given as numpy arrays (``np.asarray`` of its leaves),
either a mapping of field name to array or any object with those
fields as attributes (a NamedTuple, a frozen dataclass). Leading batch
axes are kept. Nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dj_brdf_torch.fit.lsq import RawFit
from dj_brdf_torch.fresnel import Schlick
from dj_brdf_torch.microfacet.params import MicrofacetParams

_PARAMS = ("ax", "ay", "rho", "txn", "tyn")


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _tensors(obj, names, device):
    return {k: torch.as_tensor(np.array(_get(obj, k), np.float32),
                               device=device) for k in names}


def _numpy(obj, names):
    return {k: getattr(obj, k).detach().cpu().numpy() for k in names}


def raw_from_jax(raw, device=None) -> RawFit:
    """JAX ``RawFit`` (as numpy arrays) -> the port's :class:`RawFit`."""
    return RawFit(**_tensors(raw, RawFit._fields, device))


def raw_to_numpy(raw: RawFit) -> dict:
    """The port's :class:`RawFit` -> dict of numpy arrays, the fields
    of the JAX ``RawFit``."""
    return _numpy(raw, RawFit._fields)


def params_from_jax(params, device=None) -> MicrofacetParams:
    """JAX ``MicrofacetParams`` (as numpy arrays) -> the port's."""
    return MicrofacetParams(**_tensors(params, _PARAMS, device))


def params_to_numpy(params: MicrofacetParams) -> dict:
    return _numpy(params, _PARAMS)


def fresnel_from_jax(fres, device=None) -> Schlick:
    """JAX ``fresnel.Schlick`` (its ``f0`` as numpy) -> the port's."""
    return Schlick(**_tensors(fres, ("f0",), device))


def fresnel_to_numpy(fres: Schlick) -> dict:
    return _numpy(fres, ("f0",))
