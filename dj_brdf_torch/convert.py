"""Carry fit parameters and materials between the JAX package and this
port.

The JAX side is given as numpy arrays (``np.asarray`` of its leaves),
either a mapping of field name to array or any object with those
fields as attributes (a NamedTuple, a frozen dataclass). Leading batch
axes are kept. The tables and the measured and fitted models
(``Tabular``, ``TabularAnisotropic``, ``Utia``, ``SGD``, ``ABC``) come
over with their arrays' dtypes. :func:`material_from_jax` takes a JAX
renderer material itself and rebuilds it, field by field, from the
port's classes of the same names, and :func:`envmap_from_jax` copies an environment map's
tables bit for bit. Nothing here imports JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import dataclasses

import numpy as np
import torch

from dj_brdf_torch import fresnel
from dj_brdf_torch.fit.lsq import RawFit
from dj_brdf_torch.fresnel import Schlick
from dj_brdf_torch.lean.filtered import FilteredBeckmannMaterial
from dj_brdf_torch.lean.lrep import Lrep
from dj_brdf_torch.microfacet import ndf
from dj_brdf_torch.microfacet.ndf import Tabular, TabularAnisotropic
from dj_brdf_torch.microfacet.params import MicrofacetParams
from dj_brdf_torch.models.lambert import Lambert
from dj_brdf_torch.models.abc_model import ABC
from dj_brdf_torch.models.merl import Merl
from dj_brdf_torch.models.sgd import SGD
from dj_brdf_torch.models.utia import Utia
from dj_brdf_torch.render import materials
from dj_brdf_torch.render.envmap import EnvMap

_PARAMS = ("ax", "ay", "rho", "txn", "tyn")
_TABULAR = ("p22", "sigma", "cdf", "qf")
_TABULAR_ANISO = ("p22", "sigma", "pdf1", "cdf1", "qf1_table", "pdf2",
                  "cdf2", "qf2_table")
_ABC = ("kd", "a", "b", "c", "ior")


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


def _as_is(obj, names, device):
    """Fields as tensors on ``device`` with their arrays' dtypes."""
    return {k: torch.as_tensor(np.array(_get(obj, k)), device=device)
            for k in names}


def tabular_from_jax(dist, device=None) -> Tabular:
    """JAX ``Tabular`` (its tables as numpy) -> the port's, keeping the
    tables' dtype and any leading stack axes."""
    return Tabular(**_as_is(dist, _TABULAR, device))


def tabular_to_numpy(dist: Tabular) -> dict:
    return _numpy(dist, _TABULAR)


def tabular_anisotropic_from_jax(dist, device=None) -> TabularAnisotropic:
    """JAX ``TabularAnisotropic`` (its eight tables as numpy) -> the
    port's, keeping the tables' dtype."""
    return TabularAnisotropic(**_as_is(dist, _TABULAR_ANISO, device))


def utia_from_jax(utia, device=None) -> Utia:
    """JAX ``Utia`` (its table, and its packed layout when it has one, as
    numpy) -> the port's; the tables take ``config.default_float()``, as
    ``Utia`` says."""
    packed = _get(utia, "packed")
    return Utia(table=torch.as_tensor(np.array(_get(utia, "table")),
                                      device=device),
                packed=None if packed is None else torch.as_tensor(
                    np.array(packed), device=device))


def sgd_from_jax(sgd, device=None) -> SGD:
    """JAX ``SGD`` (its (..., 12, 3) params as numpy) -> the port's."""
    return SGD(**_as_is(sgd, ("params",), device))


def abc_from_jax(abc, device=None) -> ABC:
    """JAX ``ABC`` (kd, a, b, c, ior as numpy) -> the port's."""
    return ABC(**_as_is(abc, _ABC, device))


def merl_from_jax(merl, device=None) -> Merl:
    """JAX ``Merl`` (its table as numpy) -> the port's; the table takes
    ``config.default_float()``, as ``Merl`` says."""
    return Merl(table=torch.as_tensor(np.array(_get(merl, "table")),
                                      device=device))


#: the port's classes a JAX material may be built from, by class name
_MATERIAL_CLASSES = {cls.__name__: cls for cls in (
    materials.MicrofacetMaterial, materials.MeasuredMaterial,
    materials.CosineMaterial, materials.ConductorWrap,
    materials.TexturedMicrofacetMaterial, materials.UVMappedMaterial,
    FilteredBeckmannMaterial, Lrep, MicrofacetParams,
    ndf.GGX, ndf.GGXSphericalCaps, ndf.Beckmann, ndf.Tabular,
    ndf.TabularAnisotropic, Lambert, Merl, Utia, SGD, ABC,
    fresnel.Ideal, fresnel.Schlick, fresnel.Unpolarized, fresnel.SGDFresnel,
    fresnel.Conductor, fresnel.SplineFresnel)}


def material_from_jax(obj, device=None):
    """A JAX renderer material (``MicrofacetMaterial``,
    ``MeasuredMaterial``, ``CosineMaterial``, ``ConductorWrap``,
    ``TexturedMicrofacetMaterial``, ``UVMappedMaterial``,
    ``FilteredBeckmannMaterial``) and everything inside it
    (distributions, Fresnel models, parameters, LEAN moments,
    ``Lambert``/``Merl``/``Utia``/``SGD``/``ABC`` models) -> the port's
    object of the same class
    name. Array leaves become tensors on ``device`` with their dtype;
    static fields and ``None`` leaves are copied. Raises ``TypeError``
    for a class the port does not have."""
    name = type(obj).__name__
    cls = _MATERIAL_CLASSES.get(name)
    if cls is None:
        raise TypeError(f"no counterpart in the port for {name}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if f.metadata.get("static", False) or value is None:
            kwargs[f.name] = value
        elif type(value).__name__ in _MATERIAL_CLASSES:
            kwargs[f.name] = material_from_jax(value, device)
        else:
            kwargs[f.name] = torch.as_tensor(np.array(value), device=device)
    return cls(**kwargs)


def envmap_from_jax(em, device=None) -> EnvMap:
    """JAX ``EnvMap`` (its tables as numpy) -> the port's, every table
    copied bit for bit (the alias partners' int32 bit patterns too)."""
    def arr(name):
        value = _get(em, name)
        return None if value is None else torch.as_tensor(
            np.array(value, np.float32), device=device)
    return EnvMap(radiance=arr("radiance"), packed=arr("packed"),
                  alias=arr("alias"), rot=arr("rot"))
