"""Spherical integrals.

Replaces the reference's serial direction loops (furnace test
tests/nrm_utia.cpp:20-51) with quadrature grids evaluated in chunks of
outgoing directions on one device; the reduction is a plain sum.

Counterpart of ``dj_brdf_tpu/parallel/integrals.py``. With ``mesh=`` the
outgoing batch is sharded by block over the ranks and all-gathered.
"""

from __future__ import annotations

import math

import torch

from dj_brdf_torch.core.math import from_spherical

#: outgoing directions evaluated at once (the JAX package's
#: ``lax.map(batch_size=64)``)
CHUNK = 64


def _grid(n_theta, n_phi, device):
    """(theta, phi) of the tests/nrm_utia.cpp quadrature: k/n * pi/2 and
    k/n * 2 pi, float32, (n_theta, n_phi) each."""
    u1 = torch.arange(n_theta, dtype=torch.float32, device=device) / n_theta
    u2 = torch.arange(n_phi, dtype=torch.float32, device=device) / n_phi
    return torch.meshgrid(u1 * math.pi / 2.0, u2 * math.pi * 2.0,
                          indexing="ij")


def furnace_integral(evalp_fn, o, n_theta: int = 64, n_phi: int = 256,
                     mesh=None):
    """White-furnace energy integral int evalp(i, o) sin(theta) di for a
    batch of outgoing directions ``o`` (..., 3), on ``o``'s device.
    Matches the quadrature of tests/nrm_utia.cpp:20-51. The o-batch is
    evaluated ``CHUNK`` directions at a time, so the (n_o x n_theta x
    n_phi) integrand never materializes whole. With a
    :class:`~dj_brdf_torch.parallel.mesh.Mesh`, each rank integrates its
    block of the o-batch (padded to a multiple of the ranks) and every
    rank gets the whole result."""
    T, Ph = _grid(n_theta, n_phi, o.device)
    i = from_spherical(T, Ph)                    # (n_theta, n_phi, 3)
    sin_t = torch.sin(T)[..., None]
    dw = (math.pi / 2.0 / n_theta) * (math.pi * 2.0 / n_phi)

    flat_o = o.reshape(-1, 3)
    n_o = flat_o.shape[0]
    if mesh is not None:
        flat_o = mesh.shard(flat_o)
    out = []
    for k in range(0, flat_o.shape[0], CHUNK):
        chunk = flat_o[k:k + CHUNK]
        shape = (chunk.shape[0], n_theta, n_phi, 3)
        vals = evalp_fn(i.expand(shape),
                        chunk[:, None, None, :].expand(shape))
        out.append(torch.sum(vals * sin_t, dim=(1, 2)) * dw)
    out = torch.cat(out)
    if mesh is not None:
        out = mesh.all_gather(out, n=n_o)
    return out.reshape(o.shape[:-1] + (3,))


def furnace_test(evalp_fn, n_out_theta: int = 64, n_out_phi: int = 256,
                 mesh=None, tol: float = 1.0, device="cuda"):
    """Energy-conservation check over an outgoing grid (the machine-
    checkable pass/fail of the reference, tests/nrm_utia.cpp:53-69), on
    ``device``: the card unless the caller asks for ``"cpu"`` (without a
    card the default raises). ``mesh`` shards the outgoing grid (see
    :func:`furnace_integral`). Returns (ok, max_integral)."""
    T, Ph = _grid(n_out_theta, n_out_phi, device)
    vals = furnace_integral(evalp_fn, from_spherical(T, Ph), mesh=mesh)
    max_val = float(torch.max(vals))
    return bool(max_val <= tol), max_val
