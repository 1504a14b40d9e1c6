"""Environment-map (image-based) lighting for the path tracer.

The reference's Mitsuba scenes (the matpreview setup its LEAN maps ship
for, mitsuba/README:21-23) are lit by lat-long environment emitters;
Mitsuba importance-samples the emitter image and combines emitter and
BSDF sampling with multiple importance sampling. This module is the
port's equivalent:

* **O(1) alias-table sampling** (Walker/Vose): one draw reads ONE
  4-wide alias row, at any map resolution. The table is built once on
  the host at scene load by a small C++ library
  (``csrc/alias.cpp``, compiled with ``g++`` at first use).
* **One-row radiance+pdf queries**: radiance toward a direction is one
  row of a corner-packed (H*W, 16) table, the 4 bilinear corner texels
  plus their 4 pdf bins, so an eval-with-pdf (the MIS path) reads one
  row. Maps above 2^18 texels pack nearest rows [r, g, b, pdf_bin].
* **Orientation**: an optional ``rot`` (3x3 to-world rotation) matches
  the reference scenes' emitter transforms; directions rotate in
  sample/eval, tables stay in the emitter's local frame.

Conventions: row j covers theta in [j, j+1] * pi/H (z-up; theta=0 is
+z), column i covers phi in [i, i+1] * 2pi/W, dir = (sin t cos p,
sin t sin p, cos t). The pdf values are the true sampling density over
solid angle (bin mass / (bin angle area * sin theta)), so dividing by
them is unbiased and MIS weights can use them directly.

Differentiation: ``build`` runs on the host in numpy float64. For
inverse lighting, :meth:`EnvMap.rebind` swaps in a differentiable
radiance under the FROZEN sampling structure (the detached-sampler
estimator): gradients flow through every radiance evaluation, while the
proposal density stays constant.

Counterpart of ``dj_brdf_tpu/render/envmap.py``; the tables are those
of its native-built ``EnvMap.build`` bit for bit.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from dj_brdf_torch.core.pytree import pytree_dataclass

_lock = threading.Lock()
_lib = None


def _alias_lib():
    global _lib
    with _lock:
        if _lib is None:
            from dj_brdf_torch.ops import _build

            lib = _build.load("alias")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.djbt_build_alias.argtypes = [f64p, ctypes.c_long, f32p, i32p]
            lib.djbt_build_alias.restype = ctypes.c_int
            _lib = lib
        return _lib


def build_alias(mass):
    """Walker/Vose alias table of an unnormalized probability vector:
    returns (prob (n,) f32, alias (n,) i32), O(n) in the host library
    (``csrc/alias.cpp``). Raises ``ValueError`` for an empty, negative,
    NaN or all-zero mass."""
    mass = np.ascontiguousarray(mass, np.float64).reshape(-1)
    prob = np.empty(mass.size, np.float32)
    alias = np.empty(mass.size, np.int32)
    rc = _alias_lib().djbt_build_alias(mass, mass.size, prob, alias)
    if rc != 0:
        raise ValueError(f"djbt_build_alias failed: {rc}")
    return prob, alias


def _pack_radiance_corners(radiance):
    """(H, W, C) -> (H*W, 4C): the 4 bilinear corner texels of each BASE
    cell (j, i): centers (j, i), (j, i+1 wrap), (j+1 clamp, i), (j+1
    clamp, i+1 wrap). Differentiable (reused by rebind)."""
    h, w, c = radiance.shape
    x01 = torch.roll(radiance, -1, dims=1)
    down = torch.cat([radiance[1:], radiance[-1:]], dim=0)
    d01 = torch.roll(down, -1, dims=1)
    return torch.cat([radiance, x01, down, d01], -1).reshape(h * w, 4 * c)


@pytree_dataclass
class EnvMap:
    """Lat-long environment light with O(1) alias importance tables."""

    radiance: torch.Tensor   # (H, W, 3)
    packed: torch.Tensor     # (H*W, 16) 4 bilinear radiance corners (12)
    #                          + the 4 corners' pdf bins (4); nearest:
    #                          (H*W, 4) [r, g, b, pdf_bin]
    alias: torch.Tensor      # (H*W, 4) [prob, alias_idx bits, pb_self,
    #                          pb_alias]; pb = bin mass/(dtheta*dphi)
    rot: torch.Tensor | None = None  # optional (3, 3) to-world rotation

    #: maps above this many texels take nearest rows (16 B) instead of
    #: bilinear ones (64 B): sub-texel detail is sub-pixel there anyway
    NEAREST_AUTO_BINS = 1 << 18

    @classmethod
    def build(cls, radiance, rotation=None, filter: str = "auto",
              device=None):
        """Sampling tables from an (H, W, 3) lat-long radiance image
        (values >= 0), computed on the host in numpy float64 at scene
        load; the alias construction is O(H*W) native code. The tables
        go to ``device``: by default the radiance tensor's device, and
        the card for a numpy image (pass ``device="cpu"`` on the CPU).
        For differentiable radiance under a frozen sampler (inverse
        lighting) see :meth:`rebind`.

        ``filter``: "bilinear" packs 4 corner texels + 4 pdf bins per
        row; "nearest" packs [r, g, b, pdf_bin]; "auto" picks nearest
        for maps over ``NEAREST_AUTO_BINS`` texels."""
        if filter not in ("auto", "bilinear", "nearest"):
            raise ValueError(f"unknown filter {filter!r}")
        if device is None:
            device = (radiance.device if isinstance(radiance, torch.Tensor)
                      else torch.device("cuda"))
        if isinstance(radiance, torch.Tensor):
            radiance = radiance.detach().cpu()
        rad_np = np.asarray(radiance, np.float32)
        h, w = rad_np.shape[:2]
        if filter == "auto":
            filter = "nearest" if h * w > cls.NEAREST_AUTO_BINS \
                else "bilinear"
        if not np.isfinite(rad_np).all():
            raise ValueError(
                "EnvMap.build: radiance contains non-finite values")
        lum = np.maximum(rad_np, 0.0).mean(-1) + 1e-12
        sin_rows = np.sin((np.arange(h) + 0.5) * (np.pi / h))
        mass = lum * sin_rows[:, None]
        mass = mass / mass.sum()                     # (H, W), sums to 1
        pb = (mass / ((np.pi / h) * (2.0 * np.pi / w))).astype(np.float32)
        prob, alias_idx = build_alias(mass)
        pb_flat = pb.reshape(-1)
        # the partner index rides in the f32 row as its raw int32 BIT
        # PATTERN (read back with .view(torch.int32)): a float-valued
        # index would round above 2^24 bins
        alias_bits = np.ascontiguousarray(alias_idx,
                                          np.int32).view(np.float32)
        alias_tab = np.stack([prob, alias_bits, pb_flat,
                              pb_flat[alias_idx]], -1)

        rad_t = torch.from_numpy(rad_np)
        if filter == "nearest":
            packed = torch.cat([rad_t.reshape(h * w, 3),
                                torch.from_numpy(pb_flat)[:, None]], -1)
        else:
            packed = torch.cat([_pack_radiance_corners(rad_t),
                                _pack_radiance_corners(
                                    torch.from_numpy(pb)[..., None])], -1)
        if rotation is not None:
            rotation = torch.as_tensor(rotation, dtype=torch.float32,
                                       device=device)
        return cls(radiance=rad_t.to(device), packed=packed.to(device),
                   alias=torch.from_numpy(alias_tab).to(device),
                   rot=rotation)

    @property
    def _nearest(self) -> bool:
        return self.packed.shape[-1] == 4

    def rebind(self, radiance):
        """An EnvMap whose radiance (and packed radiance texels) are
        ``radiance``, differentiable, while the sampling structure
        (alias table and pdf bins) stays frozen at build time: still
        unbiased (the pdfs describe the actual sampler), and gradients
        flow through every radiance evaluation."""
        radiance = torch.as_tensor(radiance, dtype=torch.float32,
                                   device=self.packed.device)
        h, w = radiance.shape[:2]
        if self._nearest:
            packed = torch.cat([radiance.reshape(h * w, 3),
                                self.packed[:, 3:].detach()], -1)
        else:
            packed = torch.cat([_pack_radiance_corners(radiance),
                                self.packed[:, 12:].detach()], -1)
        return self.replace(radiance=radiance, packed=packed)

    @staticmethod
    def rotation_z(angle, device=None):
        """(3, 3) rotation about +z by ``angle`` radians (the common
        lat-long emitter orientation control)."""
        a = torch.as_tensor(angle, dtype=torch.float32, device=device)
        c, s = torch.cos(a), torch.sin(a)
        zero, one = torch.zeros_like(a), torch.ones_like(a)
        return torch.stack([torch.stack([c, -s, zero]),
                            torch.stack([s, c, zero]),
                            torch.stack([zero, zero, one])])

    # -- frames --------------------------------------------------------
    def _to_local(self, dx, dy, dz):
        if self.rot is None:
            return dx, dy, dz
        r = self.rot
        return (r[0, 0] * dx + r[1, 0] * dy + r[2, 0] * dz,
                r[0, 1] * dx + r[1, 1] * dy + r[2, 1] * dz,
                r[0, 2] * dx + r[1, 2] * dy + r[2, 2] * dz)

    def _to_world(self, dx, dy, dz):
        if self.rot is None:
            return dx, dy, dz
        r = self.rot
        return (r[0, 0] * dx + r[0, 1] * dy + r[0, 2] * dz,
                r[1, 0] * dx + r[1, 1] * dy + r[1, 2] * dz,
                r[2, 0] * dx + r[2, 1] * dy + r[2, 2] * dz)

    # -- cells ---------------------------------------------------------
    def _cell_from_grid(self, tg, pg):
        """Packed-row index + filter fractions from LOCAL grid
        coordinates (tg = theta*H/pi in [0,H], pg = phi*W/2pi), without
        trigonometry. Bilinear: the half-shifted base cell + in-cell
        fractions; nearest: the direction's own bin, fractions unused.
        Every index is clipped or wrapped into the table before a read."""
        h, w = self.radiance.shape[:2]
        if self._nearest:
            j0 = torch.floor(tg).to(torch.int32).clamp(0, h - 1)
            i0 = torch.remainder(torch.floor(pg).to(torch.int32), w)
            zero = torch.zeros_like(tg)
            return j0 * w + i0, zero, zero
        t1 = torch.clamp(tg - 0.5, 0.0, h - 1.0)
        t2 = pg - 0.5
        j0 = torch.floor(t1).to(torch.int32).clamp(max=h - 1)
        i0f = torch.floor(t2)
        f1 = t1 - j0
        f2 = t2 - i0f
        # i0f is -1 wherever pg < 0.5: remainder (not fmod) wraps it
        i0 = torch.remainder(i0f.to(torch.int32), w)
        return j0 * w + i0, f1, f2

    def _cell(self, lx, ly, lz):
        """Cell of a LOCAL direction; also its floored sin(theta)
        (shared by all pdf paths: one pole floor everywhere, so the
        sampler's pdf and the MIS-side pdf agree at the poles)."""
        h, w = self.radiance.shape[:2]
        theta = torch.arccos(torch.clamp(lz, -1.0, 1.0))
        phi = torch.atan2(ly, lx)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        idx, f1, f2 = self._cell_from_grid(theta * (h / math.pi),
                                           phi * (w / (2.0 * math.pi)))
        sin_t = torch.clamp(torch.sqrt(torch.clamp(1.0 - lz * lz, min=0.0)),
                            min=1e-6)
        return idx, f1, f2, sin_t

    def _lookup(self, idx, f1, f2):
        """ONE row read: radiance + the direction's exact pdf bin.
        Bilinear mode interpolates the 4 packed corner texels (periodic
        in phi, clamped in theta) and selects the true bin by the
        half-cell bits; nearest mode reads [r, g, b, pb]."""
        row = self.packed.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, self.packed.shape[-1])
        if self._nearest:
            return row[..., 0], row[..., 1], row[..., 2], row[..., 3]
        f1e = f1[..., None]
        f2e = f2[..., None]
        a = row[..., 0:3] + f2e * (row[..., 3:6] - row[..., 0:3])
        b = row[..., 6:9] + f2e * (row[..., 9:12] - row[..., 6:9])
        rgb = a + f1e * (b - a)
        hi1 = f1 >= 0.5
        hi2 = f2 >= 0.5
        pb = torch.where(hi1,
                         torch.where(hi2, row[..., 15], row[..., 14]),
                         torch.where(hi2, row[..., 13], row[..., 12]))
        return rgb[..., 0], rgb[..., 1], rgb[..., 2], pb

    # -- queries -------------------------------------------------------
    def eval_with_pdf(self, dx, dy, dz):
        """(r, g, b, pdf) toward a WORLD direction: one row read."""
        lx, ly, lz = self._to_local(dx, dy, dz)
        idx, f1, f2, sin_t = self._cell(lx, ly, lz)
        r, g, b, pb = self._lookup(idx, f1, f2)
        return r, g, b, pb / sin_t

    def eval(self, dx, dy, dz):
        """Filtered radiance only. Returns (r, g, b)."""
        r, g, b, _ = self.eval_with_pdf(dx, dy, dz)
        return r, g, b

    def pdf(self, dx, dy, dz):
        """True sampling density over solid angle at a direction."""
        return self.eval_with_pdf(dx, dy, dz)[3]

    def sample_grid(self, u1, u2, u3):
        """Alias draw: LOCAL grid coordinates (tg, pg) of an
        importance-sampled direction plus its bin density pb, from ONE
        alias-row read.

        f32 bit budget (a single 24-bit uniform cannot select among 2M
        bins AND drive the accept test AND give in-bin offsets): ``u1``
        -> row index (its sub-row fraction is the Walker accept
        threshold); ``u2`` -> column index (its fraction is the phi
        in-bin offset); ``u3`` -> theta in-bin offset."""
        h, w = self.radiance.shape[:2]
        xr = torch.clamp(u1, 0.0, 1.0) * h
        j_sel = xr.to(torch.int32).clamp(max=h - 1)
        frac = xr - j_sel                        # accept threshold
        xc = torch.clamp(u2, 0.0, 1.0) * w
        i_sel = xc.to(torch.int32).clamp(max=w - 1)
        fc = xc - i_sel                          # phi in-bin offset
        idx = j_sel * w + i_sel                  # uniform over bins

        row = self.alias.index_select(0, idx.reshape(-1)).reshape(
            *idx.shape, 4)
        prob = row[..., 0]
        take = frac < prob
        # the partner's int32 bit pattern: a view, never a cast
        alias_idx = row[..., 1].contiguous().view(torch.int32)
        bin_ = torch.where(take, idx, alias_idx)
        pb = torch.where(take, row[..., 2], row[..., 3])
        j = torch.div(bin_, w, rounding_mode="floor")
        i = bin_ - j * w
        fr = torch.clamp(u3, 0.0, 0.999999)
        fc = torch.clamp(fc, 0.0, 0.999999)
        return j + fr, i + fc, pb

    def sample(self, u1, u2, u3):
        """Importance-sample a WORLD direction: (dx, dy, dz, pdf). One
        alias-row read; the pdf is the exact density of the draw,
        assembled from the alias row."""
        h, w = self.radiance.shape[:2]
        tg, pg, pb = self.sample_grid(u1, u2, u3)
        theta = tg * (math.pi / h)
        phi = pg * (2.0 * math.pi / w)
        sin_t = torch.sin(theta)
        lx = sin_t * torch.cos(phi)
        ly = sin_t * torch.sin(phi)
        lz = torch.cos(theta)
        dx, dy, dz = self._to_world(lx, ly, lz)
        pdf = pb / torch.clamp(sin_t, min=1e-6)
        return dx, dy, dz, pdf


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (beta=2) weight for strategy a against b. The
    inner ``where`` keeps the gradient free of NaN where both are 0."""
    a2 = pdf_a * pdf_a
    denom = a2 + pdf_b * pdf_b
    return torch.where(denom > 0.0,
                       a2 / torch.where(denom > 0.0, denom, 1.0), 0.0)
