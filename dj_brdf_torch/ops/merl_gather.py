"""MERL table gathers: the lookup behind ``Merl.eval`` and the two
gather formulations of ``tools/gather_experiments.py``.

On CUDA tensors each function runs its hand-written Hopper kernel in
``csrc/merl_gather.cu`` (built on first use, see :mod:`._build`); on
CPU tensors it runs its plain PyTorch version beside it. A CUDA tensor
never reaches a plain version: the kernel runs, or the call raises.

* :func:`merl_lookup` — M raw MERL tables ``(M, 3, P)`` at flat indices
  ``(N,)`` shared by all M: ``(M, N, 3)`` scaled reflectance, 0 where a
  bin is below the horizon, times ``iz`` for ``evalp``. Counterpart of
  the ``jnp.take`` in ``dj_brdf_tpu/models/merl.py::Merl.eval`` and of
  the Pallas kernel ``k4`` of ``tools/gather_experiments.py``. On the
  card it takes one of two kernel paths, chosen by :func:`lookup_packs`:
  the direct kernel, or mark, pack and look up for large N.
* :func:`gather_plane` — ``plane[idx]`` from one channel plane (``k4``
  itself, K5).
* :func:`gather_rowlane` — ``plane2d[row, lane]`` from the plane padded
  to ``(rows, 128)`` (``k5`` of the same script, K6). K5 and K6 are one
  kernel template with two index policies.

Indices are clipped into range (``jnp.take``'s ``mode="clip"``). The
kernels and the plain versions do the same f32 multiplies in the same
order and agree bit for bit. The kernels compute no gradient and refuse
tensors that require one; on the card :func:`merl_lookup` wraps them in
:class:`MerlLookupGrad`, whose backward (:func:`lookup_backward`) is
plain torch ops: a scatter-add into the tables' cells (``index_add_``),
the transpose of the gather that XLA derived on the TPU, never a Pallas
kernel there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: kernel launches in this process, per wrapper (plain-version calls on
#: CPU tensors do not count); a lookup call counts once, whatever number
#: of kernels its path launches (one direct kernel, or a mark kernel and
#: a pack and a lookup kernel per pair of tables)
LAUNCHES = {"merl_lookup": 0, "gather_plane": 0, "gather_rowlane": 0}

LANES = 128           # lane width of the K6 two-level index
_MAX_MATERIALS = 65535  # the kernel's grid.y
_LIB = "merl_gather"

# The lookup's path rule, in 32-B L2 sectors per table. The direct kernel
# reads three random sectors per lookup, one per channel plane. The
# packed path packs the tables in pairs, G = min(M, 2) tables to a
# record, and reads one record sector per lookup for the G tables (1/G
# per table), after packing the table: at most every sector of its three
# planes (4-B entries, 3/8 of a sector per cell), its 16-B records (1/2
# a sector per cell) and the mark (a byte per cell, per pair).
# Packing pays where 3 N > N / G + P (3/8 + 1/2 + 1 / (32 G)): at
# G = 2 from N > 0.356 P (519,412 lookups per MERL table), at G = 1
# (M = 1) from N > 0.453 P.
SECTOR_BYTES = 32
PACK_SECTORS_PER_CELL = 3 * 4 / SECTOR_BYTES + 16 / SECTOR_BYTES
DIRECT_SECTORS_PER_LOOKUP = 3


def lookup_packs(m, n, plane):
    """Whether the lookup of ``m`` tables of ``plane`` cells at ``n``
    shared indices takes the packed path: where it reads fewer L2 sectors
    than the direct kernel (see ``PACK_SECTORS_PER_CELL``)."""
    group = max(1, min(2, m))
    packed_sectors = n / group + plane * (PACK_SECTORS_PER_CELL
                                          + 1 / (SECTOR_BYTES * group))
    return packed_sectors < DIRECT_SECTORS_PER_LOOKUP * n


@functools.cache
def _lib():
    """The built kernel library with its C signatures declared; built on
    first use."""
    from dj_brdf_torch.ops import _build

    lib = _build.load(_LIB)
    ptr, i64, i32, f32 = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float)
    lib.djbt_merl_lookup.argtypes = [i32, ptr, ptr, ptr, i64, i32, i64,
                                     f32, f32, f32, ptr, ptr]
    lib.djbt_merl_lookup_packed.argtypes = [i32, ptr, ptr, ptr, i64, i32,
                                            i64, f32, f32, f32, ptr, ptr,
                                            ptr, ptr]
    lib.djbt_gather_plane.argtypes = [i32, ptr, i64, ptr, i64, ptr, ptr]
    lib.djbt_gather_rowlane.argtypes = [i32, ptr, i32, i32, ptr, ptr, i64,
                                        ptr, ptr]
    for fn in (lib.djbt_merl_lookup, lib.djbt_merl_lookup_packed,
               lib.djbt_gather_plane, lib.djbt_gather_rowlane):
        fn.restype = ctypes.c_int
    lib.djbt_gather_error_string.argtypes = [ctypes.c_int]
    lib.djbt_gather_error_string.restype = ctypes.c_char_p
    return lib


def _same_device(name, *tensors):
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: all tensors must be on one device, got "
                         f"{sorted(str(d) for d in devices)}")


def _index(name, t, n=None):
    if t.dim() != 1 or (n is not None and t.shape[0] != n):
        want = "(N,)" if n is None else f"({n},)"
        raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    if t.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} must be an integer tensor, got {t.dtype}")


def _check_lookup(tables, idx, iz):
    if tables.dim() != 3 or tables.shape[1] != 3 or tables.shape[2] == 0:
        raise ValueError(f"tables must be (M, 3, P) with P > 0, got "
                         f"{tuple(tables.shape)}")
    if not tables.dtype.is_floating_point:
        raise TypeError(f"tables must be floating, got {tables.dtype}")
    _index("idx", idx)
    extra = ()
    if iz is not None:
        if iz.shape != idx.shape or iz.dtype != tables.dtype:
            raise ValueError(f"iz must be ({idx.shape[0]},) {tables.dtype}, "
                             f"got {tuple(iz.shape)} {iz.dtype}")
        extra = (iz,)
    _same_device("merl lookup", tables, idx, *extra)


def _kernel_ready(name, tensors, ints=(), floats=()):
    """The checks every kernel entry makes before a launch."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"the {name} kernel needs CUDA tensors, got "
                         f"{tensors[0].device}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError(f"{name} kernel: indices must be int32")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(
            f"{name} kernel: tables and values must be float32, got "
            f"{sorted({str(t.dtype) for t in floats})}; a Merl table takes "
            "config.default_float(), which config.use_x64() makes float64: "
            "the card's kernels are float32 only, so under use_x64 look up "
            "on CPU tensors")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel: every tensor must be contiguous")
    if any(t.requires_grad for t in tensors):
        raise ValueError(
            f"the {name} kernel computes no gradient: call the wrapper "
            "(merl_lookup gives the card's lookup its backward through "
            "MerlLookupGrad) or detach the inputs")


def _launch(name, fn, device, *args):
    lib = _lib()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, fn)(device.index, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.djbt_gather_error_string(err).decode()} "
                           f"({err})")
    LAUNCHES[name] += 1


# -- the MERL lookup ----------------------------------------------------

def plain_merl_lookup(tables, idx, scales, iz=None, chunk=None):
    """Plain version of :func:`merl_lookup`, on any device; ``chunk``
    materials at a time (all at once by default) so that the (M, 3, N)
    intermediate of a large batch fits in memory."""
    _check_lookup(tables, idx, iz)
    m, _, p = tables.shape
    k = idx.clamp(0, p - 1).long()
    s = torch.tensor(scales, dtype=tables.dtype, device=tables.device)
    if m == 0:
        return tables.new_empty((0, idx.shape[0], 3))
    parts = []
    for a in range(0, m, chunk or m):
        rgb = tables[a:a + (chunk or m)][:, :, k].permute(0, 2, 1) * s
        below = torch.any(rgb < 0.0, dim=-1, keepdim=True)
        rgb = torch.where(below, 0.0, rgb)
        parts.append(rgb if iz is None else rgb * iz[:, None])
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def kernel_merl_lookup(tables, idx, scales, iz=None):
    """Run the lookup kernels on the path :func:`lookup_packs` chooses:
    ``(M, N, 3)`` float32. Raises on anything the kernels do not take
    (CPU or strided tensors included) and on a failed launch."""
    m, _, p = tables.shape
    return launch_merl_lookup(tables, idx, scales, iz,
                              lookup_packs(m, idx.shape[0], p))


def launch_merl_lookup(tables, idx, scales, iz, packed):
    """:func:`kernel_merl_lookup` on the packed path or the direct
    kernel, as ``packed`` says, whatever N is."""
    _check_lookup(tables, idx, iz)
    extra = () if iz is None else (iz,)
    _kernel_ready("merl_lookup", (tables, idx, *extra), ints=(idx,),
                  floats=(tables, *extra))
    m, _, p = tables.shape
    n = idx.shape[0]
    if m > _MAX_MATERIALS:
        raise ValueError(f"at most {_MAX_MATERIALS} tables per launch, got {m}")
    device = tables.device
    out = torch.empty((m, n, 3), dtype=torch.float32, device=device)
    if m == 0 or n == 0:
        return out
    s0, s1, s2 = (float(s) for s in scales)
    args = (tables.data_ptr(), idx.data_ptr(),
            None if iz is None else iz.data_ptr(), n, m, p, s0, s1, s2)
    if not packed:
        _launch("merl_lookup", "djbt_merl_lookup", device, *args,
                out.data_ptr())
        return out
    # scratch: the mark (a byte per cell) and the records of one pair
    mark = torch.empty(p, dtype=torch.uint8, device=device)
    rec = torch.empty((p, min(m, 2), 4), dtype=torch.float32, device=device)
    _launch("merl_lookup", "djbt_merl_lookup_packed", device, *args,
            mark.data_ptr(), rec.data_ptr(), out.data_ptr())
    return out


def lookup_backward(tables, idx, scales, iz, grad, lookup,
                    need_tables=True, need_iz=True):
    """The gradients of ``merl_lookup(tables, idx, scales, iz)`` w.r.t.
    ``tables`` and ``iz`` for the output gradient ``grad`` (M, N, 3), as
    ``jax.grad`` takes them through JAX's ``jnp.take``, ``where`` and
    ``* i[..., 2:3]``:

    * tables: ``grad[m, n, c] * iz[n] * scales[c]`` added into cell
      ``clip(idx[n])`` of plane ``c`` (``index_add_`` on a zeroed
      (M, 3, P)), then 0 in every cell whose scaled entries hold a
      negative one: below the horizon the lookup returns the constant 0.
      Whether a lookup is below depends only on its cell, so the cell
      mask equals the per-lookup ``where``.
    * iz: ``sum_{m, c} grad * rgb``, with ``rgb`` from ``lookup`` called
      without ``iz``.

    ``lookup`` is the forward (the kernel on the card, the plain version
    on the CPU). Returns ``(grad_tables or None, grad_iz or None)``."""
    p = tables.shape[-1]
    tables = tables.detach()
    s = torch.tensor(scales, dtype=tables.dtype, device=tables.device)
    g_tables = g_iz = None
    if need_tables:
        src = grad if iz is None else grad * iz.detach()[:, None]
        src = (src * s).permute(0, 2, 1)                     # (M, 3, N)
        g_tables = torch.zeros_like(tables).index_add_(
            2, idx.clamp(0, p - 1).long(), src)
        below = torch.any(tables * s[:, None] < 0.0, dim=1, keepdim=True)
        g_tables = g_tables.masked_fill_(below, 0.0)
    if need_iz and iz is not None:
        rgb = lookup(tables, idx, scales, None)
        g_iz = torch.sum(grad * rgb, dim=(0, 2))
    return g_tables, g_iz


class MerlLookupGrad(torch.autograd.Function):
    """:func:`merl_lookup` with a backward: the forward runs ``lookup``
    on detached inputs (the kernels refuse tensors that require grad),
    the backward is :func:`lookup_backward`. ``iz`` may be None."""

    @staticmethod
    def forward(ctx, tables, iz, idx, scales, lookup):
        ctx.save_for_backward(tables, iz, idx)
        ctx.scales, ctx.lookup = scales, lookup
        return lookup(tables.detach(), idx, scales,
                      None if iz is None else iz.detach())

    @staticmethod
    def backward(ctx, grad):
        tables, iz, idx = ctx.saved_tensors
        g_tables, g_iz = lookup_backward(
            tables, idx, ctx.scales, iz, grad.contiguous(), ctx.lookup,
            ctx.needs_input_grad[0], ctx.needs_input_grad[1])
        return g_tables, g_iz, None, None, None


def merl_lookup(tables, idx, scales, iz=None):
    """``(M, N, 3)``: ``tables[m, c, clip(idx[n])] * scales[c]``, all three
    channels 0 where any is negative, times ``iz[n]`` when given.
    ``tables`` (M, 3, P) raw MERL planes, ``idx`` (N,) flat indices
    shared by all M tables. The kernel on CUDA tensors, the plain
    version on CPU tensors.

    Differentiable w.r.t. ``tables`` and ``iz``, as ``jax.grad`` through
    JAX's ``jnp.take``: on the CPU by autograd of the plain version, on
    the card through :class:`MerlLookupGrad` whenever one of them
    requires grad. On the card the tables must be float32 (see
    :class:`~dj_brdf_torch.models.merl.Merl` for dtypes)."""
    if tables.device.type == "cpu":
        return plain_merl_lookup(tables, idx, scales, iz)
    if tables.requires_grad or (iz is not None and iz.requires_grad):
        return MerlLookupGrad.apply(tables, iz, idx, scales,
                                    kernel_merl_lookup)
    return kernel_merl_lookup(tables, idx, scales, iz)


# -- K5: one plane, flat index ----------------------------------------

def _check_plane(plane, idx):
    if plane.dim() != 1 or plane.shape[0] == 0:
        raise ValueError(f"plane must be (P,) with P > 0, got "
                         f"{tuple(plane.shape)}")
    _index("idx", idx)
    _same_device("gather_plane", plane, idx)


def plain_gather_plane(plane, idx):
    """Plain version of :func:`gather_plane`."""
    _check_plane(plane, idx)
    return plane[idx.clamp(0, plane.shape[0] - 1).long()]


def kernel_gather_plane(plane, idx):
    _check_plane(plane, idx)
    _kernel_ready("gather_plane", (plane, idx), ints=(idx,), floats=(plane,))
    n = idx.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=plane.device)
    if n:
        _launch("gather_plane", "djbt_gather_plane", plane.device,
                plane.data_ptr(), plane.shape[0], idx.data_ptr(), n,
                out.data_ptr())
    return out


def gather_plane(plane, idx):
    """``plane[clip(idx)]``: (N,) values of a (P,) plane."""
    if plane.device.type == "cpu":
        return plain_gather_plane(plane, idx)
    return kernel_gather_plane(plane, idx)


# -- K6: the padded plane, two-level index ------------------------------

def pad_plane(plane):
    """A (P,) plane zero-padded to ``(ceil(P / LANES), LANES)``, the
    layout of K6 (and of the TPU's (8, 128)-tiled VMEM)."""
    rows = -(-plane.shape[0] // LANES)
    out = plane.new_zeros(rows * LANES)
    out[:plane.shape[0]] = plane
    return out.reshape(rows, LANES)


def row_lane(idx):
    """Flat int32 indices -> (row, lane) int32 of the padded plane."""
    return ((idx // LANES).to(torch.int32).contiguous(),
            (idx % LANES).to(torch.int32).contiguous())


def _check_rowlane(plane2d, row, lane):
    if plane2d.dim() != 2 or plane2d.numel() == 0:
        raise ValueError(f"plane2d must be (rows, lanes), not empty, got "
                         f"{tuple(plane2d.shape)}")
    _index("row", row)
    _index("lane", lane, row.shape[0])
    _same_device("gather_rowlane", plane2d, row, lane)


def plain_gather_rowlane(plane2d, row, lane):
    """Plain version of :func:`gather_rowlane`."""
    _check_rowlane(plane2d, row, lane)
    rows, lanes = plane2d.shape
    return plane2d[row.clamp(0, rows - 1).long(),
                   lane.clamp(0, lanes - 1).long()]


def kernel_gather_rowlane(plane2d, row, lane):
    _check_rowlane(plane2d, row, lane)
    _kernel_ready("gather_rowlane", (plane2d, row, lane), ints=(row, lane),
                  floats=(plane2d,))
    n = row.shape[0]
    out = torch.empty(n, dtype=torch.float32, device=plane2d.device)
    if n:
        rows, lanes = plane2d.shape
        _launch("gather_rowlane", "djbt_gather_rowlane", plane2d.device,
                plane2d.data_ptr(), rows, lanes, row.data_ptr(),
                lane.data_ptr(), n, out.data_ptr())
    return out


def gather_rowlane(plane2d, row, lane):
    """``plane2d[clip(row), clip(lane)]``: (N,) values."""
    if plane2d.device.type == "cpu":
        return plain_gather_rowlane(plane2d, row, lane)
    return kernel_gather_rowlane(plane2d, row, lane)
