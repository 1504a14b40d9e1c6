"""Column-sharded power iteration for the anisotropic kernel matrix.

The reference's anisotropic NDF extraction multiplies a dense
(w*h)^2 matrix (8010^2 ~ 64 M entries at the 90x90 production
resolution) four times from an all-ones start (dj_brdf.h:2525-2579,
2467-2480). Here each rank builds only its own block of kernel columns
(never more than ``n_pad / D`` of them), multiplies the full iterate by
it, and the next iterate is reassembled with an all-gather.

Counterpart of ``dj_brdf_tpu/parallel/power.py``: its ``shard_map`` over
the mesh becomes one block per rank of a ``torch.distributed`` group
(:mod:`dj_brdf_torch.parallel.mesh`). The per-row and per-column factors
are :mod:`dj_brdf_torch.fit.tabular_aniso`'s.
"""

from __future__ import annotations

import torch

from dj_brdf_torch.parallel.mesh import Mesh


def aniso_p22_sharded(brdf, elevation_res: int, azimuthal_res: int,
                      mesh: Mesh, iterations: int = 4) -> torch.Tensor:
    """Power-iterate the anisotropic kernel with column blocks built per
    rank, in float32 (as the JAX package's sharded stage runs).
    ``brdf`` is a model with ``.eval`` (its tables set the device) or a
    bare eval function, which runs on the mesh's device. Returns the raw
    (azimuthal_res, elevation_res) p22 table (before normalization) on
    every rank.

    The matvec orientation is the reference's: ``matrix::transform``
    computes out[col] = sum_row K(row, col) v[row], so each rank owns a
    block of output entries (columns of K) and reads the full v
    (dj_brdf.h:2456-2465). Padded columns have ``kji_tmp1 = 0``: their
    kernel columns, and so their output entries, are zero and are cut
    from the gathered iterate before the next matvec."""
    from dj_brdf_torch.fit import tabular_aniso as ta
    from dj_brdf_torch.fit.tabular import _device, as_model_eval

    eval_fn, model = as_model_eval(brdf)
    dev = _device(model, mesh.device)
    w = elevation_res - 1
    n = w * azimuthal_res
    dtype = torch.float32
    cols = ta.col_terms(eval_fn, model, elevation_res, azimuthal_res,
                        dtype, dev)
    cols = tuple(mesh.shard(c, pad="zero") for c in cols)
    block = ta.kernel_block(
        ta.row_terms(elevation_res, azimuthal_res, dtype, dev), *cols)
    v = torch.ones(n, dtype=dtype, device=dev)
    for _ in range(iterations):
        v = mesh.all_gather(block @ v, n=n)       # (n,) on every rank
    del block
    return ta._table(v, azimuthal_res, w)
