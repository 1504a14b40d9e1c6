"""The MERL gather kernels' wrappers and plain versions
(dj_brdf_torch.ops.merl_gather), without JAX.

On the CPU these check the plain versions against a numpy reference,
the dispatch, the launch counts and the checks each wrapper makes
before a launch. The tests that need a CUDA device skip here; on a GPU
machine (which need not have JAX) run them with

    python -m pytest --noconftest -q tests/test_torch_gather_kernel.py
"""

import numpy as np
import pytest
import torch

from dj_brdf_torch.models import merl as tm
from dj_brdf_torch.ops import _build
from dj_brdf_torch.ops import merl_gather as mg

SCALES = tm.SCALES

# The condition is a string, so pytest evaluates it when each test is set
# up, not while the module is imported.
needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the gather kernels run only on the GPU")
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def lookup_inputs(m, n, p=1000, seed=0, device="cpu"):
    """Tables (m, 3, p) with ~10% negative (below-horizon) entries,
    indices (n,) with a few out of range on both sides, and iz (n,)."""
    rng = np.random.default_rng(seed)
    tables = rng.uniform(0.0, 2000.0, (m, 3, p))
    tables[rng.uniform(size=(m, 3, p)) < 0.1] = -1.0
    idx = rng.integers(-5, p + 5, n)
    iz = rng.uniform(-0.1, 1.0, n)
    return (torch.tensor(tables, dtype=torch.float32, device=device),
            torch.tensor(idx, dtype=torch.int32, device=device),
            torch.tensor(iz, dtype=torch.float32, device=device))


def numpy_lookup(tables, idx, iz=None):
    """The lookup, one sample at a time, in float32."""
    tables = tables.numpy()
    m, _, p = tables.shape
    s = np.asarray(SCALES, np.float32)
    out = np.zeros((m, idx.shape[0], 3), np.float32)
    for k in range(m):
        for j, i in enumerate(idx.numpy()):
            rgb = tables[k, :, min(max(int(i), 0), p - 1)] * s
            if (rgb < 0).any():
                rgb = np.zeros(3, np.float32)
            if iz is not None:
                rgb = rgb * iz.numpy()[j]
            out[k, j] = rgb
    return out


@pytest.mark.parametrize("with_iz", [False, True], ids=["eval", "evalp"])
def test_plain_lookup_matches_numpy_loop(with_iz):
    tables, idx, iz = lookup_inputs(3, 400)
    iz = iz if with_iz else None
    got = mg.plain_merl_lookup(tables, idx, SCALES, iz)
    assert got.shape == (3, 400, 3) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), numpy_lookup(tables, idx, iz))
    # chunks of materials give the same bits
    assert torch.equal(mg.plain_merl_lookup(tables, idx, SCALES, iz,
                                            chunk=2), got)


def test_plain_gathers_match_numpy():
    rng = np.random.default_rng(1)
    plane = torch.tensor(rng.uniform(size=1000), dtype=torch.float32)
    idx = torch.tensor(rng.integers(-3, 1003, 5000), dtype=torch.int32)
    want = plane.numpy()[np.clip(idx.numpy(), 0, 999)]
    np.testing.assert_array_equal(mg.plain_gather_plane(plane, idx).numpy(),
                                  want)
    plane2d = mg.pad_plane(plane)
    assert plane2d.shape == (8, mg.LANES)
    assert torch.equal(plane2d.reshape(-1)[:1000], plane)
    assert torch.count_nonzero(plane2d.reshape(-1)[1000:]) == 0
    row, lane = mg.row_lane(idx.clamp(0, 999))
    assert row.dtype == lane.dtype == torch.int32
    np.testing.assert_array_equal(
        mg.plain_gather_rowlane(plane2d, row, lane).numpy(), want)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    tables, idx, iz = lookup_inputs(2, 300)
    plane = tables[0, 0].contiguous()
    plane2d = mg.pad_plane(plane)
    row, lane = mg.row_lane(idx.clamp(0, 999))
    before = dict(mg.LAUNCHES)
    assert torch.equal(mg.merl_lookup(tables, idx, SCALES, iz),
                       mg.plain_merl_lookup(tables, idx, SCALES, iz))
    assert torch.equal(mg.gather_plane(plane, idx),
                       mg.plain_gather_plane(plane, idx))
    assert torch.equal(mg.gather_rowlane(plane2d, row, lane),
                       mg.plain_gather_rowlane(plane2d, row, lane))
    assert mg.LAUNCHES == before


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    tables, idx, iz = lookup_inputs(2, 300)
    plane = tables[0, 0].contiguous()
    row, lane = mg.row_lane(idx.clamp(0, 999))
    before = dict(mg.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        mg.kernel_merl_lookup(tables, idx, SCALES, iz)   # no CPU fallback
    with pytest.raises(ValueError, match="CUDA"):
        mg.kernel_gather_plane(plane, idx)
    with pytest.raises(ValueError, match="CUDA"):
        mg.kernel_gather_rowlane(mg.pad_plane(plane), row, lane)
    with pytest.raises(ValueError, match="tables"):
        mg.kernel_merl_lookup(tables[:, :2], idx, SCALES)
    with pytest.raises(ValueError, match="iz"):
        mg.kernel_merl_lookup(tables, idx, SCALES, iz[:-1])
    with pytest.raises(TypeError, match="integer"):
        mg.kernel_merl_lookup(tables, idx.float(), SCALES)
    with pytest.raises(ValueError, match="plane"):
        mg.kernel_gather_plane(tables[0], idx)
    with pytest.raises(ValueError, match="lane"):
        mg.kernel_gather_rowlane(mg.pad_plane(plane), row, lane[:-1])
    assert mg.LAUNCHES == before


@pytest.mark.parametrize("m, n, packed", [
    (100, 1_458_000, True),     # merl_targets at MERL scale
    (100, 600_000, True),
    (100, 520_000, True),       # just above N = 0.356 P
    (100, 519_000, False),      # just below
    (100, 364_500, False),      # N = P / 4
    (100, 91_125, False),       # N = P / 16
    (100, 8_100, False),        # tabulation-sized
    (1, 65_536, False),         # the path tracer's measured material
    (1, 1_458_000, True),       # one table: G = 1
    (1, 660_000, False),        # below G = 1's N = 0.453 P
    (3, 1_458_000, True),       # an odd M: the last table alone
    (5, 800_000, True),
])
def test_lookup_plan_packs_where_it_reads_fewer_sectors(m, n, packed):
    assert mg.lookup_packs(m, n, tm.PLANE) is packed
    # the rule, in sectors per table: 3 per direct lookup against 1 / G per
    # packed lookup plus the pack's at most 3/8 + 1/2 + 1/(32 G) per cell,
    # with G = 2 tables to a record (1 for a single table)
    g = min(2, m)
    pack = n / g + tm.PLANE * (3 / 8 + 1 / 2 + 1 / (32 * g))
    assert packed == (pack < 3 * n)


def emulate_packed_lookup(tables, idx, scales, iz):
    """The packed path in torch ops, step for step as the kernels run it:
    mark the touched cells, pack each pair's marked cells (the last table
    of an odd M alone) into records of (r s0, g s1, b s2, unused), 0 where
    any is negative, then look each index up in its pair's records and
    multiply by iz."""
    m, _, p = tables.shape
    k = idx.long().clamp(0, p - 1)
    mark = torch.zeros(p, dtype=torch.bool)
    mark[k] = True
    s = torch.tensor(scales, dtype=torch.float32)
    out = torch.empty((m, idx.shape[0], 3))
    for m0 in range(0, m, 2):
        g = min(2, m - m0)
        rec = torch.full((p, g, 4), float("nan"))     # unmarked: never read
        cells = mark.nonzero()[:, 0]
        rgb = tables[m0:m0 + g][:, :, cells].permute(2, 0, 1) * s
        rgb = torch.where((rgb < 0.0).any(-1, keepdim=True), 0.0, rgb)
        rec[cells, :, :3] = rgb
        got = rec[k][:, :, :3].permute(1, 0, 2)       # (g, N, 3)
        out[m0:m0 + g] = got if iz is None else got * iz[:, None]
    return out


@pytest.mark.parametrize("with_iz", [False, True], ids=["eval", "evalp"])
@pytest.mark.parametrize("m", [1, 2, 5])
def test_packed_lookup_emulation_matches_plain_bit_for_bit(m, with_iz):
    tables, idx, iz = lookup_inputs(m, 3001, seed=11 + m)
    iz = iz if with_iz else None
    got = emulate_packed_lookup(tables, idx, SCALES, iz)
    want = mg.plain_merl_lookup(tables, idx, SCALES, iz)
    assert not torch.isnan(got).any()
    assert torch.equal(got, want)


def test_build_names_the_gather_library_by_source():
    path = _build.library_path("merl_gather")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdjbt_merl_gather_")
    assert (_build.CSRC / "merl_gather.cu").exists()


def gather_inputs(n, length, gen, device, offset=1):
    """A plane of ``length`` entries, flat indices (n,) and row/lane
    pairs (n,) into its padded form, out of range on every side, each
    read from ``offset`` entries into a larger tensor (offset 1: not
    16-B aligned)."""
    plane = torch.rand(length, generator=gen, device=device)
    rows = -(-length // mg.LANES)
    idx = torch.randint(-length - 3, 2 * length + 3, (n + offset,),
                        generator=gen, device=device, dtype=torch.int32)
    row = torch.randint(-2, rows + 2, (n + offset,), generator=gen,
                        device=device, dtype=torch.int32)
    lane = torch.randint(-3, mg.LANES + 3, (n + 2 * offset,), generator=gen,
                         device=device, dtype=torch.int32)
    return (plane, idx[offset:], row[offset:], lane[2 * offset:])


@pytest.mark.parametrize("n", [1, 3, 255, 257])
def test_plain_gathers_clip_each_coordinate(n):
    """The plain versions the kernels are held to, at the GPU test's
    ragged n: every index clipped into the plane, row and lane each into
    their own range."""
    gen = torch.Generator().manual_seed(n)
    plane, idx, row, lane = gather_inputs(n, 1000, gen, "cpu")
    want = plane.numpy()[np.clip(idx.numpy(), 0, 999)]
    np.testing.assert_array_equal(mg.plain_gather_plane(plane, idx).numpy(),
                                  want)
    plane2d = mg.pad_plane(plane).numpy()
    want2 = plane2d[np.clip(row.numpy(), 0, plane2d.shape[0] - 1),
                    np.clip(lane.numpy(), 0, mg.LANES - 1)]
    got2 = mg.plain_gather_rowlane(mg.pad_plane(plane), row, lane)
    np.testing.assert_array_equal(got2.numpy(), want2)


@needs_cuda
@pytest.mark.parametrize("with_iz", [False, True], ids=["eval", "evalp"])
@pytest.mark.parametrize("n", [1, 255, 257, 5000])
def test_lookup_kernel_matches_plain_bit_for_bit_on_gpu(n, with_iz):
    tables, idx, iz = lookup_inputs(3, n, seed=n, device=CUDA)
    iz = iz if with_iz else None
    before = mg.LAUNCHES["merl_lookup"]
    got = mg.kernel_merl_lookup(tables, idx, SCALES, iz)
    torch.cuda.synchronize()
    assert mg.LAUNCHES["merl_lookup"] == before + 1
    assert torch.equal(got, mg.plain_merl_lookup(tables, idx, SCALES, iz))


@needs_cuda
@pytest.mark.parametrize("with_iz", [False, True], ids=["eval", "evalp"])
@pytest.mark.parametrize("m", [1, 2, 3, 5])
def test_packed_lookup_matches_plain_bit_for_bit_on_gpu(m, with_iz):
    """Above the crossover (N = 5003 > 0.453 P at P = 1000) the wrapper
    takes the packed path; a ragged N, clipped indices and below-horizon
    cells included."""
    n = 5003
    tables, idx, iz = lookup_inputs(m, n, seed=m, device=CUDA)
    iz = iz if with_iz else None
    assert mg.lookup_packs(m, n, 1000)
    before = mg.LAUNCHES["merl_lookup"]
    got = mg.kernel_merl_lookup(tables, idx, SCALES, iz)
    torch.cuda.synchronize()
    assert mg.LAUNCHES["merl_lookup"] == before + 1
    want = mg.plain_merl_lookup(tables, idx, SCALES, iz)
    assert torch.equal(got, want)
    # the direct kernel gives the same bits
    assert torch.equal(mg.launch_merl_lookup(tables, idx, SCALES, iz, False),
                       want)


@needs_cuda
@pytest.mark.parametrize("n", [1, 255, 257])
def test_direct_lookup_at_small_n_on_gpu(n):
    tables, idx, iz = lookup_inputs(3, n, seed=n, device=CUDA)
    assert not mg.lookup_packs(3, n, 1000)
    assert torch.equal(mg.kernel_merl_lookup(tables, idx, SCALES, iz),
                       mg.plain_merl_lookup(tables, idx, SCALES, iz))


@needs_cuda
def test_gather_kernels_match_plain_bit_for_bit_on_gpu():
    gen = torch.Generator(device=CUDA).manual_seed(3)
    plane = torch.rand(tm.PLANE, generator=gen, device=CUDA)
    idx = torch.randint(-10, tm.PLANE + 10, (100_003,), generator=gen,
                        device=CUDA, dtype=torch.int32)
    before = dict(mg.LAUNCHES)
    assert torch.equal(mg.kernel_gather_plane(plane, idx),
                       mg.plain_gather_plane(plane, idx))
    plane2d = mg.pad_plane(plane)
    row, lane = mg.row_lane(idx.clamp(0, tm.PLANE - 1))
    assert torch.equal(mg.kernel_gather_rowlane(plane2d, row, lane),
                       mg.plain_gather_rowlane(plane2d, row, lane))
    torch.cuda.synchronize()
    assert mg.LAUNCHES["gather_plane"] == before["gather_plane"] + 1
    assert mg.LAUNCHES["gather_rowlane"] == before["gather_rowlane"] + 1


@needs_cuda
@pytest.mark.parametrize("n", [1, 3, 255, 257, 2 ** 22 + 3])
@pytest.mark.parametrize("length", [1, 1000, tm.PLANE, 2 ** 24 + 1])
def test_plane_gathers_bit_for_bit_on_gpu(n, length):
    """K5 and K6 against their plain versions at ragged n, from planes
    of one entry to larger than L2: indices read from offset 1 (not 16-B
    aligned), negative and out-of-range indices on each axis, and lane at
    another offset than row."""
    gen = torch.Generator(device=CUDA).manual_seed(n + length)
    plane, idx, row, lane = gather_inputs(n, length, gen, CUDA)
    assert idx.data_ptr() % 16 != 0
    assert torch.equal(mg.kernel_gather_plane(plane, idx),
                       mg.plain_gather_plane(plane, idx))
    plane2d = mg.pad_plane(plane)
    for r, l in ((row, lane), (row.contiguous(), lane.contiguous())):
        assert torch.equal(mg.kernel_gather_rowlane(plane2d, r, l),
                           mg.plain_gather_rowlane(plane2d, r, l))


@needs_cuda
def test_lookup_kernel_refuses_strided_and_grad_tensors_on_gpu():
    tables, idx, iz = lookup_inputs(2, 100, device=CUDA)
    strided = torch.stack([idx, idx], -1)[:, 0]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        mg.kernel_merl_lookup(tables, strided, SCALES)
    with pytest.raises(TypeError, match="int32"):
        mg.kernel_merl_lookup(tables, idx.long(), SCALES)
    with pytest.raises(ValueError, match="gradient"):
        mg.kernel_merl_lookup(tables.requires_grad_(True), idx, SCALES)


@needs_cuda
@pytest.mark.parametrize("n", [3000, 200_000], ids=["direct", "packed"])
def test_lookup_backward_on_gpu_matches_cpu_autograd(n):
    """merl_lookup of CUDA tables and iz that require grad: the forward
    through the kernel (one launch), the gradients w.r.t. both against
    the CPU path's autograd, rtol 1e-5 (atomics reorder the f32 sums)."""
    tables, idx, iz = lookup_inputs(3, n, p=100_000, seed=4)
    g = torch.rand((3, n, 3), generator=torch.Generator().manual_seed(1))
    grads = []
    for device in ("cpu", CUDA):
        t = tables.to(device).clone().requires_grad_(True)
        z = iz.to(device).clone().requires_grad_(True)
        before = mg.LAUNCHES["merl_lookup"]
        out = mg.merl_lookup(t, idx.to(device), SCALES, z)
        torch.sum(out * g.to(device)).backward()
        grads.append((out.detach().cpu(), t.grad.cpu(), z.grad.cpu()))
        if device == CUDA:
            assert mg.LAUNCHES["merl_lookup"] - before == 2  # fwd, rgb
    (o0, t0, z0), (o1, t1, z1) = grads
    assert torch.equal(o0, o1)
    torch.testing.assert_close(t1, t0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(z1, z0, rtol=1e-5, atol=1e-6)


@needs_cuda
def test_merl_targets_on_gpu_go_through_the_kernel():
    """merl_targets on CUDA tensors launches the lookup once and agrees
    bit for bit with the plain version at the same indices."""
    from dj_brdf_torch.fit.batch import merl_targets, sample_direction_set

    gen = torch.Generator(device=CUDA).manual_seed(0)
    tables = torch.rand((2, 3, 90, 90, 180), generator=gen, device=CUDA)
    i, o = sample_direction_set(4096, gen, CUDA)
    before = mg.LAUNCHES["merl_lookup"]
    got = merl_targets(tables, i, o)
    torch.cuda.synchronize()
    assert got.shape == (2, 4096, 3)
    assert mg.LAUNCHES["merl_lookup"] == before + 1
    idx = tm.merl_flat_index(i, o).reshape(-1)
    want = mg.plain_merl_lookup(tables.reshape(2, 3, -1), idx, SCALES,
                                i[:, 2].contiguous())
    assert torch.equal(got, want)


@needs_cuda
def test_tabulate_merl_batch_on_gpu_matches_cpu():
    """The tabulation on the card (lookups through the kernel) against
    the CPU path on the same tables: alphas rtol 1e-4."""
    from dj_brdf_torch.fit.batch import tabulate_merl_batch
    from dj_brdf_torch.io.synth import bake_merl

    tables = torch.stack([bake_merl(ggx_eval_fn(a, CUDA), device=CUDA).float()
                          for a in (0.15, 0.4)])
    before = mg.LAUNCHES["merl_lookup"]
    _, fres_pts, ab, ag = tabulate_merl_batch(tables, 24)
    torch.cuda.synchronize()
    assert mg.LAUNCHES["merl_lookup"] == before + 2
    _, cf, cab, cag = tabulate_merl_batch(tables.cpu(), 24)
    torch.testing.assert_close(ab.cpu(), cab, rtol=1e-4, atol=0)
    torch.testing.assert_close(ag.cpu(), cag, rtol=1e-4, atol=0)
    torch.testing.assert_close(fres_pts.cpu(), cf, rtol=1e-4, atol=1e-5)


def ggx_eval_fn(alpha, device):
    from dj_brdf_torch import fresnel
    from dj_brdf_torch.microfacet import brdf
    from dj_brdf_torch.microfacet.ndf import GGX
    from dj_brdf_torch.microfacet.params import MicrofacetParams

    f0 = torch.tensor([0.9, 0.6, 0.3], device=device)
    params = MicrofacetParams.isotropic(torch.tensor(alpha, device=device))
    return lambda i, o: brdf.eval(GGX(), fresnel.Schlick(f0=f0), params, i, o)


@needs_cuda
def test_float64_bake_goes_through_targets_and_fit_on_gpu():
    """bake -> merl_targets -> fit_materials on the card with no cast: a
    float64 stack gives float32 targets, bit for bit those of the stack
    cast by hand, and the fit runs through the fused kernel."""
    from dj_brdf_torch.fit.batch import (fit_materials, merl_targets,
                                         sample_direction_set)
    from dj_brdf_torch.io.synth import bake_merl

    tables = torch.stack([bake_merl(ggx_eval_fn(a, CUDA), device=CUDA)
                          for a in (0.2, 0.4)])
    assert tables.dtype == torch.float64
    gen = torch.Generator(device=CUDA).manual_seed(1)
    i, o = sample_direction_set(4096, gen, CUDA)
    before = mg.LAUNCHES["merl_lookup"]
    targets = merl_targets(tables, i, o)
    assert targets.dtype == torch.float32
    assert mg.LAUNCHES["merl_lookup"] == before + 1
    assert torch.equal(targets, merl_targets(tables.float(), i, o))
    params, fres, losses = fit_materials(targets, i, o, steps=20)
    torch.cuda.synchronize()
    assert losses.dtype == torch.float32 and torch.isfinite(losses).all()
    assert torch.isfinite(params.ax).all() and torch.isfinite(fres.f0).all()


@needs_cuda
def test_use_x64_on_the_card_raises_naming_it():
    """Under config.use_x64() a Merl table is float64, which the card's
    float32 lookup does not take: a TypeError that names use_x64, never a
    silent cast."""
    from dj_brdf_torch import config
    from dj_brdf_torch.fit.batch import sample_direction_set

    gen = torch.Generator(device=CUDA).manual_seed(2)
    table = torch.rand((3, 90, 90, 180), generator=gen, device=CUDA)
    i, o = sample_direction_set(256, gen, CUDA)
    config.use_x64(True)
    try:
        model = tm.Merl(table=table)
        assert model.table.dtype == torch.float64
        with pytest.raises(TypeError, match="use_x64"):
            model.eval(i, o)
    finally:
        config.use_x64(False)
