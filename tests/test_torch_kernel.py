"""The fused fit kernel's wrapper and build (dj_brdf_torch.ops.fused_fit,
ops._build), without JAX.

On the CPU these check the dispatch, the launch count and the checks
the wrapper makes before a launch. The tests that need a CUDA device
skip here; on a GPU machine (which need not have JAX) run them with

    python -m pytest --noconftest -q tests/test_torch_kernel.py
"""

import numpy as np
import pytest
import torch

from dj_brdf_torch.ops import _build
from dj_brdf_torch.ops import fused_fit as ff
from dj_brdf_torch.ops import soa

FAMILIES = ["ggx", "beck"]
EVALP = {"ggx": soa.ggx_evalp_soa, "beck": soa.beckmann_evalp_soa}


# The condition is a string, so pytest evaluates it when each test is set
# up, not while the module is imported.
needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs a CUDA device: the fused fit kernel runs only on the GPU")
CUDA = torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def inputs(n, m, family, seed=0, device="cpu"):
    """pvecs (m, 8), six (n,) directions and three contiguous (m, n)
    target planes from m truth materials."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0.02, 1.55, (2, n))
    ph = rng.uniform(0, 2 * np.pi, (2, n))
    dirs = [np.sin(th[0]) * np.cos(ph[0]), np.sin(th[0]) * np.sin(ph[0]),
            np.cos(th[0]), np.sin(th[1]) * np.cos(ph[1]),
            np.sin(th[1]) * np.sin(ph[1]), np.cos(th[1])]
    dirs = [torch.tensor(d, dtype=torch.float32, device=device) for d in dirs]
    lo = np.asarray([0.1, 0.1, -0.3, -0.1, -0.1, 0.05, 0.05, 0.05])
    hi = np.asarray([0.7, 0.7, 0.3, 0.1, 0.1, 0.95, 0.95, 0.95])
    truth, pvecs = (torch.tensor(lo + (hi - lo) * rng.uniform(size=(m, 8)),
                                 dtype=torch.float32, device=device)
                    for _ in range(2))
    planes = [EVALP[family](truth[k], *dirs) for k in range(m)]
    tgts = [torch.stack(ch).contiguous() for ch in zip(*planes)]
    return pvecs, dirs, tgts


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    pv, dirs, tgts = inputs(512, 2, "beck")
    before = ff.LAUNCHES
    loss, grad = ff.ggx_lsq_value_and_grad_batched(pv, *dirs, *tgts,
                                                   family="beck")
    want_l, want_g = ff.plain_fwdbwd_sums(pv, dirs, tgts, "beck")
    assert torch.equal(loss, want_l / 512) and torch.equal(grad, want_g / 512)
    assert ff.LAUNCHES == before


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    pv, dirs, tgts = inputs(512, 2, "ggx")
    before = ff.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        ff.kernel_fwdbwd_sums(pv, dirs, tgts)       # no CPU fallback
    with pytest.raises(ValueError, match="family"):
        ff.kernel_fwdbwd_sums(pv, dirs, tgts, "ggx2")
    with pytest.raises(TypeError, match="float32"):
        ff.kernel_fwdbwd_sums(pv.double(), dirs, tgts)
    with pytest.raises(ValueError, match="targets"):
        ff.kernel_fwdbwd_sums(pv, dirs, [c[:, :-1] for c in tgts])
    with pytest.raises(ValueError, match="pvecs"):
        ff.kernel_fwdbwd_sums(pv[:, :7], dirs, tgts)
    with pytest.raises(ValueError, match="directions"):
        ff.kernel_fwdbwd_sums(pv, dirs[:5] + [dirs[5][:-1]], tgts)
    assert ff.LAUNCHES == before


SCHEDULE_M = [1, 3, 17, 100]
SCHEDULE_N = [1, 1023, 1025, 1_458_000]


@pytest.mark.parametrize("m", SCHEDULE_M)
@pytest.mark.parametrize("n", SCHEDULE_N)
def test_launch_schedule_covers_every_unit_once(m, n):
    """The persistent launch on an H100's 132 SMs: the grid fills the card
    once and no more CTAs than units; the CTAs' contiguous slices of the
    (tile, material) units cover each unit once and differ by at most
    one; the running sums go to shared memory; the epilogue groups cover
    the grid, with a ticket each and one for the last level."""
    tile, sms = 1024, 132
    sched = ff.launch_schedule(n, m, tile, sms, 2, 2)
    assert sched.ntiles == -(-n // tile) and sched.ntiles * tile >= n
    assert sched.acc_in_smem and sched.ctas_per_sm == 2
    work = sched.ntiles * m
    assert 1 <= sched.grid == min(sms * 2, work)
    bounds = [work * g // sched.grid for g in range(sched.grid + 1)]
    sizes = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == work
    assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
    assert sched.group * sched.groups >= sched.grid
    assert (sched.groups - 1) * sched.group < sched.grid
    assert sched.group <= int(np.ceil(np.sqrt(sched.grid)))


@pytest.mark.parametrize("m", SCHEDULE_M)
def test_launch_schedule_keeps_the_sums_in_global_memory_if_they_cost_a_cta(
        m):
    # room for the running sums at 2 CTAs per SM only below M = 17
    sched = ff.launch_schedule(1000, m, 1024, 132, 2, 2 if m < 17 else 1)
    assert sched.acc_in_smem == (m < 17) and sched.ctas_per_sm == 2
    assert ff.launch_schedule(1000, m, 1024, 132, 2, 0).acc_in_smem is False


def test_launch_schedule_raises_when_no_cta_fits():
    with pytest.raises(RuntimeError, match="fits"):
        ff.launch_schedule(4096, 1, 1024, 132, 0, 0)


def test_launch_schedule_refuses_more_units_than_an_int_holds():
    with pytest.raises(ValueError, match="units"):
        ff.launch_schedule(2**31, 1024, 1024, 132, 2, 2)


def test_build_names_library_by_source_and_fails_loudly(tmp_path,
                                                        monkeypatch):
    path = _build.library_path("fused_fit")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdjbt_fused_fit_")
    assert _build.BUILD_DIR.parts[-2:] == ("build", "dj_brdf_torch")
    # without a CUDA toolkit the build raises; it never falls back
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "no-nvcc"))
    with pytest.raises((RuntimeError, OSError)):
        _build.build("fused_fit")


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [1, 1023, 1025, 5000])
def test_kernel_matches_plain_on_gpu(family, n):
    """Ragged tails (n not a multiple of the 1024-sample tile) included."""
    pv, dirs, tgts = inputs(n, 3, family, seed=n, device=CUDA)
    before = ff.LAUNCHES
    lk, gk = ff.kernel_fwdbwd_sums(pv, dirs, tgts, family)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == before + 1
    lp, gp = ff.plain_fwdbwd_sums(pv, dirs, tgts, family)
    # approximate reciprocals + another summation order: the JAX
    # package's own kernel-test tolerances
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-30)
    torch.testing.assert_close(
        gk, gp, rtol=3e-4, atol=1e-5 * float(gp.abs().max()))


def check_kernel(pv, dirs, tgts, family):
    """One launch against the plain version at the JAX package's kernel
    tolerances, and a second launch equal to it bit for bit."""
    before = ff.LAUNCHES
    lk, gk = ff.kernel_fwdbwd_sums(pv, dirs, tgts, family)
    lk2, gk2 = ff.kernel_fwdbwd_sums(pv, dirs, tgts, family)
    torch.cuda.synchronize()
    assert ff.LAUNCHES == before + 2
    assert torch.equal(lk, lk2) and torch.equal(gk, gk2)
    lp, gp = ff.plain_fwdbwd_sums(pv, dirs, tgts, family)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-30)
    atol = 1e-5 * gp.abs().amax(dim=1, keepdim=True)
    assert bool(((gk - gp).abs() <= atol + 3e-4 * gp.abs()).all())


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("n", [4097, 4098, 4099])
def test_kernel_unaligned_rows_on_gpu(family, n):
    """M = 3 with N % 4 in {1, 2, 3}: rows k*N after the first are not
    16-B aligned and take the 4-B copies."""
    check_kernel(*inputs(n, 3, family, seed=n, device=CUDA), family)


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("m", [1, 5, 17])
def test_kernel_materials_not_a_multiple_of_the_stages_on_gpu(family, m):
    check_kernel(*inputs(6000, m, family, seed=m, device=CUDA), family)


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_many_tiles_per_cta_with_a_ragged_tail_on_gpu(family):
    """Every persistent CTA walks several tiles (and slices start inside
    a tile), and the last tile is ragged."""
    tile = ff._lib().djbt_fused_fit_tile()
    sms = torch.cuda.get_device_properties(CUDA).multi_processor_count
    n = 3 * 8 * sms * tile + 77
    check_kernel(*inputs(n, 2, family, seed=1, device=CUDA), family)


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_unaligned_base_on_gpu(family):
    """Planes that start 4 B past a 16-B boundary (contiguous views into
    a larger buffer): every row takes the 4-B copies."""
    pv, dirs, tgts = inputs(5000, 3, family, seed=11, device=CUDA)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=CUDA)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    dirs, tgts = [shifted(d) for d in dirs], [shifted(t) for t in tgts]
    assert all(t.is_contiguous() and t.data_ptr() % 16 == 4
               for t in (*dirs, *tgts))
    check_kernel(pv, dirs, tgts, family)


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_sums_in_global_memory_on_gpu(family):
    """So many materials that their running sums would cost a resident
    CTA: the CTAs keep them in their rows of partials."""
    pv, dirs, tgts = inputs(1500, 600, family, seed=5, device=CUDA)
    assert not ff.schedule_for(pv.device, 1500, 600, family).acc_in_smem
    check_kernel(pv, dirs, tgts, family)


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_ragged_tail_adds_exactly_nothing_on_gpu(family):
    """The kernel computes the samples past the end of a ragged last tile
    too, as i = (0, 0, 1), o = -i with zero targets: the same launch with
    the tail filled so by hand gives the same sums bit for bit."""
    n, full = 1025, 2048                  # two tiles either way
    pv, dirs, tgts = inputs(n, 3, family, seed=2, device=CUDA)
    fill = [0.0, 0.0, 1.0, 0.0, 0.0, -1.0]
    pdirs = [torch.cat([d, torch.full((full - n,), f, device=CUDA)])
             for d, f in zip(dirs, fill)]
    ptgts = [torch.cat([t, torch.zeros((3, full - n), device=CUDA)], 1)
             for t in tgts]
    assert (ff.schedule_for(pv.device, n, 3, family)
            == ff.schedule_for(pv.device, full, 3, family))
    lk, gk = ff.kernel_fwdbwd_sums(pv, dirs, tgts, family)
    lf, gf = ff.kernel_fwdbwd_sums(pv, pdirs, ptgts, family)
    assert torch.equal(lk, lf) and torch.equal(gk, gf)


@needs_cuda
def test_kernel_one_sample_on_gpu():
    check_kernel(*inputs(1, 1, "ggx", seed=3, device=CUDA), "ggx")


@needs_cuda
@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_gated_samples_exactly_zero_on_gpu(family):
    n = 2000
    pv, (ix, iy, iz, ox, oy, oz), _ = inputs(n, 2, family, device=CUDA)
    below = torch.arange(n, device=CUDA) % 2 == 0
    oz = torch.where(below, -oz, oz)
    ix, iy, iz = (torch.where(below, a, -b) for a, b in
                  ((ix, ox), (iy, oy), (iz, oz)))
    z = torch.zeros((2, n), device=CUDA)
    loss, grad = ff.kernel_fwdbwd_sums(pv, (ix, iy, iz, ox, oy, oz),
                                       (z, z, z), family)
    assert torch.count_nonzero(loss) == 0 and torch.count_nonzero(grad) == 0


@needs_cuda
def test_kernel_refuses_strided_targets_on_gpu():
    pv, dirs, tgts = inputs(1000, 2, "ggx", device=CUDA)
    strided = torch.stack([tgts[0], tgts[0]], -1)[..., 0]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        ff.kernel_fwdbwd_sums(pv, dirs, [strided, tgts[1], tgts[2]])


@needs_cuda
def test_fused_fit_loss_backward_on_gpu():
    pv, dirs, tgts = inputs(3000, 3, "ggx", device=CUDA)
    pv.requires_grad_(True)
    per_mat = ff.fused_fit_loss(pv, *dirs, *tgts)
    per_mat.mean().backward()
    lp, gp = ff.plain_fwdbwd_sums(pv.detach(), dirs, tgts)
    torch.testing.assert_close(per_mat.detach(), lp / 3000, rtol=1e-4,
                               atol=1e-30)
    torch.testing.assert_close(pv.grad, gp / 9000, rtol=3e-4,
                               atol=1e-5 * float(gp.abs().max()) / 9000)
