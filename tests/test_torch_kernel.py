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
