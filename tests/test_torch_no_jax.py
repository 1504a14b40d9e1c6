"""The PyTorch port must not need JAX: importing it pulls in no jax module,
and no source of it, nor the GPU smoke script, imports jax."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dj_brdf_torch"
SLICE_MODULES = [
    "dj_brdf_torch", "dj_brdf_torch.config", "dj_brdf_torch.core",
    "dj_brdf_torch.core.pytree", "dj_brdf_torch.core.math",
    "dj_brdf_torch.core.special", "dj_brdf_torch.core.spline",
    "dj_brdf_torch.fresnel", "dj_brdf_torch.microfacet",
    "dj_brdf_torch.microfacet.params", "dj_brdf_torch.microfacet.ndf",
    "dj_brdf_torch.microfacet.brdf", "dj_brdf_torch.ops",
    "dj_brdf_torch.ops.soa", "dj_brdf_torch.ops._build",
    "dj_brdf_torch.ops.fused_fit", "dj_brdf_torch.fit",
    "dj_brdf_torch.fit.lsq", "dj_brdf_torch.fit.batch",
    "dj_brdf_torch.convert",
    # slice 2: measured data and tabulation
    "dj_brdf_torch.io", "dj_brdf_torch.io.merl_io", "dj_brdf_torch.io.synth",
    "dj_brdf_torch.models", "dj_brdf_torch.models.merl",
    "dj_brdf_torch.models.lambert", "dj_brdf_torch.ops.merl_gather",
    "dj_brdf_torch.fit.tabular", "dj_brdf_torch.fit.moments",
    "dj_brdf_torch.cli", "dj_brdf_torch.cli.merl_params",
    # slice 3: the autodiff fit kernel's wrapper lives in ops.fused_fit;
    # rendering
    "dj_brdf_torch.render", "dj_brdf_torch.render.sphere",
    "dj_brdf_torch.render.materials", "dj_brdf_torch.render.pathtrace",
    "dj_brdf_torch.entry",
]


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'dj_brdf_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_port_source_does_not_import_jax(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|jaxlib|optax|dj_brdf_tpu)\b",
                         src, re.MULTILINE), path


def test_every_slice_module_is_checked():
    found = {".".join(p.relative_to(ROOT).with_suffix("").parts)
             .removesuffix(".__init__") for p in PKG.rglob("*.py")}
    assert found == set(SLICE_MODULES)
