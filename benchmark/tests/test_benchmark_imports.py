"""What the benchmark may import: the reference nothing of the program
and nothing of JAX; no file of the benchmark JAX or the JAX package;
and a run's process holds none of them. Names are compared whole, by
their top-level part (``dj_brdf_torch`` is not ``dj_brdf_tpu``)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from conftest import ROOT

JAX = {"jax", "jaxlib", "flax", "dj_brdf_tpu"}
BENCH = ROOT / "benchmark"


def imported(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_neither_program_nor_jax(path):
    assert not imported(path) & (JAX | {"dj_brdf_torch"})


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_benchmark_file_imports_jax(path):
    assert not imported(path) & JAX


def test_a_run_holds_no_jax_module():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); "
            "import conftest, benchmark.run; "
            "from benchmark import harness; "
            "[conftest.run_tiny(n) for n in sorted(conftest.TINY)]; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_harness_sees_a_forbidden_module(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "dj_brdf_tpu.fit", object())
    assert harness.forbidden_modules() == ["dj_brdf_tpu"]
