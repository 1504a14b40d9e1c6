"""Shared set-up of the benchmark's tests: the repository's root on the
path, and each cell resolved at a size a CPU test run can hold."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SEED = 2**31 + 4321
#: per cell, the sizes of a CPU run: (configuration, traffic) overrides
TINY = {
    "merl100.fit": ({"materials": 2, "directions": 4096},
                    {"steps": 60, "check": {"jobs": 2, "materials": 2,
                                            "target_entries": 2048}}),
    "merl100.tabulate": ({"materials": 2}, {}),
    "preview512.frame": ({"res": 16, "spp": 4}, {}),
    "preview512.envmap": ({"res": 16, "spp": 4,
                           "envmap": {"height": 16, "width": 32,
                                      "filter": "nearest"}}, {}),
}


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(name: str):
    cell = harness.resolve(spec(), name, ROOT)
    cfg, tr = TINY[name]
    cell.config.update(cfg)
    cell.traffic.update(tr)
    return cell


def run_tiny(name: str, control: bool = False, seconds: float = 0.3,
             trace: bool = False, seed: int = SEED):
    cell = tiny_cell(name)
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), control=control,
                            log=lambda msg: None)


@pytest.fixture
def cuda_device():
    """The card; the test skips where there is none (decided when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
