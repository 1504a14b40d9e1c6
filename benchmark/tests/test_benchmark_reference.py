"""The plain reference against the program's CPU path, at a size a CPU
test run can hold: each cell's run, driven by the harness as on the
card, comes out correct; and the control, the reference one precision
below the configuration's in the program's place, comes out not
correct (on the card at the cell's own size: the ``chip`` tests)."""

from __future__ import annotations

import time

import pytest

from conftest import ROOT, SEED, TINY, run_tiny, spec

CELLS = sorted(TINY)


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    result = run_tiny(name)
    assert result["attempted"] >= 1
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    result = run_tiny(name, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_same(name):
    result = run_tiny(name, trace=True, seconds=5.0)
    assert result["correct"], result["checks"]
    assert result["device"]["window_s"] > 0.0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, cuda_device):
    """The control at the cell's own size on three seeds (on the card)."""
    import torch

    from benchmark import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.resolve(spec(), name, ROOT)
    for k in range(3):
        r = harness.run_cell(cell, SEED + 1000 * k, 2.0, False, cuda_device,
                             time.perf_counter(), control=True,
                             log=lambda msg: None)
        assert not r["correct"], r["checks"]
