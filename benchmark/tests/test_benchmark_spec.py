"""BENCHMARK.json against the contract it is written to: every name
resolves to its file, names and units hold only the allowed
characters, and every cell reports what it must."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import trace
from conftest import ROOT, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
SPEC = spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys_and_paths():
    assert set(SPEC) == KEYS
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(isinstance(w, str) and not w.startswith("/") and ".." not in w
               for w in SPEC["command"])
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(conf["name"])
    path = ROOT / conf["file"]
    assert conf["file"].startswith("benchmark/") and path.is_file()
    assert json.loads(path.read_text())["name"] == conf["name"]
    assert (ROOT / "benchmark" / "reference" / f"{conf['name']}.py").is_file()
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_resolves_and_reports(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    assert (ROOT / "benchmark" / "drivers"
            / f"{traffic['driver']}.py").is_file()

    def reports(m):
        return cell["name"] in m.get("workloads", [cell["name"]])
    e2e = [m["name"] for m in SPEC["end_to_end"] if reports(m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert set(e2e) - {"setup_s"} == set(traffic["end_to_end"])
    assert any(reports(m) and m["moves"] in e2e for m in SPEC["per_layer"])
    assert traffic["limits"] and all(v > 0 for v in
                                     traffic["limits"].values())


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_and_files(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric["workloads"]) <= set(CELLS) if "workloads" in metric \
        else True
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200
        assert trace.reader_path(metric["name"]).is_file()


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
