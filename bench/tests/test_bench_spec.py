"""BENCHMARK.json and the files it names."""
from __future__ import annotations

import json
import re

import pytest

import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (harness.ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_workload_finds_its_files(w):
    spec = harness.load_spec(w)
    assert spec.config["name"] in w
    assert "toolchain" in spec.mix
    assert spec.cell["quality_jobs"] >= 1
    assert set(spec.cell["limits"]) >= {"trace_diff", "cut_gap", "swap_gain"}
    assert spec.chips == 1
    for m in spec.end_to_end + spec.per_layer:
        reader = harness.load_reader(m["name"])
        assert callable(reader.read)
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s", "job_s"}
    assert spec.per_layer


def test_names_units_and_moves():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert (harness.ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        harness.load_spec("no-such-cell")


def test_configs_are_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench/")
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] == c["name"]
