"""The controls come out not correct: the plain reference's profile in
bfloat16 put in the program's place, the program with its polish switched
off, and on a multicast platform the program's replica replay and the
program run as unicast."""
from __future__ import annotations

import json

import control
import harness


def test_bf16_control_fails_the_profile(tiny):
    out = control.readings(tiny("edge_5120-16x16.map"), 2**31 + 21, 1,
                           ["bf16"], "cpu")
    limits = tiny("edge_5120-16x16.map").cell["limits"]
    assert all(v <= limits[k] for k, v in out["program"].items())
    assert out["bf16"]["trace_diff"] > limits["trace_diff"]


def test_nopolish_control_fails_swap_gain(tiny):
    spec = tiny("edge_5120-16x16.map")
    # At 25 partitions the full search already ends at a swap-local
    # optimum; one epoch of it does not, and the polish is what fixes that.
    spec.mix = {**spec.mix, "toolchain": {**spec.mix["toolchain"],
                                          "mapper_kwargs": {"iters": 64}}}
    out = control.readings(spec, 2**31 + 22, 1, ["nopolish"], "cpu")
    assert out["program"]["swap_gain"] <= spec.cell["limits"]["swap_gain"]
    assert out["nopolish"]["swap_gain"] > spec.cell["limits"]["swap_gain"]


def test_linkcap_control_is_held_to_the_stated_capacity(tiny):
    spec = tiny("edge_5120-16x16.replay")
    cap = spec.config["platform"]["link_capacity"]
    cell = harness.Cell(spec, 2**31 + 23, "cpu",
                        toolchain_overrides={"link_capacity": cap + 1})
    rec = cell.job(1)
    assert cell.toolchain.link_capacity == cap + 1
    assert rec["answers"][0]["platform"]["link_capacity"] == cap


def test_multicast_controls_fail(volume):
    spec = volume()
    limits = spec.cell["limits"]
    out = control.readings(spec, 2**31 + 24, 1, ["replica", "unicast",
                                                 "linkcap"], "cpu")
    assert all(v <= limits[k] for k, v in out["program"].items())
    assert out["replica"]["noc_gap"] > limits["noc_gap"]
    assert out["linkcap"]["noc_gap"] > limits["noc_gap"]
    assert out["unicast"]["hop_gap"] > limits["hop_gap"]
    assert out["unicast"]["noc_gap"] > limits["noc_gap"]


def test_control_reads_a_cell_from_files(tmp_path, volume):
    spec = volume("edge_5120-16x16.map")
    paths = []
    for name, data in (("volume_cfg", spec.config), ("volume", spec.mix),
                       ("cell", spec.cell)):
        paths.append(tmp_path / f"{name}.json")
        paths[-1].write_text(json.dumps(data))
    got = harness.spec_from_files(*paths)
    assert (got.config, got.mix, got.cell) == (spec.config, spec.mix,
                                               spec.cell)
    assert got.workload == "volume_cfg.volume"
