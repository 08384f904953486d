"""The controls come out not correct: the plain reference's profile in
bfloat16 put in the program's place, and the program with its polish
switched off."""
from __future__ import annotations

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
