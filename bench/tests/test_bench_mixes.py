"""A traffic mix is data alone: its ``toolchain`` block goes to the program
whole, and it names its entry and the entry's arguments."""
from __future__ import annotations

import time

import pytest

import harness


def test_toolchain_block_goes_whole(tiny):
    spec = tiny("edge_5120-16x16.map")
    spec.mix = {**spec.mix, "toolchain": {**spec.mix["toolchain"],
                                          "method": "sco", "capacity": 12,
                                          "noc_kwargs": {"inject_capacity": 3}}}
    cfg = harness._toolchain_config(spec, "cpu")
    assert (cfg.method, cfg.capacity, cfg.mesh_w) == ("sco", 12, 5)
    assert cfg.noc_kwargs == {"inject_capacity": 3}
    spec.mix["toolchain"]["no_such_knob"] = 1
    with pytest.raises(TypeError):
        harness._toolchain_config(spec, "cpu")


def test_fault_schedule_from_data():
    sched = harness._fault_schedule([{"t": 4, "kind": "link", "ids": [7]},
                                     {"t": 2, "kind": "core", "ids": [3, 5]}])
    assert sched.event_times() == [2, 4]
    assert sched.events_at(2)[0].ids == (3, 5)


def test_sweep_entry_judges_every_answer(tiny):
    spec = tiny("edge_5120-16x16.map")
    spec.mix = {**spec.mix, "entry": "run_sweep", "grid": [{}, {}, {}]}
    out = harness.run(spec, 2**31 + 41, 0.0, False, "cpu", time.perf_counter(),
                      log=lambda msg: None)
    assert out["correct"] is True and out["failed"] == 0
    cell = harness.Cell(spec, 5, "cpu")
    rec = cell.job(1)
    assert len(rec["answers"]) == 3
    assert len({a["avg_hop"] for a in rec["answers"]}) > 1  # seeds differ


def test_unknown_entry_is_refused(tiny):
    spec = tiny("edge_5120-16x16.map")
    spec.mix = {**spec.mix, "entry": "no_such_entry"}
    with pytest.raises(ValueError):
        harness.Cell(spec, 5, "cpu").job(1)


def test_the_cell_names_the_numbers_compared(tiny):
    spec = tiny("edge_5120-16x16.map")
    spec.cell = {**spec.cell, "limits": {k: v for k, v in
                                         spec.cell["limits"].items()
                                         if k != "swap_gain"}}
    out = harness.run(spec, 2**31 + 43, 0.0, False, "cpu", time.perf_counter(),
                      log=lambda msg: None)
    assert set(out["checks"]) == set(spec.cell["limits"])


def test_platform_cast_reaches_the_program(tiny):
    spec = tiny("edge_5120-16x16.map")
    assert harness._toolchain_config(spec, "cpu").cast is None  # as before
    spec.config["platform"]["cast"] = "multicast"
    cfg = harness._toolchain_config(spec, "cpu")
    assert (cfg.objective, cfg.cast) == ("cut", "multicast")
    spec.mix = {**spec.mix, "toolchain": {**spec.mix["toolchain"],
                                          "cast": "unicast"}}
    assert harness._toolchain_config(spec, "cpu").cast == "unicast"


def test_volume_mix_answers_are_multicast(volume):
    spec = volume("edge_5120-16x16.map")
    rec = harness.Cell(spec, 2**31 + 45, "cpu").job(1)
    a = rec["answers"][0]
    assert a["platform"]["cast"] == "multicast"
    assert (a["objective"], a["cast"]) == ("volume", "multicast")
    assert isinstance(a["comm_volume"], int) and isinstance(a["tree_hop"],
                                                            float)
    assert 0 < a["comm_volume"] < a["edge_cut"]
    assert rec["edge_cut"] == a["comm_volume"]  # the quality number by cast
