"""The benchmark's own tests: ``python -m pytest -q bench/tests`` from the
root of the repository.  They run on the CPU at tiny sizes; a test that
needs the card is marked ``cuda`` and skips without one."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (BENCH, BENCH.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import harness  # noqa: E402


def tiny_spec(workload: str) -> "harness.Spec":
    """A cell of the benchmark with its network and mesh cut to a size the
    CPU runs in seconds: 352 neurons on a 5 x 5 mesh at 16 a core."""
    spec = harness.load_spec(workload)
    cfg = copy.deepcopy(spec.config)
    snn = cfg["snn"]
    snn["layers"] = [144, 144, 64]
    if snn["connections"][0]["kind"] == "random":
        snn["connections"] = [{"kind": "random", "p": 0.08},
                              {"kind": "random", "p": 0.08}]
    else:
        snn["connections"] = [{"kind": "local", "radius": 2},
                              {"kind": "local", "radius": 2}]
    snn["target_spikes"] = 20_000
    cfg["num_steps"] = 80
    cfg["platform"].update(mesh_w=5, mesh_h=5, capacity=16)
    spec.config = cfg
    spec.cell = {**spec.cell, "quality_jobs": 1}
    return spec


def tiny_volume(workload: str = "edge_5120-16x16.replay",
                link_capacity: int = 1) -> "harness.Spec":
    """`tiny_spec` under the volume objective, which the program runs as
    multicast, with the queued tree-fork replay on the link-load screen, a
    link capacity that makes it congest, and the multicast numbers among
    the cell's limits."""
    spec = tiny_spec(workload)
    tc = spec.mix["toolchain"]
    noc = {"screen": "linkload"} if tc["noc_mode"] == "queued" else {}
    spec.mix = {**spec.mix, "toolchain": {**tc, "objective": "volume",
                                          "noc_kwargs": noc}}
    spec.config["platform"]["link_capacity"] = link_capacity
    spec.cell = {**spec.cell, "limits": {**spec.cell["limits"],
                                         "vol_gap": 0, "tree_gap": 0}}
    return spec


@pytest.fixture
def tiny():
    return tiny_spec


@pytest.fixture
def volume():
    return tiny_volume
