"""The multicast path's spans and counts (`repro_torch.spans`) on the CPU.

One volume job of the toolchain on a tiny network (smooth_1280 at 200
steps on a 10 x 10 mesh: the vec partitioner's volume refiner, ``sa_jax``
with the polish on the multicast traffic, then the queued tree-fork replay
on the link-load screen at link capacity 1, so that it steps) is run with
tracing off and under ``spans.recording()``; and the refiner's kernel
engine (its D* rows and its mover selection) is driven on its plain
version.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch import spans
from repro_torch.core import ToolchainConfig, run_toolchain
from repro_torch.core.graph import build_graph, build_hypergraph
from repro_torch.core.refine_vec import refine_level_vec
from repro_torch.nocsim import simulate_noc
from repro_torch.snn import make_snn, profile_snn

CONFIG = ToolchainConfig(mesh_w=10, mesh_h=10, capacity=16, seed=0,
                         partition_impl="vec", objective="volume",
                         mapper="sa_jax", mapper_kwargs={"iters": 640},
                         noc_mode="queued", link_capacity=1,
                         noc_kwargs={"screen": "linkload"}, device="cpu")
TREE = ("sneap.replay.tree.links", "sneap.replay.tree.screen",
        "sneap.replay.tree.schedule", "sneap.replay.tree.stepper",
        "sneap.replay.tree.stats")


@pytest.fixture(scope="module")
def prof():
    return profile_snn(make_snn("smooth_1280"), num_steps=200, seed=0,
                       device="cpu")


@pytest.fixture(scope="module")
def runs(prof):
    """(result, spans) of the job with tracing off and under recording()."""
    out = {}
    spans.clear()
    out["off"] = (run_toolchain(prof, config=CONFIG), spans.spans())
    with spans.recording():
        res = run_toolchain(prof, config=CONFIG)
    out["recording"] = (res, spans.spans())
    spans.clear()
    return out


def _named(recorded, name):
    return [s for s in recorded if s.name == name]


def _assert_same_stats(got, want):
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_off_records_nothing(runs):
    res, recorded = runs["off"]
    assert recorded == []
    assert (res.objective, res.cast) == ("volume", "multicast")


def test_results_equal_with_recording_on_and_off(runs):
    want, _ = runs["off"]
    got, _ = runs["recording"]
    np.testing.assert_array_equal(got.partition.part, want.partition.part)
    assert got.partition.comm_volume == want.partition.comm_volume
    np.testing.assert_array_equal(got.mapping.placement,
                                  want.mapping.placement)
    assert got.mapping.avg_hop == want.mapping.avg_hop
    assert got.mapping.tree_hop == want.mapping.tree_hop
    _assert_same_stats(got.noc, want.noc)


def test_spans_are_present_and_nest(runs):
    res, recorded = runs["recording"]
    by_id = {s.id: s for s in recorded}

    def ancestors(s):
        while s.parent:
            s = by_id[s.parent]
            yield s.name

    for name in ("sneap.noc.dedupe", *TREE):
        (s,) = _named(recorded, name)
        assert "sneap.evaluate" in set(ancestors(s)), name
        assert not set(ancestors(s)) & set(TREE), name  # siblings: no overlap
    evals = _named(recorded, "sneap.partition.refine.eval")
    assert evals
    for s in evals:
        assert by_id[s.parent].name == "sneap.partition.refine"
        assert s.attrs["engine"] in ("dense_host", "gather_host")  # no card
        assert s.attrs["rows"] > 0
    levels = _named(recorded, "sneap.partition.refine")
    assert len(levels) == res.partition.num_levels
    assert {s.attrs["engine"] for s in levels} == {"vec"}
    for s in levels:  # a level evaluates its D* rows on one engine
        mine = [e for e in evals if e.parent == s.id]
        assert len({e.attrs["engine"] for e in mine}) <= 1


def test_counts_are_consistent(runs):
    res, recorded = runs["recording"]
    noc = res.noc
    (dedupe,) = _named(recorded, "sneap.noc.dedupe")
    (order,) = _named(recorded, "sneap.noc.order")
    assert dedupe.attrs["records"] == order.attrs["records"] - noc.num_local_spikes
    assert dedupe.attrs["packets"] == noc.num_noc_spikes
    assert 0 < dedupe.attrs["firings"] <= dedupe.attrs["packets"]
    (links,) = _named(recorded, "sneap.replay.tree.links")
    assert links.attrs["packets"] == noc.num_noc_spikes
    assert links.attrs["firings"] == dedupe.attrs["firings"]
    assert links.attrs["tree_links"] == noc.link_traversals
    (screen,) = _named(recorded, "sneap.replay.tree.screen")
    assert screen.attrs["link_load_calls"] == 1
    assert screen.attrs["link_load_records"] == noc.num_noc_spikes
    assert screen.attrs["hot_pairs"] > 0
    (sched,) = _named(recorded, "sneap.replay.tree.schedule")
    before, after = screen.attrs["stepped_firings"], sched.attrs["stepped_firings"]
    assert 0 < after <= before <= links.attrs["firings"]
    assert 0 < sched.attrs["windows"] <= sched.attrs["past_screen_windows"]
    (stepper,) = _named(recorded, "sneap.replay.tree.stepper")
    assert stepper.attrs["congestion"] == noc.congestion_count > 0
    assert stepper.attrs["entities"] <= links.attrs["tree_links"]
    assert 0 < stepper.attrs["cycles"] <= noc.max_latency


def _assert_select_counts(sel, engine):
    """Each selection span's counts add up, on the engine named."""
    assert sel
    for s in sel:
        a = s.attrs
        assert a["engine"] == engine
        assert isinstance(a["escape"], bool)
        assert 0 < a["winners"] <= a["candidates"] <= a["pairs"]
        assert 0 <= a["contended"] <= 2 * a["pairs"]
        assert 0 <= a["rounds"] <= 4
        assert (a["rounds"] > 0) == (a["contended"] > 0)


def test_select_spans_nest_under_the_levels(runs):
    """One ``.refine.select`` span a batch of a volume level, under that
    level's span (a CPU job: the numpy selection), escapes among them."""
    res, recorded = runs["recording"]
    by_id = {s.id: s for s in recorded}
    sel = _named(recorded, "sneap.partition.refine.select")
    for s in sel:
        assert by_id[s.parent].name == "sneap.partition.refine"
    _assert_select_counts(sel, "host")
    assert any(s.attrs["escape"] for s in sel)
    assert not all(s.attrs["escape"] for s in sel)
    levels = {s.id for s in _named(recorded, "sneap.partition.refine")}
    assert {s.parent for s in sel} <= levels


@pytest.mark.parametrize("screen", ["numpy", "linkload"])
def test_tree_replay_spans_on_either_screen(prof, runs, screen):
    """The tree replay alone, on the job's mapping: the same statistics
    with recording off and on, and the screens' counts in order."""
    res, _ = runs["off"]

    def replay():
        return simulate_noc(prof.trace_t, prof.trace_src, prof.trace_dst,
                            res.partition.part, res.mapping.placement, 10, 10,
                            link_capacity=1, mode="queued", cast="multicast",
                            screen=screen, device="cpu")

    want = replay()
    spans.clear()
    with spans.recording():
        got = replay()
    recorded = spans.spans()
    spans.clear()
    _assert_same_stats(got, want)
    (links,) = _named(recorded, "sneap.replay.tree.links")
    (screened,) = _named(recorded, "sneap.replay.tree.screen")
    (sched,) = _named(recorded, "sneap.replay.tree.schedule")
    assert ("link_load_calls" in screened.attrs) == (screen == "linkload")
    assert screened.attrs["hot_pairs"] > 0
    assert (0 < sched.attrs["stepped_firings"]
            <= screened.attrs["stepped_firings"] <= links.attrs["firings"])
    assert links.attrs["tree_links"] == want.link_traversals


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_engine_counts_the_incidence_entries_it_reads(seed):
    """The connectivity kernel's evaluations (its plain version here) count
    the rows and the incidence entries the kernel reads, and the selection
    kernel's calls (its plain version) their candidates, pairs, contended
    keys, rounds and winners; the partition is the one refined with
    tracing off."""
    rng = np.random.default_rng(seed)
    n = 300
    src, dst = rng.integers(0, n, 2400), rng.integers(0, n, 2400)
    fire = rng.integers(1, 20, n)
    g = build_graph(n, src, dst, fire[src])
    g.hyper = build_hypergraph(n, src, dst, fire)
    part = rng.integers(0, 8, n)
    want = refine_level_vec(g, part, 8, 50, use_kernel=True,
                            objective="volume", device="cpu")
    spans.clear()
    with spans.recording(), spans.span("sneap.partition.refine"):
        got = refine_level_vec(g, part, 8, 50, use_kernel=True,
                               objective="volume", device="cpu")
    recorded = spans.spans()
    spans.clear()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    evals = _named(recorded, "sneap.partition.refine.eval")
    assert evals
    vxadj = g.hyper.incidence()[0]
    for s in evals:
        assert s.attrs["engine"] == "kernel" and s.attrs["k"] == 8
        assert s.attrs["edges"] == g.hyper.num_hyperedges
        # The wrapper's own count lands on the span that holds the call.
        assert s.attrs["degree_rows"] == s.attrs["rows"]
        assert s.attrs["rows"] <= s.attrs["inc_entries"] <= int(vxadj[-1])
    (level,) = _named(recorded, "sneap.partition.refine")
    sel = _named(recorded, "sneap.partition.refine.select")
    assert {s.parent for s in sel} == {level.id}
    _assert_select_counts(sel, "kernel")
