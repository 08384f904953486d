"""The port's spans and counts (`repro_torch.spans`) on the CPU.

One job of the toolchain on a tiny network (smooth_1280 at 200 steps, the
vec partitioner, ``sa_jax`` with the polish, then the queued replay on the
link-load screen and the torch stepper, and the analytic count) is run with
tracing off, under a CPU ``torch.profiler`` session and under
``spans.recording()`` alone.
"""
import dataclasses
from collections import deque

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import ToolchainConfig, run_toolchain
from repro_torch.core import mapping_device
from repro_torch.snn import make_snn, profile_snn

BASE = dict(mesh_w=10, mesh_h=10, capacity=16, seed=0, partition_impl="vec",
            mapper="sa_jax", mapper_kwargs={"iters": 640}, device="cpu")
NOC = {"queued": dict(noc_mode="queued",
                      noc_kwargs={"screen": "linkload", "stepper": "jax"}),
       "analytic": dict(noc_mode="analytic")}
TABLE = {
    "sneap.profile", "sneap.profile.upload", "sneap.profile.lif",
    "sneap.profile.extract", "sneap.profile.graph",
    "sneap.toolchain",
    "sneap.partition", "sneap.partition.coarsen", "sneap.partition.initpart",
    "sneap.partition.refine",
    "sneap.mapping", "sneap.mapping.traffic", "sneap.sa", "sneap.sa.setup",
    "sneap.sa.epoch", "sneap.sa.wait", "sneap.polish",
    "sneap.polish.wait",
    "sneap.mapping.score",
    "sneap.evaluate", "sneap.noc.order", "sneap.noc.analytic",
    "sneap.replay.windows", "sneap.replay.screen", "sneap.replay.expand",
    "sneap.replay.schedule", "sneap.replay.stepper",
    "sneap.replay.stepper.wait", "sneap.replay.stats",
}


def _raise(*args, **kwargs):
    raise AssertionError("record_function entered")


def _job(topo, polish_calls):
    """Profile, then one toolchain run a NoC mode; counts swap_deltas calls
    (one a polish step) into ``polish_calls``."""
    inner = mapping_device.swap_deltas

    def counted(*args):
        polish_calls.append(1)
        return inner(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mapping_device, "swap_deltas", counted)
        prof = profile_snn(topo, num_steps=200, seed=0, device="cpu")
        res = {mode: run_toolchain(prof, config=ToolchainConfig(**BASE, **kw))
               for mode, kw in NOC.items()}
    return prof, res


def _no_annotation(mp):
    mp.setattr(torch.profiler, "record_function", _raise)
    mp.setattr(torch.autograd.profiler, "record_function", _raise)


@pytest.fixture(scope="module")
def topo():
    return make_snn("smooth_1280")


@pytest.fixture(scope="module")
def runs(topo):
    """The job with tracing off, under a profiler session and under
    recording(): (profile, results, spans, annotations, polish calls)."""
    out = {}
    spans.clear()
    with pytest.MonkeyPatch.context() as mp:
        _no_annotation(mp)
        calls = []
        prof, res = _job(topo, calls)
    out["off"] = (prof, res, spans.spans(), [], calls)

    spans.clear()
    calls = []
    with profile(activities=[ProfilerActivity.CPU]) as session:
        prof, res = _job(topo, calls)
    notes = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in session.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith("sneap.")]
    out["profiler"] = (prof, res, spans.spans(), notes, calls)

    spans.clear()
    calls = []
    with pytest.MonkeyPatch.context() as mp, spans.recording():
        _no_annotation(mp)
        prof, res = _job(topo, calls)
    out["recording"] = (prof, res, spans.spans(), [], calls)
    spans.clear()
    return out


def test_off_enters_no_annotation_and_records_nothing(runs):
    _, res, recorded, _, _ = runs["off"]
    assert recorded == []
    assert spans.dropped() == 0
    assert set(res["queued"].phase_seconds) == {"partition", "mapping",
                                                "evaluate"}
    assert all(s > 0 for s in res["queued"].phase_seconds.values())


def test_off_span_does_nothing():
    s = spans.span("sneap.test", n=1)
    with s as inner:
        inner.add(n=2)
    assert not s and spans.spans() == []


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_every_span_of_the_table_appears_and_nests(runs, mode):
    _, _, recorded, _, _ = runs[mode]
    names = {s.name for s in recorded}
    assert TABLE <= names
    assert not any(n.startswith("bench.") for n in names)
    assert all(n.startswith("sneap.") for n in names)
    by_id = {s.id: s for s in recorded}
    for s in recorded:
        assert s.start_ns <= s.end_ns
        if s.parent == 0:
            assert s.root == s.id
            assert s.name in ("sneap.profile", "sneap.toolchain")
            continue
        p = by_id[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.root == p.root
    roots = [s for s in recorded if s.name == "sneap.toolchain"]
    assert len(roots) == len(NOC)

    def ancestors(s):
        while s.parent:
            s = by_id[s.parent]
            yield s.name

    for s in recorded:
        want = {"sneap.partition.refine": "sneap.partition",
                "sneap.sa.epoch": "sneap.sa", "sneap.polish": "sneap.sa",
                "sneap.polish.wait": "sneap.polish",
                "sneap.replay.stepper.wait": "sneap.replay.stepper",
                "sneap.replay.screen": "sneap.evaluate",
                "sneap.noc.analytic": "sneap.evaluate",
                "sneap.profile.lif": "sneap.profile"}.get(s.name)
        if want is not None:
            assert want in set(ancestors(s)), s.name


def test_spans_lie_inside_their_annotations(runs):
    """Each span of the job is one profiler annotation of its name, nested
    as the spans nest; and on the shared clock each span's two stamps fall
    inside its annotation.  The profiler maps its own clock onto the wall
    clock over a session, so a wall-clock step inside the job's long
    session would move the one against the other: the stamps are held to
    the annotations over a session of a few spans."""
    _, _, recorded, notes, _ = runs["profiler"]
    by_id = {s.id: s for s in recorded}
    paired = {}
    for name in {s.name for s in recorded}:
        mine = sorted(s.id for s in recorded if s.name == name)  # entry order
        theirs = sorted((a, b) for n, a, b in notes if n == name)
        assert len(mine) == len(theirs), name
        paired.update(zip(mine, theirs))
    for s in recorded:
        if s.parent:
            (x, y), (px, py) = paired[s.id], paired[s.parent]
            assert px <= x <= y <= py, (s.name, by_id[s.parent].name)

    spans.clear()
    with profile(activities=[ProfilerActivity.CPU]) as session:
        with spans.phase("sneap.partition") as ph:
            with spans.span("sneap.partition.coarsen") as s:
                s.add(levels=1)
            with spans.span("sneap.partition.refine"):
                spans.add(degree_calls=1)
    recorded = spans.spans()
    spans.clear()
    notes = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in session.profiler.kineto_results.events()
             if e.is_user_annotation() and e.name().startswith("sneap.")}
    assert len(recorded) == len(notes) == 3
    for s in recorded:
        x, y = notes[s.name]
        assert x <= s.start_ns <= s.end_ns <= y, s.name
    assert ph.seconds > 0


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_counts_are_consistent(runs, mode):
    _, res, recorded, _, calls = runs[mode]
    root = next(s.id for s in recorded if s.name == "sneap.toolchain"
                and s.attrs["noc_mode"] == "queued")
    job = [s for s in recorded if s.root == root]

    def one(name):
        (s,) = [s for s in job if s.name == name]
        return s.attrs

    noc = res["queued"].noc
    packets = one("sneap.replay.windows")["noc_packets"]
    assert packets == noc.num_noc_spikes
    sched = one("sneap.replay.schedule")
    assert 0 < sched["stepped"] <= sched["past_screen"] <= packets
    stepper = one("sneap.replay.stepper")
    assert stepper["packets"] == sched["stepped"]
    waits = [s for s in job if s.name == "sneap.replay.stepper.wait"]
    assert stepper["reads"] == len(waits) + 1  # the last wait reads two
    assert one("sneap.replay.screen")["link_load_records"] == packets
    order = [s.attrs for s in job if s.name == "sneap.noc.order"]
    assert len(order) == 2  # the canonical sort, then the local split
    assert order[0]["records"] == noc.num_noc_spikes + noc.num_local_spikes
    assert order[0]["local"] == noc.num_local_spikes
    # One swap_deltas call a polish step, the last non-improving one too.
    polish = [s for s in recorded if s.name == "sneap.polish"]
    assert sum(s.attrs["steps"] for s in polish) == len(calls) > 0
    assert len(polish) == len(NOC)
    assert sum(1 for s in recorded if s.name == "sneap.polish.wait") == len(calls)
    sa = one("sneap.sa")
    assert sa["epochs"] == 640 // 64
    assert sum(1 for s in job if s.name == "sneap.sa.epoch") == sa["epochs"]
    refine = [s for s in job if s.name == "sneap.partition.refine"]
    assert len(refine) == res["queued"].partition.num_levels
    assert {s.attrs["engine"] for s in refine} <= {"scalar", "vec"}
    assert "vec" in {s.attrs["engine"] for s in refine}


def test_degree_kernel_calls_count_rows():
    from repro_torch.core.graph import build_graph
    from repro_torch.core.refine_vec import refine_level_vec

    rng = np.random.default_rng(0)
    n = 200
    src, dst = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
    g = build_graph(n, src, dst, np.ones(2000, dtype=np.int64))
    part = rng.integers(0, 8, n)
    spans.clear()
    with spans.recording(), spans.span("sneap.partition.refine") as s:
        refine_level_vec(g, part, 8, 40, use_kernel=True, device="cpu")
    (rec,) = spans.spans()
    spans.clear()
    assert rec.attrs["degree_calls"] >= 1
    assert rec.attrs["degree_rows"] >= rec.attrs["degree_calls"]
    assert s.attrs is rec.attrs


@pytest.mark.parametrize("mode", ["profiler", "recording"])
def test_results_equal_with_tracing_on_and_off(runs, mode):
    want_prof, want, _, _, want_calls = runs["off"]
    got_prof, got, _, _, got_calls = runs[mode]
    for f in ("trace_t", "trace_src", "trace_dst", "fire_counts"):
        np.testing.assert_array_equal(getattr(got_prof, f),
                                      getattr(want_prof, f))
    assert len(got_calls) == len(want_calls)
    for m in NOC:
        a, b = got[m], want[m]
        np.testing.assert_array_equal(a.partition.part, b.partition.part)
        assert a.partition.edge_cut == b.partition.edge_cut
        np.testing.assert_array_equal(a.mapping.placement, b.mapping.placement)
        assert a.mapping.avg_hop == b.mapping.avg_hop
        for f in dataclasses.fields(b.noc):
            x, y = getattr(a.noc, f.name), getattr(b.noc, f.name)
            if isinstance(y, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "_buffer", deque(maxlen=3))
    spans.clear()
    with spans.recording():
        for i in range(5):
            with spans.span("sneap.x", i=i):
                pass
    assert [s.attrs["i"] for s in spans.spans()] == [2, 3, 4]
    assert spans.dropped() == 2
    spans.clear()


def test_self_time_less_children():
    recs = [spans.Span(1, 0, 1, "sneap.a", 0, 100, {}),
            spans.Span(2, 1, 1, "sneap.b", 10, 40, {}),
            spans.Span(3, 1, 1, "sneap.c", 50, 60, {}),
            spans.Span(4, 2, 1, "sneap.d", 20, 30, {})]
    assert spans.self_ns(recs) == {1: 60, 2: 20, 3: 10, 4: 10}
