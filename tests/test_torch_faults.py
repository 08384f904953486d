"""The port's fault model, re-mapper and fault scenario driver against the
reference on the CPU: every case of `tests/test_faults.py`, run through
`repro_torch` with the reference as the oracle wherever the case has a
result.  Every phase here is deterministic, so every result — stats,
partitions, placements, migration counts — must equal the reference's
bitwise."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import fanout_snn_graph, random_spike_trace  # noqa: E402
from repro.core import evict_dead_partitions as ref_evict  # noqa: E402
from repro.core import incremental_remap as ref_incremental_remap  # noqa: E402
from repro.core import make_objective as ref_make_objective  # noqa: E402
from repro.core import run_toolchain as ref_run_toolchain  # noqa: E402
from repro.core import scratch_remap as ref_scratch_remap  # noqa: E402
from repro.core import sneap_partition as ref_sneap_partition  # noqa: E402
from repro.core.placecost import MigrationAwareObjective as RefMigration  # noqa: E402
from repro.nocsim import simulate_noc as ref_simulate_noc  # noqa: E402
from repro.runtime import faults as ref_faults  # noqa: E402
from repro.runtime.health import HeartbeatMonitor as RefHeartbeatMonitor  # noqa: E402
from repro.snn.simulate import ProfileResult as RefProfileResult  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    MigrationAwareObjective,
    check_degraded_capacity,
    evict_dead_partitions,
    incremental_remap,
    make_objective,
    partition_weights,
    run_toolchain,
    scratch_remap,
    sneap_partition,
)
from repro_torch.nocsim import simulate_noc  # noqa: E402
from repro_torch.nocsim.xy import link_ids_for_routes  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FaultEvent,
    FaultSchedule,
    FaultState,
    HeartbeatMonitor,
    heartbeat_detect,
)

SECONDS = ("partition_s", "mapping_s", "evaluate_s", "total_s", "remap_s")


def assert_stats_identical(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for key in da:
        va, vb = da[key], db[key]
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert np.array_equal(va, vb), key
        else:
            assert va == vb, key


def _ref_state(state: FaultState):
    """The reference's `FaultState` with the port state's masks."""
    return ref_faults.FaultState(state.w, state.h, state.dead_cores.copy(),
                                 state.dead_links.copy())


def _both(t, src, dst, part, placement, w, h, state, **kw):
    """(port, reference) replays of one trace under one fault state."""
    got = simulate_noc(t, src, dst, part, placement, w, h, faults=state,
                       device="cpu", **kw)
    want = ref_simulate_noc(t, src, dst, part, placement, w, h,
                            faults=_ref_state(state), **kw)
    assert_stats_identical(got, want)
    return got


# ---------------------------------------------------------------------------
# fault model: zero-fault parity, drops, detours, conservation


@pytest.mark.parametrize("cast", ["unicast", "multicast"])
@pytest.mark.parametrize("mode,engine", [
    ("analytic", "batched"), ("queued", "batched"), ("queued", "ref"),
])
def test_empty_fault_state_bit_identical(cast, mode, engine):
    t, src, dst, part, placement = random_spike_trace(
        seed=2, n_spikes=600, timesteps=15)
    args = dict(mode=mode, engine=engine, cast=cast, link_capacity=2)
    plain = simulate_noc(t, src, dst, part, placement, 3, 3, device="cpu",
                         **args)
    empty = _both(t, src, dst, part, placement, 3, 3, FaultState.none(3, 3),
                  **args)
    assert_stats_identical(plain, empty)
    assert empty.spikes_dropped == 0 and empty.detour_hops == 0


@pytest.mark.parametrize("mode,engine", [
    ("analytic", "batched"), ("queued", "batched"), ("queued", "ref"),
])
def test_unicast_spike_conservation_under_dead_cores(mode, engine):
    t, src, dst, part, placement = random_spike_trace(
        seed=5, n_spikes=800, timesteps=10)
    state = FaultState.none(3, 3).apply(FaultEvent(0, "core", (1, 7)))
    s = _both(t, src, dst, part, placement, 3, 3, state, mode=mode,
              engine=engine, link_capacity=2)
    assert s.spikes_dropped > 0
    assert s.num_noc_spikes + s.num_local_spikes + s.spikes_dropped == t.shape[0]
    base = simulate_noc(t, src, dst, part, placement, 3, 3, mode=mode,
                        engine=engine, link_capacity=2, device="cpu")
    assert base.num_noc_spikes + base.num_local_spikes == t.shape[0]
    assert s.num_noc_spikes < base.num_noc_spikes


def _one_packet(src_core, dst_core):
    """A single spike between two 2-neuron partitions on a 3x3 mesh."""
    return (np.array([0]), np.array([0]), np.array([1]), np.array([0, 1]),
            np.array([src_core, dst_core]))


def test_blocked_xy_route_detours_via_yx():
    t, src, dst, part, placement = _one_packet(0, 4)
    east01 = int(link_ids_for_routes(np.array([0]), np.array([1]), 3, 3)[0][0])
    north03 = int(link_ids_for_routes(np.array([0]), np.array([3]), 3, 3)[0][0])
    state = FaultState.none(3, 3).apply(FaultEvent(0, "link", (east01,)))
    s = _both(t, src, dst, part, placement, 3, 3, state)
    assert (s.spikes_dropped, s.num_noc_spikes, s.detour_hops, s.total_hops) \
        == (0, 1, 2, 2)
    both = state.apply(FaultEvent(0, "link", (north03,)))
    s2 = _both(t, src, dst, part, placement, 3, 3, both)
    assert (s2.spikes_dropped, s2.num_noc_spikes, s2.detour_hops) == (1, 0, 0)


def test_dead_endpoint_drops_remote_and_local_spikes():
    t, src, dst, part, placement = _one_packet(0, 4)
    dead_dst = FaultState.none(3, 3).apply(FaultEvent(0, "core", (4,)))
    s = _both(t, src, dst, part, placement, 3, 3, dead_dst)
    assert s.spikes_dropped == 1 and s.num_noc_spikes == 0
    dead_src = FaultState.none(3, 3).apply(FaultEvent(0, "core", (0,)))
    local = _both(t, src, np.array([0]), part, placement, 3, 3, dead_src)
    assert local.spikes_dropped == 1 and local.num_local_spikes == 0


def test_dead_core_kills_its_router_for_through_traffic():
    t, src, dst, part, placement = _one_packet(0, 2)
    state = FaultState.none(3, 3).apply(FaultEvent(0, "core", (1,)))
    s = _both(t, src, dst, part, placement, 3, 3, state)
    assert s.spikes_dropped == 1 and s.num_noc_spikes == 0


def test_fault_state_masks_match_reference():
    state = FaultState.none(4, 3).apply(FaultEvent(2, "core", (5,)))
    state = state.apply(FaultEvent(3, "link", (0, 7)))
    want = ref_faults.FaultState.none(4, 3).apply(
        ref_faults.FaultEvent(2, "core", (5,))).apply(
        ref_faults.FaultEvent(3, "link", (0, 7)))
    np.testing.assert_array_equal(state.dead_cores, want.dead_cores)
    np.testing.assert_array_equal(state.dead_links, want.dead_links)
    np.testing.assert_array_equal(state.blocked_links(), want.blocked_links())
    np.testing.assert_array_equal(state.alive_cores(), want.alive_cores())
    with pytest.raises(ValueError, match="outside mesh"):
        state.apply(FaultEvent(0, "core", (12,)))
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultEvent(0, "router", (1,))


def test_fault_state_on_another_mesh_is_refused():
    t, src, dst, part, placement = _one_packet(0, 4)
    state = FaultState.none(4, 4).apply(FaultEvent(0, "core", (9,)))
    with pytest.raises(ValueError, match="fault state built for 4x4"):
        simulate_noc(t, src, dst, part, placement, 3, 3, faults=state,
                     device="cpu")


@pytest.mark.parametrize("kw", [dict(n_core_faults=5, n_link_faults=0),
                                dict(n_core_faults=3, n_link_faults=6),
                                dict(n_core_faults=0, n_link_faults=8)])
@pytest.mark.parametrize("seed", [0, 2, 9])
def test_random_schedule_matches_reference(kw, seed):
    got = FaultSchedule.random(16, 16, t_max=418, seed=seed, **kw)
    want = ref_faults.FaultSchedule.random(16, 16, t_max=418, seed=seed, **kw)
    assert [(e.t, e.kind, e.ids) for e in got.events] == \
        [(e.t, e.kind, e.ids) for e in want.events]
    assert got.event_times() == want.event_times()
    t = got.event_times()[len(got) // 2]
    np.testing.assert_array_equal(got.state_at(t, 16, 16).dead_links,
                                  want.state_at(t, 16, 16).dead_links)
    np.testing.assert_array_equal(got.state_at(t, 16, 16).dead_cores,
                                  want.state_at(t, 16, 16).dead_cores)


# ---------------------------------------------------------------------------
# MigrationAwareObjective: exact deltas, equal to the reference's


def _wrapper(seed=0, k=12, num_cores=16, dead=(3, 11)):
    rng = np.random.default_rng(seed)
    traffic = rng.integers(0, 40, (k, k)).astype(np.int64)
    np.fill_diagonal(traffic, 0)
    live = rng.permutation(num_cores)
    move_weight = rng.integers(1, 50, k)
    dead_mask = np.zeros(num_cores, dtype=bool)
    dead_mask[list(dead)] = True
    objs = []
    for make, cls in ((make_objective, MigrationAwareObjective),
                      (ref_make_objective, RefMigration)):
        base = make("pairwise", traffic, num_cores, 4, mesh_h=4)
        objs.append(cls(base, live, move_weight, migration_cost=2.5,
                        dead_cores=dead_mask, forbid_penalty=1e5))
    return objs, rng


def test_migration_objective_total_decomposes():
    (obj, ref), rng = _wrapper()
    p = rng.permutation(16)
    assert obj.total(p) == ref.total(p)
    assert obj.total(p) == pytest.approx(obj.base.total(p) + obj.penalty_total(p))
    forb = obj.forbid_penalty * (obj.real & obj.dead[obj.live]).sum()
    assert obj.penalty_total(obj.live) == pytest.approx(forb)


def test_migration_objective_swap_deltas_exact():
    (obj, ref), rng = _wrapper(seed=7)
    p = rng.permutation(16)
    obj.attach(p.copy())
    ref.attach(p.copy())
    aa = rng.integers(0, 16, 64)
    bb = (aa + rng.integers(1, 16, 64)) % 16
    batch = obj.swap_delta_batch(aa, bb)
    np.testing.assert_array_equal(batch, ref.swap_delta_batch(aa, bb))
    for i in range(aa.shape[0]):
        a, b = int(aa[i]), int(bb[i])
        sd = obj.swap_delta(a, b)
        assert sd == pytest.approx(batch[i], abs=1e-9)
        p2 = p.copy()
        p2[a], p2[b] = p2[b], p2[a]
        assert sd == pytest.approx(obj.total(p2) - obj.total(p), abs=1e-6)


def test_migration_objective_apply_swaps_matches_recompute():
    (obj, ref), rng = _wrapper(seed=11)
    p = rng.permutation(16)
    obj.attach(p.copy())
    ref.attach(p.copy())
    pairs = np.array([[0, 5], [1, 9], [2, 14]])
    total = obj.apply_swaps(pairs)
    assert total == ref.apply_swaps(pairs)
    q = p.copy()
    for a, b in pairs:
        q[a], q[b] = q[b], q[a]
    np.testing.assert_array_equal(obj._placement, q)
    assert total == pytest.approx(obj.total(q), abs=1e-6)


# ---------------------------------------------------------------------------
# eviction + remap


@pytest.fixture(scope="module")
def live_mapping():
    """tests/test_faults.py's live mapping: a 440-neuron SNN partitioned at
    capacity 40 on a 4x4 mesh (the reference's partition, checked equal to
    the port's), re-mapped with capacity-60 headroom."""
    ref_g = fanout_snn_graph(440, fan=8, seed=1)
    pres = ref_sneap_partition(ref_g, capacity=40, seed=0, impl="vec")
    g = interop.graph_from(ref_g)
    mine = sneap_partition(g, capacity=40, seed=0, impl="vec", device="cpu")
    np.testing.assert_array_equal(mine.part, pres.part)
    placement = np.random.default_rng(0).permutation(16)[:pres.k]
    r = np.random.default_rng(3)
    t = np.sort(r.integers(0, 40, 5000))
    src = r.integers(0, 440, 5000)
    dst = r.integers(0, 440, 5000)
    return ref_g, g, pres, placement, (t, src, dst)


@pytest.mark.parametrize("refine_iters", [0, 8])
@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_evict_dead_partitions_vacates_and_respects_forbid(
        live_mapping, refine_iters, objective):
    ref_g, g, pres, _, _ = live_mapping
    dead_parts = np.array([2, 5])
    w0 = partition_weights(g, pres.part, pres.k)
    part2, n_evicted = evict_dead_partitions(
        g, pres.part, pres.k, capacity=60, dead_parts=dead_parts,
        objective=objective, refine_iters=refine_iters, device="cpu")
    want, want_n = ref_evict(ref_g, pres.part, pres.k, capacity=60,
                             dead_parts=dead_parts, objective=objective,
                             refine_iters=refine_iters)
    np.testing.assert_array_equal(part2, want)
    assert n_evicted == want_n == int(w0[dead_parts].sum())
    w2 = partition_weights(g, part2, pres.k)
    assert (w2[dead_parts] == 0).all() and (w2 <= 60).all()
    assert w2.sum() == w0.sum()
    if refine_iters == 0:
        kept = ~np.isin(pres.part, dead_parts)
        assert (part2[kept] == pres.part[kept]).all()


def _same_remap(got, want):
    np.testing.assert_array_equal(got.part, want.part)
    np.testing.assert_array_equal(got.placement, want.placement)
    np.testing.assert_array_equal(got.mapping.placement, want.mapping.placement)
    assert (got.k, got.strategy, got.neurons_migrated, got.neurons_evicted,
            got.migration_cost, got.mapping.avg_hop, got.mapping.tree_hop) == (
        want.k, want.strategy, want.neurons_migrated, want.neurons_evicted,
        want.migration_cost, want.mapping.avg_hop, want.mapping.tree_hop)


@pytest.mark.parametrize("strategy", ["incremental", "scratch"])
def test_remap_matches_reference_and_avoids_dead_cores(live_mapping, strategy):
    ref_g, g, pres, placement, (t, src, dst) = live_mapping
    dead = np.zeros(16, dtype=bool)
    dead[[int(placement[1]), int(placement[4])]] = True
    kwargs = dict(capacity=60, seed=0, mapper_kwargs={"iters": 3000})
    if strategy == "incremental":
        kwargs["k"] = pres.k
        fn, ref_fn = incremental_remap, ref_incremental_remap
    else:
        fn, ref_fn = scratch_remap, ref_scratch_remap
    got = fn(g, pres.part, placement, dead, t, src, dst, 4, 4, device="cpu",
             **kwargs)
    again = fn(g, pres.part, placement, dead, t, src, dst, 4, 4, device="cpu",
               **kwargs)
    want = ref_fn(ref_g, pres.part, placement, dead, t, src, dst, 4, 4,
                  **kwargs)
    _same_remap(got, want)
    _same_remap(again, want)
    w = partition_weights(g, got.part, got.k)
    assert not dead[got.placement[:got.k][w > 0]].any()
    assert got.neurons_migrated > 0
    displaced = int(g.vwgt[dead[np.asarray(placement)[pres.part]]].sum())
    assert got.neurons_migrated >= displaced


def test_incremental_moves_no_more_than_scratch(live_mapping):
    _, g, pres, placement, (t, src, dst) = live_mapping
    dead = np.zeros(16, dtype=bool)
    dead[[int(placement[1]), int(placement[4])]] = True
    kw = dict(capacity=60, seed=0, mapper_kwargs={"iters": 3000}, device="cpu")
    inc = incremental_remap(g, pres.part, placement, dead, t, src, dst, 4, 4,
                            k=pres.k, **kw)
    scr = scratch_remap(g, pres.part, placement, dead, t, src, dst, 4, 4, **kw)
    assert inc.neurons_migrated <= scr.neurons_migrated


def test_incremental_remap_scores_on_the_swap_delta_op(live_mapping):
    """``score_backend="auto"`` (the swap_delta op's plain version here)
    prices the migration-aware objective exactly on this integer traffic,
    so it commits the numpy scorer's swaps."""
    _, g, pres, placement, (t, src, dst) = live_mapping
    dead = np.zeros(16, dtype=bool)
    dead[[int(placement[0]), int(placement[6])]] = True
    kw = dict(capacity=60, seed=0, k=pres.k, device="cpu")
    numpy_scored = incremental_remap(g, pres.part, placement, dead, t, src,
                                     dst, 4, 4, mapper_kwargs={"iters": 3000},
                                     **kw)
    kernel_scored = incremental_remap(
        g, pres.part, placement, dead, t, src, dst, 4, 4,
        mapper_kwargs={"iters": 3000, "score_backend": "auto"}, **kw)
    _same_remap(kernel_scored, numpy_scored)


def test_remap_eviction_when_mesh_is_short_on_cores(live_mapping):
    ref_g, g, pres, placement, (t, src, dst) = live_mapping
    w0 = partition_weights(g, pres.part, pres.k)
    n_real = int((w0 > 0).sum())
    n_dead = 16 - n_real + 2
    dead = np.zeros(16, dtype=bool)
    dead[placement[np.flatnonzero(w0 > 0)[:n_dead]]] = True
    assert n_real > 16 - int(dead.sum())
    kw = dict(capacity=60, seed=0, k=pres.k, mapper_kwargs={"iters": 2000})
    res = incremental_remap(g, pres.part, placement, dead, t, src, dst, 4, 4,
                            device="cpu", **kw)
    want = ref_incremental_remap(ref_g, pres.part, placement, dead, t, src,
                                 dst, 4, 4, **kw)
    _same_remap(res, want)
    assert res.neurons_evicted > 0
    w2 = partition_weights(g, res.part, res.k)
    assert int((w2 > 0).sum()) <= 16 - int(dead.sum())
    assert not dead[res.placement[:res.k][w2 > 0]].any()


def test_remap_infeasible_degraded_mesh_names_deficit(live_mapping):
    _, g, pres, placement, (t, src, dst) = live_mapping
    dead = np.ones(16, dtype=bool)
    dead[:7] = False  # 7 live x 60 = 420 < 440 neurons
    with pytest.raises(ValueError, match=r"exceed 7 live cores.*by 20"):
        incremental_remap(g, pres.part, placement, dead, t, src, dst,
                          4, 4, capacity=60, k=pres.k, device="cpu")
    with pytest.raises(ValueError, match=r"covers 15 != 16 cores"):
        scratch_remap(g, pres.part, placement, dead[:15], t, src, dst,
                      4, 4, capacity=60, device="cpu")


def test_capacity_errors_name_the_deficit():
    with pytest.raises(ValueError, match=r"by 50.*needs >= 10 live cores"):
        check_degraded_capacity(100, 10, 5)
    check_degraded_capacity(100, 10, 10)  # exactly feasible: no raise
    g = interop.graph_from(fanout_snn_graph(100, fan=4, seed=0))
    with pytest.raises(ValueError, match=r"k=2 infeasible.*by 60.*need >= 5"):
        sneap_partition(g, capacity=20, k=2, device="cpu")
    with pytest.raises(ValueError, match="surviving partitions"):
        part = np.repeat(np.arange(5), 20)
        evict_dead_partitions(g, part, 5, capacity=20,
                              dead_parts=np.array([0, 1, 2]), device="cpu")


def test_remap_defaults_to_the_card(live_mapping):
    """Every remap entry point runs its device work on the card unless the
    caller asks for the CPU; without a GPU that is an error, not a
    fallback."""
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    _, g, pres, placement, (t, src, dst) = live_mapping
    dead = np.zeros(16, dtype=bool)
    dead[int(placement[1])] = True
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        incremental_remap(g, pres.part, placement, dead, t, src, dst, 4, 4,
                          capacity=60, k=pres.k)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scratch_remap(g, pres.part, placement, dead, t, src, dst, 4, 4,
                      capacity=60)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evict_dead_partitions(g, pres.part, pres.k, capacity=60,
                              dead_parts=np.array([1]))


def test_cpu_remap_touches_no_cuda_api(live_mapping, monkeypatch):
    _, g, pres, placement, (t, src, dst) = live_mapping

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU remap called into torch.cuda")

    for name in ("is_available", "synchronize", "current_device",
                 "device_count", "current_stream", "Stream", "CUDAGraph"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    dead = np.zeros(16, dtype=bool)
    dead[[int(placement[1]), int(placement[4])]] = True
    kw = dict(capacity=60, seed=0, device="cpu",
              mapper_kwargs={"iters": 500, "score_backend": "auto"})
    incremental_remap(g, pres.part, placement, dead, t, src, dst, 4, 4,
                      k=pres.k, evict=True, **kw)
    scratch_remap(g, pres.part, placement, dead, t, src, dst, 4, 4, **kw)


# ---------------------------------------------------------------------------
# failure detection


def test_heartbeat_detect_flags_exactly_the_dead_cores():
    dead = np.zeros(16, dtype=bool)
    dead[[3, 7]] = True
    assert heartbeat_detect(HeartbeatMonitor(16), dead) == [3, 7] == \
        ref_faults.heartbeat_detect(RefHeartbeatMonitor(16), dead)
    assert heartbeat_detect(HeartbeatMonitor(16), np.zeros(16, bool)) == []


def test_heartbeat_monitor_rebalances_like_the_reference():
    mine, ref = HeartbeatMonitor(4, window=4), RefHeartbeatMonitor(4, window=4)
    for step in range(6):
        for host in range(4):
            s = 1.0 + (2.5 if host == 2 else 0.0) + 0.01 * step
            mine.report(host, step, s)
            ref.report(host, step, s)
    np.testing.assert_array_equal(mine.medians(), ref.medians())
    assert mine.stragglers() == ref.stragglers() == [2]
    plan = {0: 6, 1: 6, 2: 6, 3: 6}
    assert mine.rebalance_plan(plan) == ref.rebalance_plan(plan)


# ---------------------------------------------------------------------------
# scenario driver


@pytest.fixture(scope="module")
def smoke_profiles():
    """tests/test_faults.py's smoke profile, for both packages."""
    g = fanout_snn_graph(440, fan=8, seed=1)
    r = np.random.default_rng(3)
    n_spikes = 5000
    t = np.sort(r.integers(0, 40, n_spikes))
    src = r.integers(0, 440, n_spikes)
    dst = r.integers(0, 440, n_spikes)
    ref = RefProfileResult(
        name="smoke", graph=g, trace_t=t, trace_src=src, trace_dst=dst,
        num_neurons=440, num_steps=40,
        fire_counts=np.bincount(src, minlength=440), seconds=0.0,
    )
    return interop.profile_from(ref), ref


_TOOLCHAIN = dict(mesh_w=4, mesh_h=4, capacity=60, seed=0,
                  partition_impl="vec", mapper_kwargs={"iters": 3000})


def _same_run(got, want):
    """Port and reference toolchain runs agree on every result."""
    sg, sw = got.summary(), want.summary()
    assert {k: v for k, v in sg.items() if k not in SECONDS} == \
        {k: v for k, v in sw.items() if k not in SECONDS}
    assert_stats_identical(got.noc, want.noc)
    np.testing.assert_array_equal(got.partition.part, want.partition.part)
    np.testing.assert_array_equal(got.mapping.placement, want.mapping.placement)
    dg = {k: v for k, v in (got.degradation or {}).items() if k != "remap_s"}
    dw = {k: v for k, v in (want.degradation or {}).items() if k != "remap_s"}
    assert dg == dw


def test_toolchain_empty_schedule_bit_identical(smoke_profiles):
    prof, ref = smoke_profiles
    plain = run_toolchain(prof, device="cpu", **_TOOLCHAIN)
    empty = run_toolchain(prof, fault_schedule=FaultSchedule([]), device="cpu",
                          **_TOOLCHAIN)
    assert_stats_identical(plain.noc, empty.noc)
    assert plain.degradation is None
    assert empty.degradation["remap_events"] == 0
    assert empty.summary()["spikes_dropped"] == 0
    assert set(empty.phase_seconds) == {"partition", "mapping", "evaluate",
                                        "remap", "scenario"}
    _same_run(empty, ref_run_toolchain(
        ref, fault_schedule=ref_faults.FaultSchedule([]), **_TOOLCHAIN))


@pytest.mark.parametrize("strategy", ["incremental", "scratch"])
def test_toolchain_midtrace_core_failure_remaps(smoke_profiles, strategy):
    prof, ref = smoke_profiles
    baseline = run_toolchain(prof, device="cpu", **_TOOLCHAIN)
    victims = tuple(int(c) for c in baseline.mapping.placement[:2])
    res = run_toolchain(prof, fault_schedule=FaultSchedule(
        [FaultEvent(20, "core", victims)]), remap_strategy=strategy,
        device="cpu", **_TOOLCHAIN)
    want = ref_run_toolchain(ref, fault_schedule=ref_faults.FaultSchedule(
        [ref_faults.FaultEvent(20, "core", victims)]),
        remap_strategy=strategy, **_TOOLCHAIN)
    _same_run(res, want)
    s = res.summary()
    assert (s["remap_events"], s["remap_strategy"]) == (1, strategy)
    assert s["neurons_migrated"] > 0 and s["spikes_dropped"] > 0
    assert res.degradation["dead_cores"] == 2
    n = res.noc
    assert (n.num_noc_spikes + n.num_local_spikes + n.spikes_dropped
            == prof.num_spikes)
    assert n.dynamic_energy_pj > 0
    assert res.phase_seconds["remap"] > 0


def test_toolchain_link_failure_reroutes_without_remap(smoke_profiles):
    prof, ref = smoke_profiles
    baseline = run_toolchain(prof, device="cpu", **_TOOLCHAIN)
    hot = int(np.argmax(baseline.noc.per_link_hops))
    res = run_toolchain(prof, fault_schedule=FaultSchedule(
        [FaultEvent(10, "link", (hot,))]), device="cpu", **_TOOLCHAIN)
    want = ref_run_toolchain(ref, fault_schedule=ref_faults.FaultSchedule(
        [ref_faults.FaultEvent(10, "link", (hot,))]), **_TOOLCHAIN)
    _same_run(res, want)
    assert res.degradation["remap_events"] == 0
    assert res.noc.detour_hops > 0
    assert res.summary()["neurons_migrated"] == 0


def test_toolchain_random_link_schedule_matches_reference(smoke_profiles):
    prof, ref = smoke_profiles
    res = run_toolchain(prof, fault_schedule=FaultSchedule.random(
        4, 4, 0, 40, n_link_faults=3, seed=2), device="cpu", **_TOOLCHAIN)
    want = ref_run_toolchain(ref, fault_schedule=ref_faults.FaultSchedule.random(
        4, 4, 0, 40, n_link_faults=3, seed=2), **_TOOLCHAIN)
    _same_run(res, want)
    assert res.degradation["remap_events"] == 0


def test_toolchain_remap_scores_on_the_swap_delta_op(smoke_profiles):
    """A mid-trace remap whose SA scores on the swap_delta op equals the
    numpy-scored one (integer traffic, exact f32 sums)."""
    prof, _ = smoke_profiles
    victims = (0, 5)
    sched = FaultSchedule([FaultEvent(20, "core", victims)])
    runs = [run_toolchain(prof, fault_schedule=sched, device="cpu",
                          remap_kwargs={"mapper_kwargs": mk}, **_TOOLCHAIN)
            for mk in ({"score_backend": "numpy"}, {"score_backend": "auto"})]
    _same_run(*runs)


def test_toolchain_unsorted_trace_and_late_events(smoke_profiles):
    """An unsorted trace is sorted before slicing; events past the trace's
    end replay nothing; both as in the reference."""
    prof, ref = smoke_profiles
    order = np.random.default_rng(0).permutation(prof.num_spikes)
    shuffled = dataclasses.replace(prof, trace_t=prof.trace_t[order],
                                   trace_src=prof.trace_src[order],
                                   trace_dst=prof.trace_dst[order])
    ref_shuffled = dataclasses.replace(ref, trace_t=ref.trace_t[order],
                                       trace_src=ref.trace_src[order],
                                       trace_dst=ref.trace_dst[order])
    events = [(12, "core", (3,)), (90, "core", (4,))]
    res = run_toolchain(shuffled, fault_schedule=FaultSchedule(
        [FaultEvent(*e) for e in events]), detect_windows=3, device="cpu",
        **_TOOLCHAIN)
    want = ref_run_toolchain(ref_shuffled, fault_schedule=ref_faults.FaultSchedule(
        [ref_faults.FaultEvent(*e) for e in events]), detect_windows=3,
        **_TOOLCHAIN)
    _same_run(res, want)
    assert res.degradation["remap_events"] == 1


def test_toolchain_empty_trace_replays_once(smoke_profiles):
    prof, ref = smoke_profiles
    empty = np.zeros(0, dtype=np.int64)
    mine = dataclasses.replace(prof, trace_t=empty, trace_src=empty,
                               trace_dst=empty)
    theirs = dataclasses.replace(ref, trace_t=empty, trace_src=empty,
                                 trace_dst=empty)
    sched = [(5, "core", (1,))]
    res = run_toolchain(mine, fault_schedule=FaultSchedule(
        [FaultEvent(*e) for e in sched]), device="cpu", **_TOOLCHAIN)
    want = ref_run_toolchain(theirs, fault_schedule=ref_faults.FaultSchedule(
        [ref_faults.FaultEvent(*e) for e in sched]), **_TOOLCHAIN)
    _same_run(res, want)
    assert res.noc.num_noc_spikes == 0 and res.degradation["remap_events"] == 0


def test_toolchain_refuses_unknown_strategy_and_device_replay(smoke_profiles):
    prof, _ = smoke_profiles
    sched = FaultSchedule([FaultEvent(20, "core", (0,))])
    with pytest.raises(ValueError, match="unknown remap_strategy"):
        run_toolchain(prof, fault_schedule=sched, remap_strategy="greedy",
                      device="cpu", **_TOOLCHAIN)
    # A live fault state is host-only, as in the reference.
    with pytest.raises(ValueError, match="requires screen='numpy'"):
        run_toolchain(prof, fault_schedule=sched, device="cpu",
                      noc_kwargs={"screen": "linkload"}, **_TOOLCHAIN)
