"""The port's sharded partitioning engine against the reference on the CPU.

Every case of tests/test_sharded_partition.py runs through the port with
the reference as the oracle: shard plans, halos and poisoned local views,
``comm_volume_sharded``, sharded refinement, shard-count-invariant
matching and coarsening, the out-of-core ``LevelStore``, streamed levels,
the end-to-end quality bound and the index-capacity guards.  Partitions
are held bitwise to the reference's; the sharded refiner builds none of
the degree kernels' device state.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core.graph import ShardedGraphView as RefShardedGraphView  # noqa: E402
from repro.core.graph import comm_volume_sharded as ref_comm_volume_sharded  # noqa: E402
from repro.core.partition import sneap_partition as ref_sneap_partition  # noqa: E402
from repro.core.refine import VolumeState as RefVolumeState  # noqa: E402
from repro.core.refine_vec import refine_level_vec as ref_refine_level_vec  # noqa: E402
from repro.sharding.planner import plan_vertex_shards as ref_plan_vertex_shards  # noqa: E402
from conftest import fanout_snn_graph, random_hypergraph  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import refine_vec  # noqa: E402
from repro_torch.core.coarsen import (  # noqa: E402
    LevelStore,
    coarsen,
    heavy_edge_matching_vec,
)
from repro_torch.core.graph import (  # noqa: E402
    IndexCapacityError,
    ShardedGraphView,
    build_graph,
    check_index_capacity,
    comm_volume,
    comm_volume_sharded,
    edge_partition_counts,
)
from repro_torch.core.partition import sneap_partition  # noqa: E402
from repro_torch.core.refine import VolumeState  # noqa: E402
from repro_torch.core.refine_vec import refine_level_vec  # noqa: E402
from repro_torch.sharding import VertexShardPlan, plan_vertex_shards  # noqa: E402

CPU = dict(device="cpu")


def feasible_part(n: int, k: int, seed: int = 0) -> np.ndarray:
    """Balanced random partition (unit weights, so any equal split fits)."""
    r = np.random.default_rng(seed)
    part = np.arange(n) % k
    return r.permutation(part).astype(np.int64)


def _same_levels(a, b) -> None:
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        for name in ("xadj", "adjncy", "adjwgt", "vwgt"):
            np.testing.assert_array_equal(getattr(x, name), getattr(y, name))
        assert (x.cmap is None) == (y.cmap is None)
        if x.cmap is not None:
            np.testing.assert_array_equal(x.cmap, y.cmap)


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("n,shards", [(103, 4), (100, 3), (5, 8), (1, 1)])
def test_plan_vertex_shards_partitions_the_range(n, shards):
    plan = plan_vertex_shards(n, shards, **CPU)
    ref = ref_plan_vertex_shards(n, shards, use_devices=False)
    np.testing.assert_array_equal(plan.bounds, ref.bounds)
    assert plan.bounds.dtype == np.int64
    assert plan.num_shards == ref.num_shards and plan.n == n
    blocks = [plan.block(s) for s in range(plan.num_shards)]
    assert all(lo < hi for lo, hi in blocks)
    assert [lo for lo, _ in blocks[1:]] == [hi for _, hi in blocks[:-1]]
    owner = plan.owner(np.arange(n))
    np.testing.assert_array_equal(owner, ref.owner(np.arange(n)))
    for s, (lo, hi) in enumerate(blocks):
        assert (owner[lo:hi] == s).all()


def test_plan_vertex_shards_split_routes_sorted_rows():
    plan = plan_vertex_shards(100, 3, **CPU)
    rows = np.array([0, 5, 33, 34, 66, 99])
    parts = plan.split(rows)
    want = ref_plan_vertex_shards(100, 3, use_devices=False).split(rows)
    assert len(parts) == len(want) == 3
    for got, ref in zip(parts, want):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(np.concatenate(parts), rows)
    for s, chunk in enumerate(parts):
        lo, hi = plan.block(s)
        assert ((chunk >= lo) & (chunk < hi)).all()


def test_plan_on_the_cpu_is_host_only_past_one_shard():
    plan = plan_vertex_shards(100, 4, **CPU)
    assert plan.devices is None
    assert plan.notes == ["1 device(s) < 4 shards -> host-only blocks"]
    arr = np.arange(100)
    assert plan.device_put(arr) is arr
    assert plan_vertex_shards(100, 4, use_devices=False, **CPU).notes == []
    with pytest.raises(ValueError, match="num_shards"):
        plan_vertex_shards(100, 0, **CPU)


def test_plan_of_one_shard_puts_the_array_on_its_device():
    plan = plan_vertex_shards(10, 1, **CPU)
    assert plan.devices == [torch.device("cpu")] and plan.notes == []
    blocks = plan.device_put(np.arange(10))
    assert len(blocks) == 1
    np.testing.assert_array_equal(blocks[0].numpy(), np.arange(10))


def test_plan_attaches_one_card_per_shard_where_they_divide(monkeypatch):
    """The device rule on a host with four cards (CUDA's device count
    patched; nothing is placed): even blocks get cuda:0..3, uneven ones
    stay host-only with the reference's reason."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    even = plan_vertex_shards(100, 4)
    assert even.devices == [torch.device("cuda", i) for i in range(4)]
    assert even.notes == []
    odd = plan_vertex_shards(102, 4)
    assert odd.devices is None
    assert odd.notes == ["n=102 !% 4 shards -> host-only blocks (needs even)"]
    many = plan_vertex_shards(100, 5)
    assert many.notes == ["4 device(s) < 5 shards -> host-only blocks"]


def test_plan_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        plan_vertex_shards(100, 2)


# ---------------------------------------------------------------- halos


def test_halo_cut_is_exactly_external_neighbors():
    ref_g = fanout_snn_graph(200, fan=5, seed=1)
    g = interop.graph_from(ref_g)
    plan = plan_vertex_shards(200, 3, **CPU)
    view = ShardedGraphView(g, plan)
    ref_view = RefShardedGraphView(ref_g, ref_plan_vertex_shards(200, 3, False))
    for s in range(3):
        lo, hi = plan.block(s)
        halo = view.halo(s, mode="cut")
        nbrs = g.adjncy[g.xadj[lo]:g.xadj[hi]].astype(np.int64)
        expect = np.unique(nbrs[(nbrs < lo) | (nbrs >= hi)])
        np.testing.assert_array_equal(np.sort(halo), expect)
        for mode in ("cut", "volume", "local"):
            np.testing.assert_array_equal(view.halo(s, mode=mode),
                                          ref_view.halo(s, mode=mode))


@pytest.mark.parametrize("mode", ["cut", "volume"])
def test_local_part_poisons_outside_halo(mode):
    ref_g = fanout_snn_graph(120, fan=4, seed=2)
    g = interop.graph_from(ref_g)
    plan = plan_vertex_shards(120, 4, **CPU)
    view = ShardedGraphView(g, plan)
    ref_view = RefShardedGraphView(ref_g, ref_plan_vertex_shards(120, 4, False))
    part = feasible_part(120, 6)
    lp = view.local_part(1, part, mode=mode)
    np.testing.assert_array_equal(lp, ref_view.local_part(1, part, mode=mode))
    lo, hi = plan.block(1)
    np.testing.assert_array_equal(lp[lo:hi], part[lo:hi])
    halo = view.halo(1, mode=mode)
    np.testing.assert_array_equal(lp[halo], part[halo])
    covered = np.zeros(120, dtype=bool)
    covered[lo:hi] = True
    covered[halo] = True
    assert (lp[~covered] == -1).all()


@pytest.mark.parametrize("num_shards", [1, 2, 3, 5])
def test_comm_volume_sharded_matches_global(num_shards):
    ref_g = random_hypergraph(150, 900, seed=3)
    g = interop.graph_from(ref_g)
    part = feasible_part(150, 7, seed=4)
    plan = plan_vertex_shards(150, num_shards, **CPU)
    got = comm_volume_sharded(g.hyper, part, plan)
    assert got == comm_volume(g.hyper, part)
    assert got == ref_comm_volume_sharded(
        ref_g.hyper, part, ref_plan_vertex_shards(150, num_shards, False))


# ----------------------------------------------------- sharded refinement


@pytest.mark.parametrize("objective", ["cut", "volume"])
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_refine_bitwise_parity(objective, shards):
    """Sharding only reschedules evaluation: identical movers, identical
    score, identical partition — for any shard count, and the reference's."""
    ref_g = fanout_snn_graph(600, fan=6, seed=5)
    g = interop.graph_from(ref_g)
    part = feasible_part(600, 10, seed=6)
    kw = dict(k=10, capacity=80, objective=objective)
    base_part, base_score = refine_level_vec(g, part, **kw, **CPU)
    got_part, got_score = refine_level_vec(g, part, shards=shards, **kw, **CPU)
    want_part, want_score = ref_refine_level_vec(ref_g, part, shards=shards,
                                                 **kw)
    assert got_score == base_score == want_score
    np.testing.assert_array_equal(got_part, base_part)
    np.testing.assert_array_equal(got_part, want_part)


@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_sharded_refine_builds_no_kernel_state(objective, monkeypatch):
    """A sharded level refines on the host even when the kernel is asked
    for: no dense adjacency, incidence or Φ is built or
    uploaded, and the result is the unsharded numpy path's."""
    ref_g = fanout_snn_graph(600, fan=6, seed=5)
    g = interop.graph_from(ref_g)
    part = feasible_part(600, 10, seed=6)
    kw = dict(k=10, capacity=80, objective=objective)
    want = refine_level_vec(g, part, use_kernel=False, **kw, **CPU)

    def refuse(*args, **kwargs):
        raise AssertionError("a sharded level built the kernel path")

    for name in ("_dense_adjacency", "_dense_incidence", "_degrees_via_kernel",
                 "_volume_degrees_via_kernel", "_VolumeKernelState"):
        monkeypatch.setattr(refine_vec, name, refuse)
    got = refine_level_vec(g, part, use_kernel=True, shards=2, **kw, **CPU)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


def test_sharded_refine_takes_a_plan():
    g = interop.graph_from(fanout_snn_graph(600, fan=6, seed=5))
    part = feasible_part(600, 10, seed=6)
    kw = dict(k=10, capacity=80, objective="volume", **CPU)
    plan = VertexShardPlan(bounds=np.array([0, 100, 450, 600], dtype=np.int64))
    got = refine_level_vec(g, part, shards=plan, **kw)
    want = refine_level_vec(g, part, **kw)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])


def test_fat_round_gains_exactly_additive():
    """The incremental score (sum of batch gains) must equal a from-scratch
    recount — any non-additive admission inside a fat conflict round would
    diverge here."""
    ref_g = fanout_snn_graph(800, fan=8, seed=7)
    g = interop.graph_from(ref_g)
    part = feasible_part(800, 12, seed=8)
    kw = dict(k=12, capacity=100, objective="volume")
    new_part, score = refine_level_vec(g, part, **kw, **CPU)
    assert score == comm_volume(g.hyper, new_part)
    assert score <= comm_volume(g.hyper, part)
    want_part, want_score = ref_refine_level_vec(ref_g, part, **kw)
    assert score == want_score
    np.testing.assert_array_equal(new_part, want_part)


def test_apply_moves_merges_shared_slots():
    """Two movers sharing a hyperedge and a destination column touch the
    same (edge, column) slot; the batched phi update must merge the +-1s
    instead of letting one overwrite the other."""
    ref_g = fanout_snn_graph(60, fan=6, seed=9)
    g = interop.graph_from(ref_g)
    part = feasible_part(60, 4, seed=10)
    st = VolumeState(g, part, 4)
    ref_st = RefVolumeState(ref_g, part, 4)
    movers = np.arange(10, dtype=np.int64)
    prev = part[movers].copy()
    dest = (prev + 1) % 4
    st.apply_moves(movers, prev, dest)
    ref_st.apply_moves(movers, prev, dest)
    part2 = part.copy()
    part2[movers] = dest
    np.testing.assert_array_equal(st.phi, edge_partition_counts(g.hyper, part2, 4))
    np.testing.assert_array_equal(st.phi, ref_st.phi)


# ------------------------------------------------------- sharded matching


def test_sharded_matching_shard_count_invariant():
    ref_g = fanout_snn_graph(500, fan=5, seed=11)
    g = interop.graph_from(ref_g)
    ms = []
    for s in (1, 2, 3, 8):
        m = heavy_edge_matching_vec(g, np.random.default_rng(12), max_vwgt=20,
                                    shards=s)
        want = ref_coarsen.heavy_edge_matching_vec(
            ref_g, np.random.default_rng(12), max_vwgt=20, shards=s)
        np.testing.assert_array_equal(m, want)
        ms.append(m)
    for m in ms[1:]:
        np.testing.assert_array_equal(ms[0], m)
    m = ms[0]
    v = np.arange(500)
    np.testing.assert_array_equal(m[m], v)  # involution: partner's partner is me
    paired = m != v
    assert (g.vwgt[v[paired]] + g.vwgt[m[paired]] <= 20).all()


def test_sharded_coarsen_levels_match_any_shard_count():
    ref_g = fanout_snn_graph(700, fan=5, seed=13)
    g = interop.graph_from(ref_g)
    kw = dict(coarsen_to=100, max_vwgt=20, impl="vec")
    l2 = coarsen(g, np.random.default_rng(1), shards=2, **kw)
    l5 = coarsen(g, np.random.default_rng(1), shards=5, **kw)
    _same_levels(l2, l5)
    _same_levels(l2, ref_coarsen.coarsen(ref_g, np.random.default_rng(1),
                                         shards=5, **kw))


# ------------------------------------------------------------ out-of-core


def test_levelstore_roundtrip_and_cleanup():
    ref_g = fanout_snn_graph(400, fan=5, seed=14)
    g = interop.graph_from(ref_g)
    kw = dict(coarsen_to=60, max_vwgt=20, impl="vec", shards=2)
    mem = coarsen(g, np.random.default_rng(2), **kw)
    store = LevelStore()
    spill = coarsen(g, np.random.default_rng(2), store=store, **kw)
    assert spill is store
    _same_levels(mem, store)
    _same_levels(mem, ref_coarsen.coarsen(ref_g, np.random.default_rng(2), **kw))
    for i in range(len(mem)):
        a, b = mem[i], store[i]
        assert (a.hyper is None) == (b.hyper is None)
        if a.hyper is not None:
            np.testing.assert_array_equal(a.hyper.hpins, b.hyper.hpins)
            np.testing.assert_array_equal(a.hyper.hfire, b.hyper.hfire)
            assert comm_volume(a.hyper, feasible_part(a.num_vertices, 4)) == \
                comm_volume(b.hyper, feasible_part(b.num_vertices, 4))
    assert len(store._cache) <= LevelStore._CACHE_SLOTS
    path = store._dir
    store.close()
    assert not os.path.exists(path)


def test_stream_levels_matches_in_memory():
    ref_g = fanout_snn_graph(1500, fan=6, seed=15)
    g = interop.graph_from(ref_g)
    kw = dict(capacity=64, seed=0, impl="vec", objective="volume", shards=2)
    in_mem = sneap_partition(g, hyper=g.hyper, **kw, **CPU)
    streamed = sneap_partition(g, hyper=g.hyper, stream_levels=True, **kw,
                               **CPU)
    np.testing.assert_array_equal(in_mem.part, streamed.part)
    assert in_mem.comm_volume == streamed.comm_volume
    assert in_mem.num_levels == streamed.num_levels


# ---------------------------------------------- partitions vs the reference


@pytest.fixture(scope="module")
def fanout_1200():
    return fanout_snn_graph(1200, fan=6, seed=17)


@pytest.fixture(scope="module")
def ref_sharded(fanout_1200):
    """The reference's sharded partitions of fanout_1200, by objective and
    shard count."""
    return {(obj, s): ref_sneap_partition(fanout_1200, capacity=48, seed=0,
                                          impl="vec", objective=obj, shards=s)
            for obj in ("cut", "volume") for s in (2, 4)}


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_sneap_partition_sharded_matches_reference(fanout_1200, ref_sharded,
                                                   objective, shards, stream):
    want = ref_sharded[(objective, shards)]
    got = sneap_partition(interop.graph_from(fanout_1200), capacity=48, seed=0,
                          impl="vec", objective=objective, shards=shards,
                          stream_levels=stream, **CPU)
    np.testing.assert_array_equal(got.part, want.part)
    assert (got.k, got.edge_cut, got.comm_volume, got.num_levels) == (
        want.k, want.edge_cut, want.comm_volume, want.num_levels)


def test_shard_counts_agree_and_differ_from_single_host(fanout_1200):
    """Any shard count >= 1 gives one partition; ``shards=None`` keeps the
    single-host rng matching, whose tie keys differ, so its partition is
    another one (within the reference's 5% quality bound)."""
    g = interop.graph_from(fanout_1200)
    kw = dict(capacity=48, seed=0, impl="vec", objective="cut", **CPU)
    one, three = (sneap_partition(g, shards=s, **kw) for s in (1, 3))
    single = sneap_partition(g, **kw)
    np.testing.assert_array_equal(one.part, three.part)
    assert not np.array_equal(one.part, single.part)
    assert abs(one.edge_cut - single.edge_cut) <= 0.05 * single.edge_cut


# ------------------------------------------------------------- end to end


def test_end_to_end_sharded_quality_within_5pct():
    """Sharded coarsening draws different (hash) tie keys than the
    single-host rng stream, so the partitions differ — quality must not:
    the reference's acceptance bound is 5% comm_volume drift."""
    g = interop.graph_from(fanout_snn_graph(4000, fan=8, seed=16))
    kw = dict(capacity=64, seed=0, impl="vec", objective="volume",
              hyper=g.hyper, **CPU)
    single = sneap_partition(g, **kw)
    two = sneap_partition(g, shards=2, **kw)
    four = sneap_partition(g, shards=4, **kw)
    np.testing.assert_array_equal(two.part, four.part)  # shard-count invariance
    drift = abs(two.comm_volume - single.comm_volume) / single.comm_volume
    assert drift <= 0.05, f"sharded comm_volume drifted {drift:.1%}"


# ----------------------------------------------------- index-dtype audit


def test_index_capacity_vertex_overflow_raises():
    with pytest.raises(IndexCapacityError, match="int32"):
        check_index_capacity(2**31 + 10)


def test_index_capacity_packed_key_overflow_raises():
    # n fits int32 but n*k packed keys overflow int64: shape math only.
    with pytest.raises(IndexCapacityError):
        check_index_capacity(2**31 - 10, k=2**33)
    with pytest.raises(IndexCapacityError):
        check_index_capacity(1000, num_hyperedges=2**31 - 10, k=2**33)


def test_index_capacity_build_graph_guard_fires_before_allocating():
    # >2^31 vertices must fail fast at the boundary — if this ever
    # allocated, the test machine would notice.
    with pytest.raises(IndexCapacityError):
        build_graph(2**31 + 5, np.empty(0, np.int64), np.empty(0, np.int64),
                    np.empty(0, np.int64))


def test_index_capacity_ok_at_realistic_scale():
    check_index_capacity(10**6, num_hyperedges=10**6, k=4096)
