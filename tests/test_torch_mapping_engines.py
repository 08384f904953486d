"""tests/test_mapping_engines.py held against the port on the CPU: the
pairwise and tree-hop objectives' incremental deltas (scalar and batch)
and their member aggregates after swap sequences, the closed-form tree
sizes against the replay's tree links, scalar vs batched SA, the swap
delta kernel's scorer (its plain version on CPU tensors), the registry
and the shared evaluator, and the toolchain's tree placement.  Every
delta, aggregate table, placement, SA history cost and NoCStats field is
also held bitwise to the reference's on the same inputs; the kernel
scorer's f32 deltas to the reference test's rtol 1e-4 / atol 1e-3."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hopcost as ref_hopcost  # noqa: E402
from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core import placecost as ref_placecost  # noqa: E402
from repro.core.graph import build_hypergraph as ref_build_hypergraph  # noqa: E402
from repro.kernels.swap_delta import swap_deltas_pairs as ref_swap_deltas_pairs  # noqa: E402
from repro.nocsim import xy as ref_xy  # noqa: E402
from torch_parity import assert_mapping_equal, pair, profiles, simulate, toolchain  # noqa: E402

from repro_torch.core.graph import build_hypergraph  # noqa: E402
from repro_torch.core.hopcost import hop_distance_matrix, swap_delta_batch, traffic_matrix  # noqa: E402
from repro_torch.core.mapping import (  # noqa: E402
    DEVICE_MAPPERS,
    MAPPERS,
    OBJECTIVE_AWARE_MAPPERS,
    sa_search,
    tabu_search,
)
from repro_torch.core.placecost import (  # noqa: E402
    PairwiseObjective,
    TreeHopObjective,
    evaluate_placement,
    make_objective,
)
from repro_torch.kernels.swap_delta import swap_deltas_pairs  # noqa: E402


def _pairwise_instance(k=20, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 200, (k, k)).astype(np.float64)
    np.fill_diagonal(c, 0)
    return c, int(c.sum())


def _tree_instance(n=120, fan=8, k=12, cores=16, mesh_w=4, seed=0):
    """Fan-out SNN + random partition: (graph, part, port objective,
    reference objective on the same hypergraph)."""
    ref, g = pair("fanout_snn_graph", n, fan=fan, seed=seed)
    rng = np.random.default_rng(seed + 1)
    part = rng.integers(0, k, n)
    obj = TreeHopObjective(g.hyper, part, cores, mesh_w, cores // mesh_w)
    ref_obj = ref_placecost.TreeHopObjective(ref.hyper, part, cores, mesh_w,
                                             cores // mesh_w)
    return g, part, obj, ref_obj


def _run(mapper_fn, ref_fn, *args, ref_objective=None, **kw):
    """A port search (on the CPU) and the reference's, bitwise equal; the
    reference searches its own objective where the port's is given."""
    ref_kw = dict(kw)
    if ref_objective is not None:
        ref_kw["objective"] = ref_objective
    got = mapper_fn(*args, device="cpu", **kw)
    assert_mapping_equal(got, ref_fn(*args, **ref_kw))
    return got


# ---------------------------------------------------------------------------
# Incremental deltas: exact against full recompute.

def test_pairwise_batch_delta_matches_scalar_formula():
    """Counterpart of test_mapping_engines.py::test_pairwise_batch_delta_matches_scalar_formula."""
    c, _ = _pairwise_instance()
    rng = np.random.default_rng(3)
    obj = PairwiseObjective(c, 25, 5)
    ref_obj = ref_placecost.PairwiseObjective(c, 25, 5)
    placement = rng.permutation(25).astype(np.int64)
    obj.attach(placement)
    ref_obj.attach(placement.copy())
    aa = rng.integers(0, 25, 200)
    b0 = rng.integers(0, 24, 200)
    bb = np.where(b0 >= aa, b0 + 1, b0)
    dist = hop_distance_matrix(25, 5).astype(np.float64)
    ref = swap_delta_batch(obj.sym, obj._placement, dist, aa, bb)
    batch = obj.swap_delta_batch(aa, bb)
    np.testing.assert_allclose(batch, ref, atol=1e-9)
    np.testing.assert_array_equal(batch, ref_obj.swap_delta_batch(aa, bb))
    np.testing.assert_array_equal(ref, ref_hopcost.swap_delta_batch(
        ref_obj.sym, ref_obj._placement, dist, aa, bb))
    for a, b in zip(aa[:20], bb[:20]):
        p2 = obj._placement.copy()
        p2[a], p2[b] = p2[b], p2[a]
        d = obj.swap_delta(int(a), int(b))
        assert d == ref_obj.swap_delta(int(a), int(b))
        np.testing.assert_allclose(
            d, obj.total(p2) - obj.total(obj._placement), atol=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_swap_delta_exact_against_recompute(seed):
    """Counterpart of test_mapping_engines.py::test_tree_swap_delta_exact_against_recompute."""
    _, _, obj, ref_obj = _tree_instance(seed=seed)
    rng = np.random.default_rng(seed)
    placement = rng.permutation(16).astype(np.int64)
    obj.attach(placement)
    ref_obj.attach(placement.copy())
    for _ in range(40):
        a, b = rng.choice(16, 2, replace=False)
        delta = obj.swap_delta(int(a), int(b))
        assert delta == ref_obj.swap_delta(int(a), int(b))
        p2 = placement.copy()
        p2[a], p2[b] = p2[b], p2[a]
        np.testing.assert_allclose(
            delta, obj.total(p2) - obj.total(placement), atol=1e-9)


def test_tree_batch_delta_matches_scalar():
    """Counterpart of test_mapping_engines.py::test_tree_batch_delta_matches_scalar."""
    _, _, obj, ref_obj = _tree_instance(seed=4)
    rng = np.random.default_rng(7)
    placement = rng.permutation(16).astype(np.int64)
    obj.attach(placement)
    ref_obj.attach(placement.copy())
    aa = rng.integers(0, 16, 96)
    b0 = rng.integers(0, 15, 96)
    bb = np.where(b0 >= aa, b0 + 1, b0)
    batch = obj.swap_delta_batch(aa, bb)
    np.testing.assert_array_equal(batch, ref_obj.swap_delta_batch(aa, bb))
    scalar = np.array([obj.swap_delta(int(a), int(b)) for a, b in zip(aa, bb)])
    np.testing.assert_allclose(batch, scalar, atol=1e-9)


@pytest.mark.parametrize("objective", ["pairwise", "tree"])
def test_apply_swaps_keeps_exact_total(objective):
    """Counterpart of test_mapping_engines.py::test_apply_swaps_keeps_exact_total."""
    rng = np.random.default_rng(5)
    if objective == "pairwise":
        c, _ = _pairwise_instance(seed=5)
        obj = PairwiseObjective(c, 25, 5)
        ref_obj = ref_placecost.PairwiseObjective(c, 25, 5)
        nc = 25
    else:
        _, _, obj, ref_obj = _tree_instance(seed=5)
        nc = 16
    placement = rng.permutation(nc).astype(np.int64)
    ref_placement = placement.copy()
    obj.attach(placement)
    ref_obj.attach(ref_placement)
    for m in (1, 3, 6):
        pos = rng.choice(nc, 2 * m, replace=False)
        total = obj.apply_swaps(pos.reshape(m, 2))
        assert total == ref_obj.apply_swaps(pos.reshape(m, 2))
        np.testing.assert_array_equal(placement, ref_placement)
        np.testing.assert_allclose(total, obj.total(placement), atol=1e-9)


# ---------------------------------------------------------------------------
# Member-level aggregates.

_AGG_TABLES = ("_cnt", "_rmin1", "_rmin2", "_rmax1", "_rmax2",
               "_cmin1", "_cmin2", "_cmax1", "_cmax2",
               "_hsp", "_vsp", "_srcx", "_srcy")


def _assert_aggregates_match_scratch(obj, hyper, part, ref_obj=None):
    """Synced tables, size cache and total == a fresh attach + sync, and
    == the reference objective's after the same swaps, bitwise."""
    obj._agg_sync()
    fresh = TreeHopObjective(hyper, part, obj.num_positions, obj.mesh_w,
                             obj.mesh_h)
    fresh.attach(obj._placement.copy())
    fresh._agg_sync()
    others = [fresh]
    if ref_obj is not None:
        ref_obj._agg_sync()
        others.append(ref_obj)
    for other in others:
        for name in _AGG_TABLES:
            np.testing.assert_array_equal(
                getattr(obj, name), getattr(other, name), err_msg=name)
        np.testing.assert_array_equal(obj._sizes, other._sizes)
        assert obj._total == other._total


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tree_aggregates_match_scratch_after_swap_sequences(seed):
    """Counterpart of test_mapping_engines.py::test_tree_aggregates_match_scratch_after_swap_sequences."""
    g, part, obj, ref_obj = _tree_instance(seed=seed)
    rng = np.random.default_rng(100 + seed)
    placement = rng.permutation(16).astype(np.int64)
    obj.attach(placement)
    ref_obj.attach(placement.copy())
    for step in range(24):
        if rng.random() < 0.5:
            a, b = rng.choice(16, 2, replace=False)
            d = obj.swap_delta(int(a), int(b))
            assert d == ref_obj.swap_delta(int(a), int(b))
            obj.apply_swaps(np.array([[a, b]]), total_delta=d)
            ref_obj.apply_swaps(np.array([[a, b]]), total_delta=d)
        else:
            m = int(rng.integers(1, 4))
            pos = rng.choice(16, 2 * m, replace=False)
            np.testing.assert_array_equal(
                obj.swap_delta_batch(pos[:m], pos[m:]),
                ref_obj.swap_delta_batch(pos[:m], pos[m:]))
            obj.apply_swaps(np.column_stack([pos[:m], pos[m:]]))
            ref_obj.apply_swaps(np.column_stack([pos[:m], pos[m:]]))
        if step % 6 == 5:
            _assert_aggregates_match_scratch(obj, g.hyper, part, ref_obj)
    _assert_aggregates_match_scratch(obj, g.hyper, part, ref_obj)


def _hyper_pair(n, src, dst, fire):
    return (ref_build_hypergraph(n, src, dst, fire),
            build_hypergraph(n, src, dst, fire))


def test_tree_aggregates_directed_move_cases():
    """Counterpart of test_mapping_engines.py::test_tree_aggregates_directed_move_cases."""
    n = 13
    src = np.array([0, 0, 0, 4, 4])
    dst = np.array([1, 2, 3, 8, 12])
    fire = np.zeros(n, dtype=np.int64)
    fire[0], fire[4] = 3, 5
    ref_hyper, hyper = _hyper_pair(n, src, dst, fire)
    part = np.arange(n, dtype=np.int64)
    obj = TreeHopObjective(hyper, part, 16, 4, 4)
    ref_obj = ref_placecost.TreeHopObjective(ref_hyper, part, 16, 4, 4)
    obj.attach(np.arange(16, dtype=np.int64))
    ref_obj.attach(np.arange(16, dtype=np.int64))
    obj.swap_delta_batch(np.array([0]), np.array([1]))
    ref_obj.swap_delta_batch(np.array([0]), np.array([1]))
    for a, b in [(3, 15), (2, 13), (12, 5), (0, 10), (4, 3), (8, 12)]:
        before = obj.total(obj._placement)
        p2 = obj._placement.copy()
        p2[a], p2[b] = p2[b], p2[a]
        want = obj.total(p2) - before
        got_batch = obj.swap_delta_batch(np.array([a]), np.array([b]))[0]
        got_scalar = obj.swap_delta(a, b)
        assert got_scalar == want
        assert got_batch == want
        assert got_batch == ref_obj.swap_delta_batch(np.array([a]), np.array([b]))[0]
        assert got_scalar == ref_obj.swap_delta(a, b)
        obj.apply_swaps(np.array([[a, b]]), total_delta=got_scalar)
        ref_obj.apply_swaps(np.array([[a, b]]), total_delta=got_scalar)
        _assert_aggregates_match_scratch(obj, hyper, part, ref_obj)


def test_tree_dedup_merges_congruent_patterns_and_stays_exact():
    """Counterpart of test_mapping_engines.py::test_tree_dedup_merges_congruent_patterns_and_stays_exact."""
    n = 8
    src = np.array([0, 0, 1, 1, 6, 6])
    dst = np.array([2, 3, 2, 3, 4, 5])
    fire = np.array([3, 5, 1, 1, 1, 1, 2, 1], dtype=np.int64)
    ref_hyper, hyper = _hyper_pair(n, src, dst, fire)
    part = np.array([0, 0, 1, 2, 3, 4, 5, 5], dtype=np.int64)
    obj = TreeHopObjective(hyper, part, 9, 3, 3)
    ref_obj = ref_placecost.TreeHopObjective(ref_hyper, part, 9, 3, 3)
    assert obj.num_hyperedges == 2
    assert obj.tw.sum() == fire[0] + fire[1] + fire[6]
    np.testing.assert_array_equal(obj.tw, ref_obj.tw)
    rng = np.random.default_rng(11)
    placement = rng.permutation(9).astype(np.int64)
    obj.attach(placement)
    ref_obj.attach(placement.copy())
    for _ in range(12):
        a, b = rng.choice(9, 2, replace=False)
        p2 = obj._placement.copy()
        p2[a], p2[b] = p2[b], p2[a]
        want = obj.total(p2) - obj.total(obj._placement)
        assert obj.swap_delta_batch(np.array([a]), np.array([b]))[0] == want
        d = obj.swap_delta(int(a), int(b))
        assert d == want == ref_obj.swap_delta(int(a), int(b))
        obj.apply_swaps(np.array([[a, b]]), total_delta=d)
        ref_obj.apply_swaps(np.array([[a, b]]), total_delta=d)
    _assert_aggregates_match_scratch(obj, hyper, part, ref_obj)


@pytest.mark.parametrize("seed", [0, 1])
def test_tree_batch_delta_bitwise_equals_scalar(seed):
    """Counterpart of test_mapping_engines.py::test_tree_batch_delta_bitwise_equals_scalar."""
    _, _, obj, ref_obj = _tree_instance(seed=seed)
    rng = np.random.default_rng(30 + seed)
    placement = rng.permutation(16).astype(np.int64)
    obj.attach(placement)
    ref_obj.attach(placement.copy())
    for _ in range(4):
        aa = rng.integers(0, 16, 64)
        b0 = rng.integers(0, 15, 64)
        bb = np.where(b0 >= aa, b0 + 1, b0)
        batch = obj.swap_delta_batch(aa, bb)
        np.testing.assert_array_equal(batch, ref_obj.swap_delta_batch(aa, bb))
        for i in range(64):
            assert batch[i] == obj.swap_delta(int(aa[i]), int(bb[i]))
        pos = rng.choice(16, 6, replace=False)
        obj.apply_swaps(pos.reshape(3, 2))
        ref_obj.apply_swaps(pos.reshape(3, 2))


def test_tree_scalar_chain_never_builds_aggregates():
    """Counterpart of test_mapping_engines.py::test_tree_scalar_chain_never_builds_aggregates."""
    _, _, obj, ref_obj = _tree_instance(seed=6)
    rng = np.random.default_rng(6)
    placement = rng.permutation(16).astype(np.int64)
    obj.attach(placement)
    ref_obj.attach(placement.copy())
    for _ in range(10):
        a, b = rng.choice(16, 2, replace=False)
        d = obj.swap_delta(int(a), int(b))
        assert d == ref_obj.swap_delta(int(a), int(b))
        obj.apply_swaps(np.array([[a, b]]), total_delta=d)
        ref_obj.apply_swaps(np.array([[a, b]]), total_delta=d)
    assert obj._cnt is None
    assert obj._total == ref_obj._total


# ---------------------------------------------------------------------------
# Tree objective == replay tree-link accounting.

def test_closed_form_tree_sizes_match_route_expansion():
    """Counterpart of test_mapping_engines.py::test_closed_form_tree_sizes_match_route_expansion."""
    from repro_torch.nocsim.xy import multicast_tree_links, multicast_tree_sizes

    rng = np.random.default_rng(0)
    for _ in range(150):
        w = int(rng.integers(2, 17))
        h = int(rng.integers(2, 17))
        ng = int(rng.integers(1, 24))
        m = int(rng.integers(1, 80))
        grp = np.sort(rng.integers(0, ng, m))
        gsrc = rng.integers(0, w * h, ng)
        src, dst = gsrc[grp], rng.integers(0, w * h, m)
        _, gid = multicast_tree_links(src, dst, grp, w, h)
        ref = np.bincount(gid, minlength=ng)
        got = multicast_tree_sizes(src, dst, grp, w, h, ng)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            got, ref_xy.multicast_tree_sizes(src, dst, grp, w, h, ng))


def test_tree_total_equals_replay_link_traversals():
    """Counterpart of test_mapping_engines.py::test_tree_total_equals_replay_link_traversals."""
    n, fan, k, w, h = 150, 6, 10, 4, 4
    rng = np.random.default_rng(11)
    src_syn = np.repeat(np.arange(n), fan)
    dst_syn = rng.integers(0, n, n * fan)
    fire = rng.integers(0, 15, n)
    ref_hyper, hyper = _hyper_pair(n, src_syn, dst_syn, fire)
    part = rng.integers(0, k, n)
    placement = rng.permutation(w * h).astype(np.int64)[: k]
    tt, ts, td = [], [], []
    for i in range(n):
        tgt = dst_syn[src_syn == i]
        for t in range(fire[i]):
            tt.append(np.full(tgt.shape[0], t))
            ts.append(np.full(tgt.shape[0], i))
            td.append(tgt)
    tt, ts, td = map(np.concatenate, (tt, ts, td))
    obj = TreeHopObjective(hyper, part, w * h, w, h)
    ref_obj = ref_placecost.TreeHopObjective(ref_hyper, part, w * h, w, h)
    full_place = np.concatenate(
        [placement, np.setdiff1d(np.arange(w * h), placement)])
    assert obj.total(full_place) == ref_obj.total(full_place)
    stats = simulate(tt, ts, td, part, placement, w, h, mode="analytic",
                     cast="multicast")
    assert int(round(obj.total(full_place))) == stats.link_traversals
    assert int(stats.per_link_hops.sum()) == stats.link_traversals
    queued = simulate(tt, ts, td, part, placement, w, h, mode="queued",
                      cast="multicast")
    assert queued.link_traversals == stats.link_traversals


# ---------------------------------------------------------------------------
# Scalar vs batched SA engines.

@pytest.mark.parametrize("objective", ["pairwise", "tree"])
def test_batched_sa_quality_matches_scalar(objective):
    """Counterpart of test_mapping_engines.py::test_batched_sa_quality_matches_scalar."""
    tol_each, wins_needed = 1.10, 2
    ok = 0
    for seed in range(3):
        if objective == "pairwise":
            c, tl = _pairwise_instance(k=20, seed=seed)
            objs = [(None, None), (None, None)]
            nc, w = 25, 5
        else:
            c = np.zeros((12, 12))
            objs = [_tree_instance(seed=seed)[2:] for _ in range(2)]
            tl = max(int(objs[0][0].tw.sum()), 1)
            nc, w = 16, 4
        scalar = _run(sa_search, ref_mapping.sa_search, c, nc, w, tl, seed=seed,
                      iters=8000, objective=objs[0][0], ref_objective=objs[0][1])
        vec = _run(sa_search, ref_mapping.sa_search, c, nc, w, tl, seed=seed,
                   iters=8000, impl="vec", batch=32, objective=objs[1][0],
                   ref_objective=objs[1][1])
        s_cost = scalar.tree_hop if objective == "tree" else scalar.avg_hop
        v_cost = vec.tree_hop if objective == "tree" else vec.avg_hop
        if v_cost <= s_cost * tol_each + 1e-9:
            ok += 1
        assert len(set(vec.placement.tolist())) == vec.placement.shape[0]
    assert ok >= wins_needed, f"batched SA quality off on {3 - ok}/3 seeds"


def test_batched_sa_deterministic():
    """Counterpart of test_mapping_engines.py::test_batched_sa_deterministic."""
    c, tl = _pairwise_instance(seed=2)
    kw = dict(seed=7, iters=4000, impl="vec", batch=32)
    a = _run(sa_search, ref_mapping.sa_search, c, 25, 5, tl, **kw)
    b = sa_search(c, 25, 5, tl, device="cpu", **kw)
    assert np.array_equal(a.placement, b.placement)
    assert a.avg_hop == b.avg_hop


def test_batched_sa_records_objective_units():
    """Counterpart of test_mapping_engines.py::test_batched_sa_records_objective_units."""
    c, tl = _pairwise_instance()
    r = _run(sa_search, ref_mapping.sa_search, c, 25, 5, tl, seed=0, iters=2000,
             impl="vec")
    assert r.objective == "pairwise" and r.tree_hop is None
    _, _, obj, ref_obj = _tree_instance(seed=1)
    c12 = np.zeros((12, 12))
    rt = _run(sa_search, ref_mapping.sa_search, c12, 16, 4, 100, seed=0,
              iters=2000, objective=obj, ref_objective=ref_obj)
    assert rt.objective == "tree"
    assert rt.tree_hop is not None
    np.testing.assert_allclose(rt.history[-1][1], rt.tree_hop, rtol=1e-9)


def test_kernel_score_backend_matches_numpy_deltas():
    """Counterpart of test_mapping_engines.py::test_kernel_score_backend_matches_numpy_deltas:
    the port's swap_deltas wrapper on CPU tensors (the kernel's plain
    version) against the numpy batch and the reference's jnp scorer."""
    c, _ = _pairwise_instance(k=15, seed=3)
    rng = np.random.default_rng(0)
    nc, w = 25, 5
    obj = PairwiseObjective(c, nc, w)
    placement = rng.permutation(nc).astype(np.int64)
    obj.attach(placement)
    aa = rng.integers(0, nc, 64)
    b0 = rng.integers(0, nc - 1, 64)
    bb = np.where(b0 >= aa, b0 + 1, b0)
    ref = obj.swap_delta_batch(aa, bb)
    x = (np.arange(nc) % w).astype(np.float32)
    y = (np.arange(nc) // w).astype(np.float32)
    got = swap_deltas_pairs(
        torch.tensor(obj.sym, dtype=torch.float32),
        torch.from_numpy(x[placement]), torch.from_numpy(y[placement]),
        torch.from_numpy(aa), torch.from_numpy(bb)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    want = np.asarray(ref_swap_deltas_pairs(
        jnp.asarray(obj.sym, jnp.float32),
        jnp.asarray(x[placement]), jnp.asarray(y[placement]),
        aa, bb, backend="jnp"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_vec_sa_with_kernel_scoring_runs():
    """Counterpart of test_mapping_engines.py::test_vec_sa_with_kernel_scoring_runs:
    ``score_backend="auto"`` on the CPU (the kernel's plain version); on
    this integer traffic its f32 deltas are exact, so the search commits
    the swaps of the numpy scorer and of the reference's jnp scorer."""
    c, tl = _pairwise_instance(seed=6)
    kw = dict(seed=0, iters=1500, impl="vec", batch=32)
    r = sa_search(c, 25, 5, tl, score_backend="auto", device="cpu", **kw)
    assert len(set(r.placement.tolist())) == 20
    assert_mapping_equal(r, ref_mapping.sa_search(c, 25, 5, tl,
                                                  score_backend="jnp", **kw))
    assert_mapping_equal(r, sa_search(c, 25, 5, tl, device="cpu", **kw))
    _, _, obj, _ = _tree_instance(seed=2)
    with pytest.raises(ValueError, match="pairwise"):
        sa_search(np.zeros((12, 12)), 16, 4, 10, iters=100, impl="vec",
                  objective=obj, score_backend="auto", device="cpu")


# ---------------------------------------------------------------------------
# Tree-objective searches.

def test_tree_objective_search_lowers_tree_cost():
    """Counterpart of test_mapping_engines.py::test_tree_objective_search_lowers_tree_cost."""
    g, part, obj, ref_obj = _tree_instance(n=200, fan=10, k=14, seed=9)
    c = np.zeros((14, 14))
    rng = np.random.default_rng(0)
    rand_costs = []
    for _ in range(10):
        rand_costs.append(obj.total(rng.permutation(16).astype(np.int64)))
    res = _run(sa_search, ref_mapping.sa_search, c, 16, 4, 1, seed=0,
               iters=6000, objective=obj, ref_objective=ref_obj)
    assert res.tree_hop < np.mean(rand_costs)


def test_tabu_accepts_tree_objective():
    """Counterpart of test_mapping_engines.py::test_tabu_accepts_tree_objective."""
    _, _, obj, ref_obj = _tree_instance(seed=3)
    c = np.zeros((12, 12))
    kw = dict(seed=0, iters=40, candidates=48)
    res = tabu_search(c, 16, 4, 1, objective=obj, **kw)
    assert_mapping_equal(res, ref_mapping.tabu_search(c, 16, 4, 1,
                                                      objective=ref_obj, **kw))
    assert res.objective == "tree" and res.tree_hop is not None
    assert len(set(res.placement.tolist())) == 12


# ---------------------------------------------------------------------------
# Registry and pipeline integration.

def test_registry_unifies_host_and_device_mappers():
    """Counterpart of test_mapping_engines.py::test_registry_unifies_host_and_device_mappers."""
    assert set(MAPPERS) == {"sa", "pso", "tabu", "sa_jax", "polish", "island"}
    assert OBJECTIVE_AWARE_MAPPERS == {"sa", "pso", "tabu"}
    assert set(MAPPERS) == set(ref_mapping.MAPPERS)
    assert OBJECTIVE_AWARE_MAPPERS == ref_mapping.OBJECTIVE_AWARE_MAPPERS
    assert DEVICE_MAPPERS <= set(MAPPERS)


def test_polish_registry_entry_runs():
    """Counterpart of test_mapping_engines.py::test_polish_registry_entry_runs:
    the port's polish on the CPU, bitwise the reference's jnp polish."""
    c, tl = _pairwise_instance(k=12, seed=1)
    res = MAPPERS["polish"](c, 16, 4, tl, seed=0, device="cpu")
    want = ref_mapping.MAPPERS["polish"](c, 16, 4, tl, seed=0, backend="jnp")
    np.testing.assert_array_equal(res.placement, want.placement)
    assert (res.avg_hop, res.history, res.evaluations) == (
        want.avg_hop, want.history, want.evaluations)
    assert len(set(res.placement.tolist())) == 12
    rng = np.random.default_rng(1)
    rand = np.mean([
        PairwiseObjective(c, 16, 4).total(rng.permutation(16)) / tl
        for _ in range(10)
    ])
    assert res.avg_hop <= rand


def test_evaluate_placement_shared_path():
    """Counterpart of test_mapping_engines.py::test_evaluate_placement_shared_path."""
    g, part, obj, ref_obj = _tree_instance(seed=8)
    rng = np.random.default_rng(2)
    tsrc = rng.integers(0, 120, 500)
    tdst = rng.integers(0, 120, 500)
    traffic = traffic_matrix(part, tsrc, tdst, 12)
    placement = rng.permutation(16).astype(np.int64)[:12]
    kw = dict(mesh_h=4, part=part)
    avg, tree = evaluate_placement(placement, traffic, 16, 4, 500,
                                   hyper=g.hyper, **kw)
    ref_g = pair("fanout_snn_graph", 120, fan=8, seed=8)[0]
    want = ref_placecost.evaluate_placement(placement, traffic, 16, 4, 500,
                                            hyper=ref_g.hyper, **kw)
    assert (avg, tree) == want
    dist = hop_distance_matrix(16, 4)
    by_hand = float(
        (dist[placement[:, None], placement[None, :]] * traffic).sum() / 500)
    np.testing.assert_allclose(avg, by_hand, rtol=1e-12)
    full = np.concatenate([placement, np.setdiff1d(np.arange(16), placement)])
    np.testing.assert_allclose(tree, obj.total(full) / 500, rtol=1e-12)


def test_make_objective_validation():
    """Counterpart of test_mapping_engines.py::test_make_objective_validation."""
    c, _ = _pairwise_instance()
    with pytest.raises(ValueError, match="hyper"):
        make_objective("tree", c, 25, 5)
    with pytest.raises(ValueError, match="torus"):
        g, part, _, _ = _tree_instance()
        make_objective("tree", c, 16, 4, hyper=g.hyper, part=part, torus=True)
    with pytest.raises(ValueError, match="unknown"):
        make_objective("voltage", c, 25, 5)


@pytest.fixture(scope="module")
def small_profile():
    """(reference, port) profiles of smooth_320 over 200 steps."""
    return profiles("smooth_320", 200)


def test_run_toolchain_multicast_places_with_tree(small_profile):
    """Counterpart of test_mapping_engines.py::test_run_toolchain_multicast_places_with_tree."""
    tree_hops = {"tree": 0.0, "pairwise": 0.0}
    kw = dict(method="sneap", mesh_w=5, mesh_h=5, capacity=16, cast="multicast",
              mapper_kwargs={"iters": 12_000})
    for seed in (0, 1, 2, 3):
        res = toolchain(*small_profile, seed=seed, **kw)
        assert res.place_objective == "tree"
        assert res.mapping.objective == "tree"
        s = res.summary()
        assert s["tree_hop"] is not None and s["tree_hop"] > 0
        assert s["place_objective"] == "tree"
        tree_hops["tree"] += s["tree_hop"]
        pw = toolchain(*small_profile, seed=seed, place_objective="pairwise", **kw)
        assert pw.place_objective == "pairwise"
        assert pw.summary()["tree_hop"] is not None
        tree_hops["pairwise"] += pw.summary()["tree_hop"]
    assert tree_hops["tree"] <= tree_hops["pairwise"] * 1.02


def test_run_toolchain_sco_hop_comes_from_evaluator(small_profile):
    """Counterpart of test_mapping_engines.py::test_run_toolchain_sco_hop_comes_from_evaluator."""
    ref_prof, prof = small_profile
    res = toolchain(ref_prof, prof, method="sco", mesh_w=5, mesh_h=5, seed=0)
    assert np.isfinite(res.mapping.avg_hop)
    assert res.mapping.tree_hop is not None
    traffic = traffic_matrix(res.partition.part, prof.trace_src,
                             prof.trace_dst, res.partition.k)
    avg, _ = evaluate_placement(res.mapping.placement, traffic, 25, 5,
                                int(traffic.sum()))
    np.testing.assert_allclose(res.mapping.avg_hop, avg, rtol=1e-12)


def test_run_toolchain_rejects_tree_for_device_mapper(small_profile):
    """Counterpart of test_mapping_engines.py::test_run_toolchain_rejects_tree_for_device_mapper."""
    from repro_torch.core import run_toolchain

    prof = small_profile[1]
    with pytest.raises(ValueError, match="cannot run the tree objective"):
        run_toolchain(prof, method="sneap", mesh_w=5, mesh_h=5, capacity=16,
                      seed=0, cast="multicast", mapper="polish",
                      place_objective="tree", device="cpu")
    with pytest.raises(ValueError, match="sco"):
        run_toolchain(prof, method="sco", mesh_w=5, mesh_h=5, seed=0,
                      cast="multicast", place_objective="tree", device="cpu")
