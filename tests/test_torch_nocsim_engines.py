"""tests/test_nocsim_engines.py held against the port on the CPU: the
batched two-tier replay against the scalar engine (congested windows,
injection stagger, both steppers and both screens), the unbounded and
tree-fork cases and within-step permutation invariance.  Every replay of
the port is also held, field by field and bitwise, to the reference's
replay of the same trace with the same knobs (the port's ``screen=
"linkload"`` and ``stepper="jax"`` against the reference's ``"interpret"``
screen and ``"jax"`` stepper)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.nocsim import simulate_noc as ref_simulate_noc  # noqa: E402
from repro.nocsim import xy as ref_xy  # noqa: E402
from torch_parity import mismatched, pair, simulate  # noqa: E402

from repro_torch.nocsim import simulate_noc  # noqa: E402
from repro_torch.nocsim.stats import NoCStats  # noqa: E402
from repro_torch.nocsim.xy import link_count, link_endpoints, link_ids_for_routes, next_link  # noqa: E402


def stats_equal(a, b):
    """Names of the NoCStats fields that differ, bitwise."""
    return mismatched(a, b, skip=())


def _trace(**kw):
    return pair("random_spike_trace", **kw)[1]


def test_route_steps_follow_stepwise_walk():
    """Counterpart of test_nocsim_engines.py::test_route_steps_follow_stepwise_walk."""
    rng = np.random.default_rng(0)
    w, h = 5, 4
    src = rng.integers(0, w * h, 50)
    dst = rng.integers(0, w * h, 50)
    out = link_ids_for_routes(src, dst, w, h, with_steps=True)
    for a, b in zip(out, ref_xy.link_ids_for_routes(src, dst, w, h,
                                                    with_steps=True)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ids, pkt, step = out
    for p in range(50):
        order = np.argsort(step[pkt == p])
        mine = ids[pkt == p][order].tolist()
        cur, walked = np.array([src[p]]), []
        while cur[0] != dst[p]:
            cur, link = next_link(cur, np.array([dst[p]]), w, h)
            walked.append(int(link[0]))
        assert mine == walked


def test_link_endpoints_roundtrip():
    """Counterpart of test_nocsim_engines.py::test_link_endpoints_roundtrip."""
    for w, h in ((2, 2), (3, 5), (4, 4)):
        ids = np.arange(link_count(w, h))
        tail, head = link_endpoints(ids, w, h)
        want_tail, want_head = ref_xy.link_endpoints(ids, w, h)
        np.testing.assert_array_equal(tail, want_tail)
        np.testing.assert_array_equal(head, want_head)
        nxt, link = next_link(tail, head, w, h)
        np.testing.assert_array_equal(nxt, head)
        np.testing.assert_array_equal(link, ids)


@pytest.mark.parametrize("link_capacity,inject_capacity", [
    (1, 256), (2, 256), (4, 3), (2, 1), (10_000, 256),
])
def test_batched_matches_ref_exactly(link_capacity, inject_capacity):
    """Counterpart of test_nocsim_engines.py::test_batched_matches_ref_exactly;
    the port's batched engine also runs on the link-load screen and the
    torch stepper."""
    for seed in range(4):
        t, src, dst, part, placement = _trace(seed=seed, n_spikes=1500,
                                              timesteps=8)
        args = (t, src, dst, part, placement, 3, 3)
        kw = dict(link_capacity=link_capacity, inject_capacity=inject_capacity)
        ref = simulate(*args, engine="ref", **kw)
        new = simulate(*args, engine="batched", **kw)
        dev = simulate_noc(*args, engine="batched", screen="linkload",
                           stepper="jax", device="cpu", **kw)
        assert ref.congestion_count > 0 or link_capacity >= 1000 \
            or ref.avg_latency == ref.avg_hop
        assert stats_equal(ref, new) == [], (seed, link_capacity)
        assert stats_equal(ref, dev) == [], (seed, link_capacity)


def test_congested_windows_actually_step():
    """Counterpart of test_nocsim_engines.py::test_congested_windows_actually_step."""
    t, src, dst, part, placement = _trace(seed=0, n_spikes=1500, timesteps=8)
    jam = simulate(t, src, dst, part, placement, 3, 3, link_capacity=1)
    assert jam.congestion_count > 0
    assert jam.avg_latency > jam.avg_hop


def test_jax_stepper_matches_ref():
    """Counterpart of test_nocsim_engines.py::test_jax_stepper_matches_ref:
    the port's torch stepper (its ``stepper="jax"``) against the scalar
    engine and, bitwise, the reference's jax stepper."""
    t, src, dst, part, placement = _trace(seed=1, n_spikes=800, timesteps=6)
    args = (t, src, dst, part, placement, 3, 3)
    ref = simulate(*args, link_capacity=1, engine="ref")
    new = simulate(*args, link_capacity=1, engine="batched", stepper="jax")
    assert stats_equal(ref, new) == []


def test_screen_backends_do_not_change_results():
    """Counterpart of test_nocsim_engines.py::test_screen_backends_do_not_change_results:
    the port's screens ("numpy", "linkload") against the reference's
    "numpy", "linkload" and "interpret" screens, bitwise."""
    t, src, dst, part, placement = _trace(seed=2, n_spikes=800, timesteps=6)
    args = (t, src, dst, part, placement, 3, 3)
    base = simulate(*args, link_capacity=2)
    for screen in ("linkload", "interpret"):
        got = simulate(*args, link_capacity=2, screen="linkload",
                       ref_kw=dict(link_capacity=2, screen=screen))
        assert stats_equal(base, got) == [], screen
    mc = simulate(*args, link_capacity=2, cast="multicast")
    mc2 = simulate(*args, link_capacity=2, cast="multicast", screen="linkload")
    assert stats_equal(mc, mc2) == []


def test_undrainable_window_raises():
    """Counterpart of test_nocsim_engines.py::test_undrainable_window_raises."""
    t, src, dst, part, placement = _trace(seed=0, n_spikes=200)
    for engine in ("ref", "batched"):
        with pytest.raises(RuntimeError):
            simulate_noc(t, src, dst, part, placement, 3, 3, link_capacity=0,
                         engine=engine, max_cycles_per_window=50, device="cpu")


@pytest.mark.parametrize("engine", ["ref", "batched"])
def test_unbounded_capacities_degenerate_to_hops(engine):
    """Counterpart of test_nocsim_engines.py::test_unbounded_capacities_degenerate_to_hops."""
    t, src, dst, part, placement = _trace(seed=3)
    q = simulate(t, src, dst, part, placement, 3, 3, link_capacity=10_000,
                 inject_capacity=10_000, engine=engine)
    a = simulate(t, src, dst, part, placement, 3, 3, mode="analytic")
    assert q.congestion_count == 0
    assert q.avg_latency == a.avg_latency
    assert q.max_latency == a.max_latency
    assert q.total_hops == a.total_hops


@pytest.mark.parametrize("engine", ["ref", "batched"])
def test_unbounded_links_latency_is_hops_plus_stagger(engine):
    """Counterpart of test_nocsim_engines.py::test_unbounded_links_latency_is_hops_plus_stagger."""
    inject_capacity = 2
    t, src, dst, part, placement = _trace(seed=4, n_spikes=600)
    q = simulate(t, src, dst, part, placement, 3, 3, link_capacity=10_000,
                 inject_capacity=inject_capacity, engine=engine)
    core = placement[part]
    s, d = core[src], core[dst]
    order = np.lexsort((d, s, t))
    ts, ss, ds = t[order], s[order], d[order]
    remote = ss != ds
    ts, ss, ds = ts[remote], ss[remote], ds[remote]
    lat = []
    for step_t in np.unique(ts):
        m = ts == step_t
        ws, wd = ss[m], ds[m]
        rank = np.empty(ws.shape[0], dtype=int)
        for c in np.unique(ws):
            cm = np.flatnonzero(ws == c)
            rank[cm] = np.arange(cm.shape[0])
        hops = np.abs(ws % 3 - wd % 3) + np.abs(ws // 3 - wd // 3)
        lat.extend((rank // inject_capacity + hops).tolist())
    assert q.avg_latency == pytest.approx(np.mean(lat))
    assert q.max_latency == max(lat)
    assert q.congestion_count == 0


def _per_window(t, src, dst, part, placement, **kw):
    out = []
    for step_t in np.unique(t):
        m = t == step_t
        out.append(simulate(t[m], src[m], dst[m], part, placement, 3, 3, **kw))
    return out


@pytest.mark.parametrize("link_capacity", [1, 2, 4])
def test_tree_latency_tighter_than_replica_per_window(link_capacity):
    """Counterpart of test_nocsim_engines.py::test_tree_latency_tighter_than_replica_per_window."""
    t, src, dst, part, placement = _trace(seed=5, n_spikes=1200, timesteps=6)
    tree = _per_window(t, src, dst, part, placement, cast="multicast",
                       link_capacity=link_capacity, engine="batched")
    repl = _per_window(t, src, dst, part, placement, cast="multicast",
                       link_capacity=link_capacity, engine="ref")
    for wtree, wrepl in zip(tree, repl):
        assert wtree.avg_latency <= wrepl.avg_latency + 1e-12
        assert wtree.max_latency <= wrepl.max_latency
        assert wtree.congestion_count <= wrepl.congestion_count


def test_tree_static_quantities_match_replica_engine():
    """Counterpart of test_nocsim_engines.py::test_tree_static_quantities_match_replica_engine."""
    t, src, dst, part, placement = _trace(seed=6, n_spikes=1500)
    for cap in (1, 4, 10_000):
        tree = simulate(t, src, dst, part, placement, 3, 3,
                        link_capacity=cap, cast="multicast")
        repl = simulate(t, src, dst, part, placement, 3, 3,
                        link_capacity=cap, cast="multicast", engine="ref")
        assert tree.cast == repl.cast == "multicast"
        assert tree.num_noc_spikes == repl.num_noc_spikes
        assert tree.num_local_spikes == repl.num_local_spikes
        assert tree.total_hops == repl.total_hops
        assert tree.link_traversals == repl.link_traversals
        np.testing.assert_array_equal(tree.per_link_hops, repl.per_link_hops)
        assert tree.dynamic_energy_pj == repl.dynamic_energy_pj
        assert tree.edge_variance == repl.edge_variance


def test_tree_engine_is_the_multicast_default():
    """Counterpart of test_nocsim_engines.py::test_tree_engine_is_the_multicast_default."""
    t, src, dst, part, placement = _trace(seed=7, n_spikes=1500)
    args = (t, src, dst, part, placement, 3, 3)
    default = simulate(*args, link_capacity=1, cast="multicast")
    tree = simulate(*args, link_capacity=1, cast="multicast", engine="batched")
    repl = simulate(*args, link_capacity=1, cast="multicast", engine="ref")
    assert stats_equal(default, tree) == []
    assert default.link_traversals < default.total_hops
    assert default.avg_latency < repl.avg_latency


def test_tree_unbounded_matches_analytic_plus_stagger():
    """Counterpart of test_nocsim_engines.py::test_tree_unbounded_matches_analytic_plus_stagger."""
    t, src, dst, part, placement = _trace(seed=8)
    q = simulate(t, src, dst, part, placement, 3, 3, cast="multicast",
                 link_capacity=10_000, inject_capacity=10_000)
    a = simulate(t, src, dst, part, placement, 3, 3, cast="multicast",
                 mode="analytic")
    assert q.congestion_count == 0
    assert q.avg_latency == a.avg_latency
    assert q.cycles_simulated > 0


def _shuffle_within_steps(t, src, dst, seed):
    rng = np.random.default_rng(seed)
    idx = np.arange(t.shape[0])
    for v in np.unique(t):
        m = np.flatnonzero(t == v)
        idx[m] = rng.permutation(idx[m])
    return src[idx], dst[idx]


@pytest.mark.parametrize("cast", ["unicast", "multicast"])
@pytest.mark.parametrize("engine", ["ref", "batched"])
def test_stats_invariant_under_within_step_permutation(cast, engine):
    """Counterpart of test_nocsim_engines.py::test_stats_invariant_under_within_step_permutation."""
    t, src, dst, part, placement = _trace(seed=9, n_spikes=1200, timesteps=6)
    kw = dict(link_capacity=2, inject_capacity=3, cast=cast, engine=engine)
    base = simulate(t, src, dst, part, placement, 3, 3, **kw)
    for pseed in (1, 2):
        s2, d2 = _shuffle_within_steps(t, src, dst, pseed)
        got = simulate(t, s2, d2, part, placement, 3, 3, **kw)
        assert stats_equal(base, got) == [], (cast, engine, pseed)


def test_per_link_hops_optional_and_guarded():
    """Counterpart of test_nocsim_engines.py::test_per_link_hops_optional_and_guarded."""
    s = NoCStats(avg_latency=0.0, max_latency=0, avg_hop=0.0, total_hops=0,
                 congestion_count=0, edge_variance=0.0, dynamic_energy_pj=0.0,
                 num_noc_spikes=0, num_local_spikes=0, cycles_simulated=0)
    assert s.per_link_hops is None
    assert s.max_link_load() == 0
    t, src, dst, part, placement = _trace(seed=10)
    q = simulate(t, src, dst, part, placement, 3, 3)
    assert q.per_link_hops is not None
    assert q.max_link_load() == int(q.per_link_hops.max())


def test_simulate_noc_rejects_unknown_knobs():
    """Counterpart of test_nocsim_engines.py::test_simulate_noc_rejects_unknown_knobs."""
    t, src, dst, part, placement = _trace(seed=0, n_spikes=50)
    for kw in ({"engine": "bogus"}, {"stepper": "bogus"}, {"screen": "bogus"},
               {"mode": "bogus"}, {"cast": "bogus"}):
        with pytest.raises(ValueError):
            simulate_noc(t, src, dst, part, placement, 3, 3, device="cpu", **kw)
        with pytest.raises(ValueError):
            ref_simulate_noc(t, src, dst, part, placement, 3, 3, **kw)

