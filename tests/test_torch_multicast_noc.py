"""tests/test_multicast_noc.py held against the port on the CPU: the
multicast traffic matrix, XY tree links, the multicast replays (every
NoCStats field bitwise the reference's) and the cut-vs-volume toolchain
end to end (partitions, placements and NoCStats bitwise the
reference's)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import hopcost as ref_hopcost  # noqa: E402
from repro.nocsim import xy as ref_xy  # noqa: E402
from torch_parity import assert_bitwise, pair, profiles, simulate, toolchain  # noqa: E402

from repro_torch.core import comm_volume  # noqa: E402
from repro_torch.core.hopcost import traffic_matrix  # noqa: E402
from repro_torch.nocsim.xy import link_ids_for_routes, multicast_tree_links, route_hops  # noqa: E402


def _trace(**kw):
    return pair("random_spike_trace", **kw)[1]


def _traffic(*args, **kw):
    """The port's traffic matrix, bitwise the reference's."""
    got = traffic_matrix(*args, **kw)
    assert_bitwise(got, ref_hopcost.traffic_matrix(*args, **kw))
    return got


def _tree_links(*args):
    got = multicast_tree_links(*args)
    for a, b in zip(got, ref_xy.multicast_tree_links(*args)):
        assert_bitwise(a, b)
    return got


def test_multicast_traffic_counts_distinct_packets():
    """Counterpart of test_multicast_noc.py::test_multicast_traffic_counts_distinct_packets."""
    t, src, dst, part, _ = _trace()
    k = 6
    uni = _traffic(part, src, dst, k)
    multi = _traffic(part, src, dst, k, trace_t=t, cast="multicast")
    assert (multi <= uni).all()
    remote = {(int(ti), int(si), int(part[di]))
              for ti, si, di in zip(t, src, dst) if part[si] != part[di]}
    n_local = sum(1 for si, di in zip(src, dst) if part[si] == part[di])
    assert int(multi.sum()) == len(remote) + n_local
    assert int(np.diag(multi).sum()) == n_local == int(np.diag(uni).sum())


def test_multicast_traffic_requires_trace_t():
    """Counterpart of test_multicast_noc.py::test_multicast_traffic_requires_trace_t."""
    t, src, dst, part, _ = _trace()
    with pytest.raises(ValueError):
        traffic_matrix(part, src, dst, 6, cast="multicast")


def test_unicast_traffic_unchanged_by_trace_t():
    """Counterpart of test_multicast_noc.py::test_unicast_traffic_unchanged_by_trace_t."""
    t, src, dst, part, _ = _trace(seed=1)
    np.testing.assert_array_equal(
        _traffic(part, src, dst, 6),
        _traffic(part, src, dst, 6, trace_t=t, cast="unicast"),
    )


def test_tree_links_dedup_shared_prefix():
    """Counterpart of test_multicast_noc.py::test_tree_links_dedup_shared_prefix."""
    src = np.array([0, 0])
    dst = np.array([2, 5])
    group = np.array([7, 7])
    ids, grp = _tree_links(src, dst, group, 3, 3)
    assert (grp == 7).all()
    assert ids.shape[0] == 3
    flat, _ = link_ids_for_routes(src, dst, 3, 3)
    assert flat.shape[0] == 5


def test_tree_links_equal_unicast_for_distinct_groups():
    """Counterpart of test_multicast_noc.py::test_tree_links_equal_unicast_for_distinct_groups."""
    rng = np.random.default_rng(2)
    src = rng.integers(0, 9, 50)
    dst = rng.integers(0, 9, 50)
    group = np.arange(50)
    ids, _ = _tree_links(src, dst, group, 3, 3)
    assert ids.shape[0] == int(route_hops(src, dst, 3).sum())


def test_multicast_conservation_analytic():
    """Counterpart of test_multicast_noc.py::test_multicast_conservation_analytic."""
    t, src, dst, part, placement = _trace(seed=3)
    s = simulate(t, src, dst, part, placement, 3, 3, mode="analytic",
                 cast="multicast")
    core = placement[part]
    pairs = {(int(ti), int(si), int(core[di]))
             for ti, si, di in zip(t, src, dst) if core[si] != core[di]}
    assert s.num_noc_spikes == len(pairs)
    assert s.cast == "multicast"
    assert s.link_traversals <= s.total_hops


def test_multicast_queued_matches_analytic_static_quantities():
    """Counterpart of test_multicast_noc.py::test_multicast_queued_matches_analytic_static_quantities."""
    t, src, dst, part, placement = _trace(seed=4)
    a = simulate(t, src, dst, part, placement, 3, 3, mode="analytic",
                 cast="multicast")
    q = simulate(t, src, dst, part, placement, 3, 3, mode="queued",
                 link_capacity=10_000, cast="multicast")
    assert a.num_noc_spikes == q.num_noc_spikes
    assert a.total_hops == q.total_hops
    assert a.link_traversals == q.link_traversals
    np.testing.assert_allclose(a.edge_variance, q.edge_variance)
    np.testing.assert_allclose(a.dynamic_energy_pj, q.dynamic_energy_pj)
    assert q.congestion_count == 0
    np.testing.assert_allclose(q.avg_latency, q.avg_hop)


def test_multicast_never_costs_more_energy_than_unicast():
    """Counterpart of test_multicast_noc.py::test_multicast_never_costs_more_energy_than_unicast."""
    t, src, dst, part, placement = _trace(seed=5, n_spikes=1000)
    uni = simulate(t, src, dst, part, placement, 3, 3, mode="analytic")
    multi = simulate(t, src, dst, part, placement, 3, 3, mode="analytic",
                     cast="multicast")
    assert multi.dynamic_energy_pj <= uni.dynamic_energy_pj
    assert multi.num_noc_spikes <= uni.num_noc_spikes
    assert multi.link_traversals <= uni.link_traversals


def test_multicast_keeps_every_local_delivery():
    """Counterpart of test_multicast_noc.py::test_multicast_keeps_every_local_delivery."""
    t, src, dst, part, placement = _trace(seed=7, n_spikes=800)
    uni = simulate(t, src, dst, part, placement, 3, 3, mode="analytic")
    multi = simulate(t, src, dst, part, placement, 3, 3, mode="analytic",
                     cast="multicast")
    assert multi.num_local_spikes == uni.num_local_spikes


def test_unicast_link_traversals_equal_hops():
    """Counterpart of test_multicast_noc.py::test_unicast_link_traversals_equal_hops."""
    t, src, dst, part, placement = _trace(seed=6)
    s = simulate(t, src, dst, part, placement, 3, 3, mode="analytic")
    assert s.link_traversals == s.total_hops
    assert s.cast == "unicast"


def test_toolchain_volume_objective_end_to_end():
    """Counterpart of test_multicast_noc.py::test_toolchain_volume_objective_end_to_end."""
    ref_prof, prof = profiles("smooth_320", 250)
    kw = dict(mapper_kwargs={"iters": 1500})
    cut = toolchain(ref_prof, prof, objective="cut", **kw)
    vol = toolchain(ref_prof, prof, objective="volume", **kw)
    cut_mc = toolchain(ref_prof, prof, objective="cut", cast="multicast", **kw)
    assert vol.partition.comm_volume <= cut.partition.comm_volume
    assert vol.noc.dynamic_energy_pj <= cut_mc.noc.dynamic_energy_pj * 1.05
    for res in (cut, vol, cut_mc):
        s = res.summary()
        assert s["comm_volume"] == comm_volume(prof.hyper, res.partition.part)
        assert s["edge_cut"] == res.partition.edge_cut
        assert s["objective"] in ("cut", "volume") and s["cast"] in ("unicast", "multicast")
    assert cut.cast == "unicast" and vol.cast == "multicast"
