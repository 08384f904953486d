"""tests/test_nocsim.py held against the port on the CPU: XY route
expansion, the queued and analytic replays (every NoCStats field bitwise
the reference's on the same trace), the energy model, and the span
helpers behind the tree-hop objective, bitwise the reference's."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # as the reference suite
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.nocsim import xy as ref_xy  # noqa: E402
from torch_parity import assert_bitwise, simulate  # noqa: E402

from repro_torch.nocsim.energy import EnergyModel  # noqa: E402
from repro_torch.nocsim.xy import (link_count, link_ids_for_routes, next_link,  # noqa: E402
                                   route_hops, segment_extrema2, span_to)


@given(w=st.integers(2, 8), h=st.integers(2, 8), seed=st.integers(0, 2000))
@settings(max_examples=30, deadline=None)
def test_route_expansion_matches_stepwise_walk(w, h, seed):
    """Counterpart of test_nocsim.py::test_route_expansion_matches_stepwise_walk."""
    rng = np.random.default_rng(seed)
    n = w * h
    src = rng.integers(0, n, 20)
    dst = rng.integers(0, n, 20)
    ids, pkt = link_ids_for_routes(src, dst, w, h)
    want_ids, want_pkt = ref_xy.link_ids_for_routes(src, dst, w, h)
    assert_bitwise(ids, want_ids)
    assert_bitwise(pkt, want_pkt)
    for p in range(20):
        cur = np.array([src[p]])
        walked = []
        while cur[0] != dst[p]:
            nxt, link = next_link(cur, np.array([dst[p]]), w, h)
            walked.append(int(link[0]))
            cur = nxt
        mine = sorted(ids[pkt == p].tolist())
        assert mine == sorted(walked)
        assert len(walked) == route_hops(np.array([src[p]]), np.array([dst[p]]), w)[0]


def _tiny_trace(seed=0, n_spikes=200, timesteps=20, k=6, cores=9):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, k, 30)
    placement = rng.permutation(cores)[:k]
    t = np.sort(rng.integers(0, timesteps, n_spikes))
    src = rng.integers(0, 30, n_spikes)
    dst = rng.integers(0, 30, n_spikes)
    return t, src, dst, part, placement


def test_queued_no_congestion_latency_equals_hops():
    """Counterpart of test_nocsim.py::test_queued_no_congestion_latency_equals_hops."""
    t, src, dst, part, placement = _tiny_trace()
    s = simulate(t, src, dst, part, placement, 3, 3,
                 link_capacity=10_000, mode="queued")
    assert s.congestion_count == 0
    np.testing.assert_allclose(s.avg_latency, s.avg_hop)


def test_queued_congestion_grows_latency():
    """Counterpart of test_nocsim.py::test_queued_congestion_grows_latency."""
    t, src, dst, part, placement = _tiny_trace(n_spikes=2000, timesteps=4)
    free = simulate(t, src, dst, part, placement, 3, 3,
                    link_capacity=10_000, mode="queued")
    jam = simulate(t, src, dst, part, placement, 3, 3,
                   link_capacity=1, mode="queued")
    assert jam.congestion_count > 0
    assert jam.avg_latency > free.avg_latency
    assert jam.total_hops == free.total_hops


def test_analytic_matches_queued_static_quantities():
    """Counterpart of test_nocsim.py::test_analytic_matches_queued_static_quantities."""
    t, src, dst, part, placement = _tiny_trace(seed=3)
    a = simulate(t, src, dst, part, placement, 3, 3, mode="analytic")
    q = simulate(t, src, dst, part, placement, 3, 3,
                 link_capacity=10_000, mode="queued")
    assert a.total_hops == q.total_hops
    assert a.num_noc_spikes == q.num_noc_spikes
    np.testing.assert_allclose(a.edge_variance, q.edge_variance)
    np.testing.assert_allclose(a.dynamic_energy_pj, q.dynamic_energy_pj)


def test_energy_proportional_to_hops():
    """Counterpart of test_nocsim.py::test_energy_proportional_to_hops."""
    t, src, dst, part, placement = _tiny_trace(seed=4)
    s = simulate(t, src, dst, part, placement, 3, 3, mode="analytic")
    e = EnergyModel()
    expected = s.total_hops * (e.router_pj_per_spike + e.link_pj_per_spike) \
        + s.num_local_spikes * e.local_pj_per_spike
    np.testing.assert_allclose(s.dynamic_energy_pj, expected)


def test_link_count():
    """Counterpart of test_nocsim.py::test_link_count."""
    assert link_count(5, 5) == 2 * 4 * 5 + 2 * 5 * 4
    assert link_count(16, 16) == 2 * 15 * 16 * 2
    for w, h in ((5, 5), (16, 16), (3, 7)):
        assert link_count(w, h) == ref_xy.link_count(w, h)


def test_span_to_closed_form_and_sentinels():
    """Counterpart of test_nocsim.py::test_span_to_closed_form_and_sentinels."""
    assert span_to(2, 1, 5) == 4
    assert span_to(0, 1, 5) == 5
    assert span_to(7, 1, 5) == 6
    assert span_to(3, 8, -1) == 0
    args = (np.array([2, 0, 3]), np.array([1, 1, 8]), np.array([5, 5, -1]))
    got = span_to(*args)
    np.testing.assert_array_equal(got, [4, 5, 0])
    assert_bitwise(got, ref_xy.span_to(*args))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_extrema2_matches_bruteforce(seed):
    """Counterpart of test_nocsim.py::test_segment_extrema2_matches_bruteforce."""
    rng = np.random.default_rng(seed)
    nseg, vmax = 50, 12
    m = int(rng.integers(1, 120))
    seg = rng.integers(0, nseg, m)
    val = rng.integers(0, vmax, m)
    out = segment_extrema2(seg, val, vmax)
    for a, b in zip(out, ref_xy.segment_extrema2(seg, val, vmax)):
        assert_bitwise(a, b)
    useg, cnt, mn1, mn2, mx1, mx2 = out
    occupied = np.unique(seg)
    np.testing.assert_array_equal(useg, occupied)
    for i, s in enumerate(occupied):
        v = np.sort(val[seg == s])
        assert cnt[i] == v.shape[0]
        assert mn1[i] == v[0] and mx1[i] == v[-1]
        if v.shape[0] >= 2:
            assert mn2[i] == v[1] and mx2[i] == v[-2]
        else:
            assert mn2[i] == vmax and mx2[i] == -1


def test_segment_extrema2_empty_input():
    """Counterpart of test_nocsim.py::test_segment_extrema2_empty_input."""
    args = (np.empty(0, np.int64), np.empty(0, np.int64), 8)
    out = segment_extrema2(*args)
    assert all(a.shape == (0,) for a in out)
    for a, b in zip(out, ref_xy.segment_extrema2(*args)):
        assert_bitwise(a, b)
