"""tests/test_partition.py held against the port on the CPU: matching,
contraction, coarsening, the multilevel partitioner and the baselines,
each with the reference's invariants and bitwise the reference's result
on the same graph and seed.  (tests/test_torch_partition.py holds the
port's kernel paths; this file is the reference suite's counterpart.)"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # as the reference suite
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core.partition import sneap_partition as ref_sneap_partition  # noqa: E402
from torch_parity import assert_graph_equal, assert_levels_equal, mismatched, pair  # noqa: E402

from repro_torch.core.baselines import greedy_kl_partition, sco_partition  # noqa: E402
from repro_torch.core.coarsen import coarsen, contract, heavy_edge_matching  # noqa: E402
from repro_torch.core.graph import edge_cut, partition_weights, validate_partition  # noqa: E402
from repro_torch.core.partition import sneap_partition  # noqa: E402


def _partition(ref, g, **kw):
    """The port's sneap_partition on the CPU, bitwise the reference's."""
    got = sneap_partition(g, device="cpu", **kw)
    assert mismatched(got, ref_sneap_partition(ref, **kw)) == []
    return got


def test_matching_is_symmetric():
    """Counterpart of test_partition.py::test_matching_is_symmetric."""
    ref, g = pair("random_graph", 80, 0.1, seed=5)
    match = heavy_edge_matching(g, np.random.default_rng(0))
    for v in range(80):
        assert match[match[v]] == v
    np.testing.assert_array_equal(
        match, ref_coarsen.heavy_edge_matching(ref, np.random.default_rng(0)))


def test_contract_preserves_totals():
    """Counterpart of test_partition.py::test_contract_preserves_totals."""
    ref, g = pair("random_graph", 60, 0.2, seed=6)
    match = heavy_edge_matching(g, np.random.default_rng(1))
    c = contract(g, match)
    assert c.total_vwgt == g.total_vwgt
    internal = sum(int(w) for v in range(60)
                   for u, w in zip(*g.neighbors(v)) if match[v] == u) // 2
    assert c.total_adjwgt == g.total_adjwgt - internal
    assert_graph_equal(c, ref_coarsen.contract(ref, match))


def test_coarsen_levels_shrink():
    """Counterpart of test_partition.py::test_coarsen_levels_shrink."""
    ref, g = pair("random_graph", 300, 0.05, seed=7)
    levels = coarsen(g, np.random.default_rng(2), coarsen_to=32)
    sizes = [lv.num_vertices for lv in levels]
    assert sizes == sorted(sizes, reverse=True)
    assert all(lv.total_vwgt == g.total_vwgt for lv in levels)
    assert_levels_equal(
        levels, ref_coarsen.coarsen(ref, np.random.default_rng(2), coarsen_to=32))


def test_sneap_partition_valid_and_better_than_random():
    """Counterpart of test_partition.py::test_sneap_partition_valid_and_better_than_random."""
    ref, g = pair("random_graph", 200, 0.08, seed=8)
    res = _partition(ref, g, capacity=32, seed=0)
    validate_partition(g, res.part, res.k, 32)
    rng = np.random.default_rng(0)
    rand_cuts = []
    for _ in range(5):
        part = np.repeat(np.arange(res.k), -(-200 // res.k))[:200]
        rng.shuffle(part)
        rand_cuts.append(edge_cut(g, part))
    assert res.edge_cut < min(rand_cuts)


def test_sneap_deterministic():
    """Counterpart of test_partition.py::test_sneap_deterministic."""
    ref, g = pair("random_graph", 120, 0.1, seed=9)
    a = _partition(ref, g, capacity=32, seed=3)
    b = sneap_partition(g, capacity=32, seed=3, device="cpu")
    assert np.array_equal(a.part, b.part) and a.edge_cut == b.edge_cut


def test_sneap_beats_or_matches_sco():
    """Counterpart of test_partition.py::test_sneap_beats_or_matches_sco."""
    ref, g = pair("random_graph", 150, 0.1, seed=10)
    sneap = _partition(ref, g, capacity=32, seed=0)
    sco = sco_partition(g, capacity=32)
    assert mismatched(sco, ref_baselines.sco_partition(ref, capacity=32)) == []
    assert sneap.edge_cut <= sco.edge_cut


def test_greedy_kl_valid():
    """Counterpart of test_partition.py::test_greedy_kl_valid."""
    ref, g = pair("random_graph", 100, 0.1, seed=11)
    res = greedy_kl_partition(g, capacity=32, seed=0, max_passes=3)
    validate_partition(g, res.part, res.k, 32)
    want = ref_baselines.greedy_kl_partition(ref, capacity=32, seed=0,
                                             max_passes=3)
    assert mismatched(res, want) == []


@given(n=st.integers(20, 120), p=st.floats(0.05, 0.3), seed=st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_partition_property(n, p, seed):
    """Counterpart of test_partition.py::test_partition_property."""
    ref, g = pair("random_graph", n, p, seed=seed)
    cap = max(8, n // 6)
    res = _partition(ref, g, capacity=cap, seed=seed)
    validate_partition(g, res.part, res.k, cap)
    assert res.edge_cut == edge_cut(g, res.part)
    assert partition_weights(g, res.part, res.k).sum() == n
