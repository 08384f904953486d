"""tests/test_graph.py held against the port on the CPU: each reference
test's invariants on the port's graph, and the port's CSR, cut and
partition weights bitwise the reference's on the same inputs.  Also holds
every builder of tests/torch_builders.py bitwise to its conftest.py
namesake, which the card's jax-free suite relies on."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # as the reference suite
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import graph as ref_graph  # noqa: E402
from torch_parity import assert_bitwise, assert_graph_equal, pair  # noqa: E402

from repro_torch.core.graph import (  # noqa: E402
    build_graph,
    edge_cut,
    partition_weights,
    validate_partition,
)


@pytest.mark.parametrize("builder,args", [
    ("random_graph", (60, 0.2, 3)),
    ("random_hypergraph", (40, 150, 1)),
    ("fanout_snn_graph", (50, 6, 2)),
    ("layered_snn_graph", ((8, 8, 8),)),
    ("random_spike_trace", (4,)),
    ("random_snn_traffic", (30, 90, 5)),
])
def test_port_builders_equal_conftest_builders(builder, args):
    """tests/torch_builders.py draws the conftest builders' inputs."""
    pair(builder, *args)


def test_build_graph_merges_duplicates_and_drops_self_loops():
    """Counterpart of test_graph.py::test_build_graph_merges_duplicates_and_drops_self_loops."""
    kw = dict(src=[0, 0, 1, 2, 2], dst=[1, 1, 0, 2, 3], weight=[3, 4, 5, 9, 1])
    g = build_graph(4, **kw)
    assert g.num_edges == 2
    nbrs, w = g.neighbors(0)
    assert nbrs.tolist() == [1] and w.tolist() == [12]
    assert g.total_adjwgt == 13
    assert_graph_equal(g, ref_graph.build_graph(4, **kw))


def test_symmetry():
    """Counterpart of test_graph.py::test_symmetry."""
    _, g = pair("random_graph", 50, 0.2, seed=1)
    for v in range(50):
        nbrs, w = g.neighbors(v)
        for u, wt in zip(nbrs, w):
            back_n, back_w = g.neighbors(int(u))
            i = list(back_n).index(v)
            assert back_w[i] == wt


def test_edge_cut_matches_bruteforce():
    """Counterpart of test_graph.py::test_edge_cut_matches_bruteforce."""
    ref, g = pair("random_graph", 40, 0.3, seed=2)
    part = np.random.default_rng(3).integers(0, 4, 40)
    brute = 0
    for v in range(40):
        nbrs, w = g.neighbors(v)
        for u, wt in zip(nbrs, w):
            if part[v] != part[u]:
                brute += int(wt)
    assert edge_cut(g, part) == brute // 2
    assert edge_cut(g, part) == ref_graph.edge_cut(ref, part)


@given(n=st.integers(5, 60), p=st.floats(0.05, 0.5), k=st.integers(2, 5),
       seed=st.integers(0, 10_000))
@settings(max_examples=25, deadline=None)
def test_partition_weights_conserve_total(n, p, k, seed):
    """Counterpart of test_graph.py::test_partition_weights_conserve_total."""
    ref, g = pair("random_graph", n, p, seed=seed)
    part = np.random.default_rng(seed).integers(0, k, n)
    w = partition_weights(g, part, k)
    assert w.sum() == g.total_vwgt
    assert_bitwise(w, ref_graph.partition_weights(ref, part, k))


def test_validate_partition_raises():
    """Counterpart of test_graph.py::test_validate_partition_raises."""
    ref, g = pair("random_graph", 20, 0.3, seed=4)
    part = np.zeros(20, dtype=np.int64)
    with pytest.raises(ValueError):
        validate_partition(g, part, k=2, capacity=10)
    with pytest.raises(ValueError):
        ref_graph.validate_partition(ref, part, k=2, capacity=10)
