"""tests/test_refine_vec_property.py held against the port on the CPU (with
the reference's hypothesis settings): the vec matching, the batched
refiner and the vec partitioner keep the reference's invariants and give
the reference's results bitwise on the same inputs."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # as the reference suite
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from repro.core.partition import sneap_partition as ref_sneap_partition  # noqa: E402
from torch_parity import mismatched, pair  # noqa: E402

from repro_torch.core.coarsen import heavy_edge_matching_vec  # noqa: E402
from repro_torch.core.graph import edge_cut, partition_weights, validate_partition  # noqa: E402
from repro_torch.core.partition import sneap_partition  # noqa: E402
from repro_torch.core.refine_vec import refine_level_vec  # noqa: E402


@given(n=st.integers(20, 150), p=st.floats(0.05, 0.3), seed=st.integers(0, 1000))
@settings(max_examples=15, deadline=None)
def test_matching_vec_property(n, p, seed):
    """Counterpart of test_refine_vec_property.py::test_matching_vec_property."""
    ref, g = pair("random_graph", n, p, seed=seed)
    cap = 2
    match = heavy_edge_matching_vec(g, np.random.default_rng(seed), max_vwgt=cap)
    np.testing.assert_array_equal(match, ref_coarsen.heavy_edge_matching_vec(
        ref, np.random.default_rng(seed), max_vwgt=cap))
    assert np.array_equal(match[match], np.arange(n))
    merged = g.vwgt + g.vwgt[match]
    paired = match != np.arange(n)
    assert (merged[paired] <= cap).all()


@given(n=st.integers(30, 150), p=st.floats(0.05, 0.25), seed=st.integers(0, 1000))
@settings(max_examples=15, deadline=None)
def test_refine_vec_property(n, p, seed):
    """Counterpart of test_refine_vec_property.py::test_refine_vec_property."""
    ref, g = pair("random_graph", n, p, seed=seed)
    k = max(3, n // 20)
    cap = max(8, 2 * (n // k))
    part = (np.arange(n) % k).astype(np.int64)
    c0 = edge_cut(g, part)
    out, cut = refine_level_vec(g, part, k, cap, device="cpu")
    want, want_cut = ref_refine_vec.refine_level_vec(ref, part, k, cap)
    np.testing.assert_array_equal(out, want)
    assert cut == want_cut
    assert cut <= c0
    assert cut == edge_cut(g, out)
    assert out.min() >= 0 and out.max() < k
    assert (partition_weights(g, out, k) <= cap).all()
    out2, cut2 = refine_level_vec(g, part, k, cap, device="cpu")
    assert np.array_equal(out, out2) and cut == cut2


@given(n=st.integers(20, 120), p=st.floats(0.05, 0.3), seed=st.integers(0, 500))
@settings(max_examples=10, deadline=None)
def test_sneap_vec_parity_property(n, p, seed):
    """Counterpart of test_refine_vec_property.py::test_sneap_vec_parity_property."""
    ref, g = pair("random_graph", n, p, seed=seed)
    cap = max(8, n // 6)
    s = sneap_partition(g, capacity=cap, seed=seed, impl="scalar", device="cpu")
    v = sneap_partition(g, capacity=cap, seed=seed, impl="vec", device="cpu")
    kw = dict(capacity=cap, seed=seed)
    assert mismatched(s, ref_sneap_partition(ref, impl="scalar", **kw)) == []
    assert mismatched(v, ref_sneap_partition(ref, impl="vec", **kw)) == []
    validate_partition(g, v.part, v.k, cap)
    assert v.edge_cut == edge_cut(g, v.part)
    assert np.array_equal(s.part, v.part) and s.edge_cut == v.edge_cut
