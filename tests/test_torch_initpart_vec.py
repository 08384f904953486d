"""tests/test_initpart_vec.py held against the port on the CPU: greedy
region growing under every engine and the second-chance matching round,
each with the reference's invariants and bitwise the reference's result
on the same graph and seed."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import initpart as ref_initpart  # noqa: E402
from torch_parity import assert_bitwise, pair  # noqa: E402

from repro_torch.core.coarsen import heavy_edge_matching, heavy_edge_matching_vec  # noqa: E402
from repro_torch.core.graph import partition_weights  # noqa: E402
from repro_torch.core.initpart import greedy_region_growing  # noqa: E402


def _grow(ref, g, k, cap, seed, **kw):
    """The port's region growing, bitwise the reference's."""
    part = greedy_region_growing(g, k, cap, np.random.default_rng(seed), **kw)
    want = ref_initpart.greedy_region_growing(ref, k, cap,
                                              np.random.default_rng(seed), **kw)
    assert_bitwise(part, want)
    return part


@pytest.mark.parametrize("impl", ["scalar", "vec", "auto"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_region_growing_valid_all_impls(impl, seed):
    """Counterpart of test_initpart_vec.py::test_region_growing_valid_all_impls."""
    ref, g = pair("random_graph", 400, 0.03, seed=seed)
    k, cap = 12, 50
    part = _grow(ref, g, k, cap, seed, impl=impl)
    assert part.min() >= 0 and part.max() < k
    assert (partition_weights(g, part, k) <= cap).all()


def test_region_growing_vec_tight_fit_falls_back():
    """Counterpart of test_initpart_vec.py::test_region_growing_vec_tight_fit_falls_back."""
    ref, g = pair("random_graph", 100, 0.05, seed=3)
    k, cap = 10, 10
    part = _grow(ref, g, k, cap, 0, impl="vec")
    assert (partition_weights(g, part, k) <= cap).all()


def test_region_growing_vec_more_regions_than_vertices():
    """Counterpart of test_initpart_vec.py::test_region_growing_vec_more_regions_than_vertices."""
    ref, g = pair("random_graph", 50, 0.1, seed=6)
    k, cap = 80, 2
    part = _grow(ref, g, k, cap, 0, impl="vec")
    assert (partition_weights(g, part, k) <= cap).all()
    assert part.min() >= 0 and part.max() < k


def test_region_growing_rejects_unknown_impl():
    """Counterpart of test_initpart_vec.py::test_region_growing_rejects_unknown_impl."""
    _, g = pair("random_graph", 20, 0.2, seed=4)
    with pytest.raises(ValueError):
        greedy_region_growing(g, 4, 10, np.random.default_rng(0), impl="simd")


def test_region_growing_infeasible_raises():
    """Counterpart of test_initpart_vec.py::test_region_growing_infeasible_raises."""
    _, g = pair("random_graph", 50, 0.1, seed=5)
    with pytest.raises(ValueError):
        greedy_region_growing(g, 2, 10, np.random.default_rng(0))


def test_second_chance_matching_closes_weight_gap():
    """Counterpart of test_initpart_vec.py::test_second_chance_matching_closes_weight_gap."""
    seq_w = vec_w = 0
    for seed in range(5):
        ref, g = pair("random_graph", 300, 0.04, seed=seed)
        ids = np.arange(300)
        for name, match, want in (
            ("seq", heavy_edge_matching(g, np.random.default_rng(seed)),
             ref_coarsen.heavy_edge_matching(ref, np.random.default_rng(seed))),
            ("vec", heavy_edge_matching_vec(g, np.random.default_rng(seed)),
             ref_coarsen.heavy_edge_matching_vec(ref, np.random.default_rng(seed))),
        ):
            np.testing.assert_array_equal(match, want)
            assert np.array_equal(match[match], ids)  # involution
            matched = match != ids
            w = 0
            for v in np.nonzero(matched)[0]:
                u = match[v]
                if v < u:
                    nbrs, wgts = g.neighbors(v)
                    w += int(wgts[list(nbrs).index(u)])
            if name == "seq":
                seq_w += w
            else:
                vec_w += w
    assert vec_w >= 0.9 * seq_w
