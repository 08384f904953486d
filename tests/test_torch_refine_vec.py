"""tests/test_refine_vec.py held against the port on the CPU: the vec
matching and coarsening, the batched refiner (also on its degree-kernel
path, whose plain version runs on a CPU tensor), uncoarsening and the vec
partitioner, each with the reference's invariants and bitwise the
reference's result on the same inputs; and the gain_eval wrappers on CPU
tensors against the reference's interpret-mode kernel within the
reference test's rtol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import initpart as ref_initpart  # noqa: E402
from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from repro.core.partition import sneap_partition as ref_sneap_partition  # noqa: E402
from repro.kernels import gain_eval as ref_gain_eval  # noqa: E402
from torch_parity import assert_bitwise, assert_levels_equal, mismatched, pair  # noqa: E402

from repro_torch.core.coarsen import coarsen, heavy_edge_matching_vec  # noqa: E402
from repro_torch.core.graph import edge_cut, partition_weights, validate_partition  # noqa: E402
from repro_torch.core.initpart import greedy_region_growing  # noqa: E402
from repro_torch.core.partition import sneap_partition  # noqa: E402
from repro_torch.core.refine_vec import partition_degrees, refine_level_vec, uncoarsen_vec  # noqa: E402
from repro_torch.kernels.gain_eval import (  # noqa: E402
    gain_matrix,
    gain_matrix_ref,
    part_degrees,
    part_degrees_ref,
)

RNG = np.random.default_rng(0)


def _refine(ref, g, part, k, cap, ref_kw=None, **kw):
    """The port's refine_level_vec on the CPU, bitwise the reference's."""
    got = refine_level_vec(g, part, k, cap, device="cpu", **kw)
    want = ref_refine_vec.refine_level_vec(ref, part, k, cap,
                                           **(kw if ref_kw is None else ref_kw))
    assert_bitwise(got[0], want[0])
    assert got[1] == want[1]
    return got


def _partition(ref, g, **kw):
    got = sneap_partition(g, device="cpu", **kw)
    assert mismatched(got, ref_sneap_partition(ref, **kw)) == []
    return got


def _match(ref, g, seed, **kw):
    got = heavy_edge_matching_vec(g, np.random.default_rng(seed), **kw)
    want = ref_coarsen.heavy_edge_matching_vec(ref, np.random.default_rng(seed),
                                               **kw)
    assert_bitwise(got, want)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_vec_symmetric(seed):
    """Counterpart of test_refine_vec.py::test_matching_vec_symmetric."""
    ref, g = pair("random_graph", 150, 0.08, seed=seed)
    match = _match(ref, g, seed)
    assert np.array_equal(match[match], np.arange(150))


def test_matching_vec_respects_cap():
    """Counterpart of test_refine_vec.py::test_matching_vec_respects_cap."""
    ref, g = pair("random_graph", 100, 0.1, seed=3)
    match = _match(ref, g, 0, max_vwgt=1)
    assert np.array_equal(match, np.arange(100))


def test_matching_vec_matches_most_vertices():
    """Counterpart of test_refine_vec.py::test_matching_vec_matches_most_vertices."""
    ref, g = pair("random_graph", 400, 0.05, seed=4)
    match = _match(ref, g, 0)
    assert (match != np.arange(400)).mean() > 0.5


def test_coarsen_vec_preserves_totals():
    """Counterpart of test_refine_vec.py::test_coarsen_vec_preserves_totals."""
    ref, g = pair("random_graph", 300, 0.05, seed=5)
    levels = coarsen(g, np.random.default_rng(0), coarsen_to=32, impl="vec")
    assert_levels_equal(levels, ref_coarsen.coarsen(
        ref, np.random.default_rng(0), coarsen_to=32, impl="vec"))
    sizes = [lv.num_vertices for lv in levels]
    assert sizes == sorted(sizes, reverse=True) and len(levels) > 1
    assert all(lv.total_vwgt == g.total_vwgt for lv in levels)


def test_coarsen_rejects_unknown_impl():
    """Counterpart of test_refine_vec.py::test_coarsen_rejects_unknown_impl."""
    _, g = pair("random_graph", 20, 0.2, seed=6)
    with pytest.raises(ValueError):
        coarsen(g, np.random.default_rng(0), impl="simd")


def test_partition_degrees_matches_bincount():
    """Counterpart of test_refine_vec.py::test_partition_degrees_matches_bincount."""
    ref, g = pair("random_graph", 120, 0.1, seed=7)
    k = 8
    part = RNG.integers(0, k, 120).astype(np.int64)
    src = np.repeat(np.arange(120), np.diff(g.xadj))
    want = np.bincount(src * k + part[g.adjncy], weights=g.adjwgt,
                       minlength=120 * k).reshape(120, k)
    got = partition_degrees(g, part, k)
    np.testing.assert_allclose(got, want)
    np.testing.assert_array_equal(got, ref_refine_vec.partition_degrees(ref, part, k))
    rows = np.array([3, 50, 117])
    np.testing.assert_allclose(partition_degrees(g, part, k, rows=rows), want[rows])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_refine_level_vec_invariants(seed):
    """Counterpart of test_refine_vec.py::test_refine_level_vec_invariants."""
    n, k, cap = 200, 10, 32
    ref, g = pair("random_graph", n, 0.06, seed=seed)
    part = (np.arange(n) % k).astype(np.int64)
    c0 = edge_cut(g, part)
    out, cut = _refine(ref, g, part, k, cap)
    assert cut <= c0
    assert cut == edge_cut(g, out)
    assert (partition_weights(g, out, k) <= cap).all()
    assert np.array_equal(part, (np.arange(n) % k))


def test_refine_level_vec_deterministic():
    """Counterpart of test_refine_vec.py::test_refine_level_vec_deterministic."""
    ref, g = pair("random_graph", 150, 0.08, seed=9)
    part = (np.arange(150) % 8).astype(np.int64)
    a, ca = _refine(ref, g, part, 8, 32)
    b, cb = refine_level_vec(g, part, 8, 32, device="cpu")
    assert np.array_equal(a, b) and ca == cb


def test_refine_level_vec_kernel_path_parity():
    """Counterpart of test_refine_vec.py::test_refine_level_vec_kernel_path_parity:
    the degree-kernel path on a CPU tensor (the kernel's plain version)
    gives the numpy path's result and, bitwise, the reference's
    interpret-mode kernel path's."""
    ref, g = pair("random_graph", 120, 0.1, seed=10)
    part = (np.arange(120) % 6).astype(np.int64)
    p_np, c_np = _refine(ref, g, part, 6, 32, use_kernel=False)
    p_kn, c_kn = _refine(ref, g, part, 6, 32, use_kernel=True,
                         ref_kw=dict(use_kernel=True, kernel_backend="interpret"))
    assert np.array_equal(p_np, p_kn) and c_np == c_kn


def test_uncoarsen_vec_end_to_end():
    """Counterpart of test_refine_vec.py::test_uncoarsen_vec_end_to_end."""
    ref, g = pair("random_graph", 300, 0.05, seed=11)
    k, cap = 12, 40
    rng = np.random.default_rng(0)
    levels = coarsen(g, rng, coarsen_to=4 * k, max_vwgt=cap // 3, impl="vec")
    coarse_part = greedy_region_growing(levels[-1], k, cap, rng)
    part, cut = uncoarsen_vec(levels, coarse_part, k, cap, device="cpu")
    ref_rng = np.random.default_rng(0)
    ref_levels = ref_coarsen.coarsen(ref, ref_rng, coarsen_to=4 * k,
                                     max_vwgt=cap // 3, impl="vec")
    assert_levels_equal(levels, ref_levels)
    ref_coarse = ref_initpart.greedy_region_growing(ref_levels[-1], k, cap, ref_rng)
    np.testing.assert_array_equal(coarse_part, ref_coarse)
    want, want_cut = ref_refine_vec.uncoarsen_vec(ref_levels, ref_coarse, k, cap)
    np.testing.assert_array_equal(part, want)
    assert cut == want_cut
    validate_partition(g, part, k, cap)
    assert cut == edge_cut(g, part)


def test_sneap_vec_valid_and_deterministic():
    """Counterpart of test_refine_vec.py::test_sneap_vec_valid_and_deterministic."""
    ref, g = pair("random_graph", 1200, 0.015, seed=12)
    a = _partition(ref, g, capacity=64, seed=5, impl="vec")
    b = sneap_partition(g, capacity=64, seed=5, impl="vec", device="cpu")
    validate_partition(g, a.part, a.k, 64)
    assert np.array_equal(a.part, b.part) and a.edge_cut == b.edge_cut
    assert a.impl == "vec"


def test_sneap_vec_cut_near_scalar():
    """Counterpart of test_refine_vec.py::test_sneap_vec_cut_near_scalar."""
    ref, g = pair("random_graph", 1500, 0.01, seed=13)
    s = _partition(ref, g, capacity=64, seed=0, impl="scalar")
    v = _partition(ref, g, capacity=64, seed=0, impl="vec")
    assert v.edge_cut <= 1.10 * s.edge_cut


def test_sneap_vec_small_graph_routes_scalar():
    """Counterpart of test_refine_vec.py::test_sneap_vec_small_graph_routes_scalar."""
    ref, g = pair("random_graph", 200, 0.08, seed=14)
    s = _partition(ref, g, capacity=32, seed=0, impl="scalar")
    v = _partition(ref, g, capacity=32, seed=0, impl="vec")
    assert np.array_equal(s.part, v.part) and s.edge_cut == v.edge_cut
    assert v.impl == "vec" and s.impl == "scalar"


def test_sneap_rejects_unknown_impl():
    """Counterpart of test_refine_vec.py::test_sneap_rejects_unknown_impl."""
    _, g = pair("random_graph", 50, 0.2, seed=15)
    with pytest.raises(ValueError):
        sneap_partition(g, capacity=32, impl="gpu", device="cpu")


def _sym_counts(n, top):
    a = RNG.integers(0, top, (n, n)).astype(np.float32)
    a = a + a.T
    np.fill_diagonal(a, 0)
    return a


@pytest.mark.parametrize("n,k", [(16, 3), (130, 25), (256, 128), (300, 140)])
def test_gain_eval_degrees_interpret_vs_ref(n, k):
    """Counterpart of test_refine_vec.py::test_gain_eval_degrees_interpret_vs_ref:
    the port's wrapper on CPU tensors and its plain version against the
    reference's interpret-mode kernel and plain version (rtol 1e-5)."""
    a = _sym_counts(n, 50)
    p = RNG.integers(0, k, n).astype(np.int32)
    want = np.asarray(ref_gain_eval.part_degrees_ref(jnp.asarray(a), jnp.asarray(p), k))
    pal = np.asarray(ref_gain_eval.part_degrees(jnp.asarray(a), jnp.asarray(p), k,
                                                backend="interpret"))
    at, pt = torch.from_numpy(a), torch.from_numpy(p)
    got = part_degrees(at, pt, k).numpy()
    np.testing.assert_allclose(got, part_degrees_ref(at, pt, k).numpy(), rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, pal, rtol=1e-5)


def test_gain_eval_gains_interpret_vs_ref():
    """Counterpart of test_refine_vec.py::test_gain_eval_gains_interpret_vs_ref."""
    n, k = 90, 11
    a = _sym_counts(n, 30)
    p = RNG.integers(0, k, n).astype(np.int32)
    want = np.asarray(ref_gain_eval.gain_matrix_ref(jnp.asarray(a), jnp.asarray(p), k))
    at, pt = torch.from_numpy(a), torch.from_numpy(p)
    got = gain_matrix(at, pt, k).numpy()
    np.testing.assert_allclose(got, gain_matrix_ref(at, pt, k).numpy(), rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_array_equal(got[np.arange(n), p], np.zeros(n, np.float32))


def test_gain_eval_degrees_match_csr_bincount():
    """Counterpart of test_refine_vec.py::test_gain_eval_degrees_match_csr_bincount."""
    ref, g = pair("random_graph", 80, 0.15, seed=16)
    k = 9
    part = RNG.integers(0, k, 80).astype(np.int64)
    adj = np.zeros((80, 80), dtype=np.float32)
    src = np.repeat(np.arange(80), np.diff(g.xadj))
    adj[src, g.adjncy] = g.adjwgt
    dense = part_degrees(torch.from_numpy(adj),
                         torch.from_numpy(part.astype(np.int32)), k).numpy()
    np.testing.assert_allclose(dense, partition_degrees(g, part, k))
    np.testing.assert_allclose(dense, np.asarray(ref_gain_eval.part_degrees(
        jnp.asarray(adj), jnp.asarray(part, jnp.int32), k, backend="interpret")))
