"""tests/test_hopcost.py held against the port on the CPU: traffic
matrices, hop distances, Algorithm 1 and the scalar swap delta, each with
the reference's invariants and bitwise the reference's on the same
inputs."""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")  # as the reference suite
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import hopcost as ref  # noqa: E402
from torch_parity import assert_bitwise  # noqa: E402

from repro_torch.core.hopcost import (average_hop, hop_distance_matrix,  # noqa: E402
                                      swap_delta, traffic_matrix)


def test_traffic_matrix_counts():
    """Counterpart of test_hopcost.py::test_traffic_matrix_counts."""
    part = np.array([0, 0, 1, 2])
    src = np.array([0, 1, 2, 3, 0])
    dst = np.array([2, 3, 0, 0, 1])
    c = traffic_matrix(part, src, dst, 3)
    assert c[0, 1] == 1 and c[0, 2] == 1 and c[1, 0] == 1 and c[2, 0] == 1
    assert c[0, 0] == 1  # intra-partition spike 0->1
    assert c.sum() == 5
    assert_bitwise(c, ref.traffic_matrix(part, src, dst, 3))


def test_hop_distance_vs_manual():
    """Counterpart of test_hopcost.py::test_hop_distance_vs_manual."""
    d = hop_distance_matrix(25, 5)
    assert d[0, 24] == 8
    assert d[0, 0] == 0
    assert d[7, 9] == 2  # (2,1)->(4,1)
    dt = hop_distance_matrix(25, 5, torus=True)
    assert dt[0, 4] == 1  # (0,0)->(4,0) wraps
    assert_bitwise(d, ref.hop_distance_matrix(25, 5))
    assert_bitwise(dt, ref.hop_distance_matrix(25, 5, torus=True))


def test_average_hop_algorithm1_matches_bruteforce():
    """Counterpart of test_hopcost.py::test_average_hop_algorithm1_matches_bruteforce."""
    rng = np.random.default_rng(0)
    n_neurons, k, cores, w = 50, 6, 25, 5
    part = rng.integers(0, k, n_neurons)
    placement = rng.permutation(cores)[:k]
    src = rng.integers(0, n_neurons, 500)
    dst = rng.integers(0, n_neurons, 500)
    dist = hop_distance_matrix(cores, w)
    c = traffic_matrix(part, src, dst, k)
    h = average_hop(c, placement, dist, 500)
    brute = np.mean([dist[placement[part[s]], placement[part[d]]]
                     for s, d in zip(src, dst)])
    np.testing.assert_allclose(h, brute, rtol=1e-12)
    assert h == ref.average_hop(c, placement, dist, 500)


@given(k=st.integers(3, 20), seed=st.integers(0, 5000))
@settings(max_examples=30, deadline=None)
def test_swap_delta_matches_recompute(k, seed):
    """Counterpart of test_hopcost.py::test_swap_delta_matches_recompute."""
    rng = np.random.default_rng(seed)
    cores, w = 25, 5
    c = rng.integers(0, 50, (k, k)).astype(np.float64)
    padded = np.zeros((cores, cores))
    padded[:k, :k] = c
    sym = padded + padded.T
    placement = rng.permutation(cores)
    dist = hop_distance_matrix(cores, w).astype(np.float64)
    a, b = rng.choice(cores, 2, replace=False)

    def total(pl):
        return (dist[pl[:, None], pl[None, :]] * sym).sum() / 2

    before = total(placement)
    delta = swap_delta(sym, placement, dist, int(a), int(b))
    assert delta == ref.swap_delta(sym, placement, dist, int(a), int(b))
    placement[a], placement[b] = placement[b], placement[a]
    after = total(placement)
    np.testing.assert_allclose(delta, after - before, rtol=1e-9, atol=1e-9)
