"""tests/test_mapping_jax.py held against the port on the CPU: the
population SA (the port draws from a torch.Generator, not jax.random, so
it is held to the reference test's 1.15x quality bound, and its chains'
O(K) deltas exactly to the reference's on fixed proposals) and the greedy
polish (the port's swap_deltas wrapper on CPU tensors: the placement and
step count bitwise the reference's jnp polish)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mapping as ref_mapping  # noqa: E402
from repro.core import mapping_jax as ref_mj  # noqa: E402
from repro.core.hopcost import swap_delta as ref_swap_delta  # noqa: E402
from torch_parity import assert_mapping_equal  # noqa: E402

from repro_torch.core import mapping_device as md  # noqa: E402
from repro_torch.core.hopcost import hop_distance_matrix, swap_delta  # noqa: E402
from repro_torch.core.mapping import pad_traffic, sa_search  # noqa: E402
from repro_torch.core.mapping_device import greedy_polish, sa_search_jax  # noqa: E402


def _instance(k=15, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 100, (k, k)).astype(np.float64)
    np.fill_diagonal(c, 0)
    return c, int(c.sum())


def _polish(sym, placement, cores, w):
    """The port's greedy polish on CPU tensors, bitwise the reference's."""
    x = (np.arange(cores) % w).astype(np.float32)
    y = (np.arange(cores) // w).astype(np.float32)
    out, steps = greedy_polish(torch.tensor(sym, dtype=torch.float32),
                               torch.tensor(placement), torch.from_numpy(x),
                               torch.from_numpy(y))
    want, want_steps = ref_mj.greedy_polish(
        jnp.asarray(sym, jnp.float32), jnp.asarray(placement), jnp.asarray(x),
        jnp.asarray(y), backend="jnp")
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert steps == want_steps
    return out.numpy(), steps


def test_sa_jax_competitive_with_numpy_sa():
    """Counterpart of test_mapping_jax.py::test_sa_jax_competitive_with_numpy_sa."""
    c, trace_len = _instance()
    kw = dict(seed=0, iters=15_000)
    r_np = sa_search(c, 25, 5, trace_len, device="cpu", **kw)
    assert_mapping_equal(r_np, ref_mapping.sa_search(c, 25, 5, trace_len, **kw))
    r_dev = sa_search_jax(c, 25, 5, trace_len, seed=0, iters=2_000, chains=4,
                          device="cpu")
    assert r_dev.avg_hop <= r_np.avg_hop * 1.15
    assert len(set(r_dev.placement.tolist())) == 15
    # The chains' O(K) deltas on fixed proposals: exact, the reference's.
    padded = pad_traffic(c, 25)
    sym = padded + padded.T
    dist = hop_distance_matrix(25, 5).astype(np.float64)
    rng = np.random.default_rng(0)
    placements = np.stack([rng.permutation(25) for _ in range(8)])
    a = rng.integers(0, 25, 8)
    b = (a + 1 + rng.integers(0, 24, 8)) % 25
    got = md._delta_one(torch.tensor(sym), torch.tensor(dist),
                        torch.tensor(placements), torch.tensor(a),
                        torch.tensor(b)).numpy()
    for p in range(8):
        want = ref_mj._delta_one(jnp.asarray(sym, jnp.float32),
                                 jnp.asarray(dist, jnp.float32),
                                 jnp.asarray(placements[p]), int(a[p]), int(b[p]))
        assert got[p] == float(want) == swap_delta(sym, placements[p], dist,
                                                   int(a[p]), int(b[p]))


def test_greedy_polish_reaches_swap_local_optimum():
    """Counterpart of test_mapping_jax.py::test_greedy_polish_reaches_swap_local_optimum."""
    c, trace_len = _instance(seed=3)
    cores, w = 25, 5
    padded = pad_traffic(c, cores)
    sym = (padded + padded.T).astype(np.float32)
    rng = np.random.default_rng(0)
    pl, steps = _polish(sym, rng.permutation(cores), cores, w)
    dist = hop_distance_matrix(cores, w).astype(np.float64)
    sym_np = sym.astype(np.float64)
    best = min(ref_swap_delta(sym_np, pl, dist, a, b)
               for a in range(cores) for b in range(a + 1, cores))
    assert best >= -1e-3
    assert steps >= 1


def test_polish_never_worsens():
    """Counterpart of test_mapping_jax.py::test_polish_never_worsens."""
    c, trace_len = _instance(seed=5)
    cores, w = 25, 5
    padded = pad_traffic(c, cores)
    sym_np = padded + padded.T
    dist = hop_distance_matrix(cores, w).astype(np.float64)
    rng = np.random.default_rng(1)
    placement = rng.permutation(cores)

    def cost(pl):
        return (dist[pl[:, None], pl[None, :]] * sym_np).sum() / 2

    before = cost(placement)
    out, _ = _polish(sym_np, placement, cores, w)
    assert cost(out) <= before + 1e-6
