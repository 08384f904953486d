"""The island SA across gloo ranks against the batched islands.

tests/test_island_sa.py's inputs (k = 12 on 16 cores of a 4-wide mesh,
2 rounds x 1,500 steps, 2 chains an island) through
`mapping_device.island_sa(mesh=..., axis="data")` with one island a rank
(`run_ranks`, 4 CPU ranks, one job) and through the batched
``island_sa(n_dev=4, device="cpu")``: every rank returns the batched
run's placement and avg_hop bit for bit, for each seed.  The reference's
own island test fails on this tree (jax's explicit-axis meshes), so the
batched islands are the oracle, as tests/test_torch_island_sa.py holds
them to the reference's quality bound."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ranks_bodies as bodies  # noqa: E402
from repro_torch.core.mapping_device import island_sa  # noqa: E402
from repro_torch.launch.mesh import backend_for, run_ranks  # noqa: E402

K, CORES, W = 12, 16, 4
KW = dict(rounds=2, iters_per_round=1500, chains_per_device=2)
SEEDS = [0, 1, 7]


@pytest.fixture(scope="module")
def traffic():
    rng = np.random.default_rng(0)
    c = rng.integers(0, 100, (K, K)).astype(np.float64)
    np.fill_diagonal(c, 0)
    return c, int(c.sum())


@pytest.fixture(scope="module")
def ranks(traffic, tmp_path_factory):
    c, tl = traffic
    return run_ranks(bodies.islands, 4, tmp_path_factory.mktemp("island_ranks"),
                     c, CORES, W, tl, SEEDS, KW, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_island_sa_on_four_ranks_equals_the_batched_islands(traffic, ranks, seed):
    c, tl = traffic
    want = island_sa(c, CORES, W, tl, n_dev=4, seed=seed, device="cpu", **KW)
    for r in ranks:
        got = r[seed]
        np.testing.assert_array_equal(got["placement"], want.placement)
        assert got["avg_hop"] == want.avg_hop
        assert got["evaluations"] == want.evaluations == 2 * 1500 * 4 * 2


def test_cpu_ranks_take_gloo():
    """The backend rule on the host: CPU tensors go over gloo (NCCL is
    for CUDA ranks with a card each, which this test cannot see)."""
    assert backend_for("cpu", 1) == backend_for("cpu", 4) == "gloo"
