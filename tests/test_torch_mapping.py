"""tests/test_mapping.py held against the port on the CPU: SA, PSO and tabu
placement search, injectivity, determinism, SA's lead over the other
mappers, and pad_traffic — every search's placement, cost, evaluations
and history costs bitwise the reference's on the same traffic and seed."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import mapping as ref_mapping  # noqa: E402
from torch_parity import assert_mapping_equal  # noqa: E402

from repro_torch.core.hopcost import hop_distance_matrix  # noqa: E402
from repro_torch.core.mapping import DEVICE_MAPPERS, MAPPERS, pad_traffic  # noqa: E402


def _instance(k=20, cores=25, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 200, (k, k)).astype(np.float64)
    np.fill_diagonal(c, 0)
    return c, int(c.sum())


def _cost_of(placement, traffic, cores, w, trace_len):
    padded = pad_traffic(traffic, cores)
    dist = hop_distance_matrix(cores, w)
    d = dist[placement[:, None], placement[None, :]]
    return float((d * padded[: len(placement), : len(placement)]).sum() / trace_len)


def _search(mapper, *args, **kw):
    """The port's mapper (on the CPU), bitwise the reference's."""
    dev = {"device": "cpu"} if mapper in DEVICE_MAPPERS else {}
    got = MAPPERS[mapper](*args, **kw, **dev)
    assert_mapping_equal(got, ref_mapping.MAPPERS[mapper](*args, **kw))
    return got


@pytest.mark.parametrize("mapper", ["sa", "pso", "tabu"])
def test_mapper_improves_over_random(mapper):
    """Counterpart of test_mapping.py::test_mapper_improves_over_random."""
    c, trace_len = _instance()
    kwargs = {"sa": dict(iters=8000), "pso": dict(iters=40, swarm=16),
              "tabu": dict(iters=60, candidates=64)}[mapper]
    res = _search(mapper, c, 25, 5, trace_len, seed=0, **kwargs)
    rng = np.random.default_rng(1)
    rand = np.mean([
        _cost_of(rng.permutation(25)[:20], c, 25, 5, trace_len) for _ in range(20)
    ])
    assert res.avg_hop < rand
    np.testing.assert_allclose(
        res.avg_hop, _cost_of(res.placement, c, 25, 5, trace_len), rtol=1e-9)


def test_placement_is_injective():
    """Counterpart of test_mapping.py::test_placement_is_injective."""
    c, trace_len = _instance(k=25)
    res = _search("sa", c, 25, 5, trace_len, seed=0, iters=5000)
    assert len(set(res.placement.tolist())) == 25


def test_sa_deterministic():
    """Counterpart of test_mapping.py::test_sa_deterministic."""
    c, trace_len = _instance(seed=2)
    a = _search("sa", c, 25, 5, trace_len, seed=7, iters=4000)
    b = MAPPERS["sa"](c, 25, 5, trace_len, seed=7, iters=4000, device="cpu")
    assert np.array_equal(a.placement, b.placement)


def test_sa_usually_best_among_mappers():
    """Counterpart of test_mapping.py::test_sa_usually_best_among_mappers."""
    wins = 0
    for seed in range(3):
        c, trace_len = _instance(seed=seed)
        sa = _search("sa", c, 25, 5, trace_len, seed=seed, iters=12_000)
        pso = _search("pso", c, 25, 5, trace_len, seed=seed, iters=40, swarm=16)
        tabu = _search("tabu", c, 25, 5, trace_len, seed=seed, iters=50,
                       candidates=64)
        if sa.avg_hop <= min(pso.avg_hop, tabu.avg_hop) + 1e-9:
            wins += 1
    assert wins >= 2


def test_pad_traffic_rejects_too_many_partitions():
    """Counterpart of test_mapping.py::test_pad_traffic_rejects_too_many_partitions."""
    with pytest.raises(ValueError):
        pad_traffic(np.ones((30, 30)), 25)
    c, _ = _instance()
    got = pad_traffic(c, 25)
    want = ref_mapping.pad_traffic(c, 25)
    assert got.dtype == want.dtype and np.array_equal(got, want)
