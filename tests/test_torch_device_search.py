"""The port's device searches (`core.mapping_device`) against the reference's
`repro.core.mapping_jax` on the CPU: the greedy polish bitwise on exact
(small-integer) traffic, the population SA within the reference's quality
bound, and the toolchain with ``mapper="polish" | "sa_jax"`` and
``stepper="jax"`` against the reference's run."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.core import mapping_jax as ref_mj  # noqa: E402
from repro.core import run_toolchain as ref_run_toolchain  # noqa: E402
from repro.core.hopcost import swap_delta as ref_swap_delta  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import ToolchainConfig, mapping_phase, partition_phase  # noqa: E402
from repro_torch.core import run_toolchain  # noqa: E402
from repro_torch.core.hopcost import hop_distance_matrix  # noqa: E402
from repro_torch.core.mapping import (  # noqa: E402
    DEVICE_MAPPERS,
    MAPPERS,
    pad_traffic,
    sa_search,
)
from repro_torch.core import mapping_device as md  # noqa: E402

CORES, W = 25, 5
SECONDS = ("partition_s", "mapping_s", "evaluate_s", "total_s")
EXACT_F32 = 2 ** 24


def _instance(k=15, seed=0):
    """tests/test_mapping_jax.py's instance: integer traffic in [0, 100)."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 100, (k, k)).astype(np.float64)
    np.fill_diagonal(c, 0)
    return c, int(c.sum())


def _sym(c):
    padded = pad_traffic(c, CORES)
    return padded + padded.T


def _xy():
    return ((np.arange(CORES) % W).astype(np.float32),
            (np.arange(CORES) // W).astype(np.float32))


def _cost(sym, pl):
    dist = hop_distance_matrix(CORES, W).astype(np.float64)
    return (dist[pl[:, None], pl[None, :]] * sym).sum() / 2


@pytest.mark.parametrize("seed,start_seed", [(3, 0), (5, 1)])
def test_greedy_polish_matches_reference_bitwise(seed, start_seed):
    c, _ = _instance(seed=seed)
    sym = _sym(c)
    start = np.random.default_rng(start_seed).permutation(CORES)
    x, y = _xy()
    want, want_steps = ref_mj.greedy_polish(
        jnp.asarray(sym, jnp.float32), jnp.asarray(start), jnp.asarray(x),
        jnp.asarray(y), backend="jnp")
    got, steps = md.greedy_polish(torch.tensor(sym, dtype=torch.float32),
                                  torch.tensor(start), torch.tensor(x),
                                  torch.tensor(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == want_steps >= 1
    pl = got.numpy()
    dist = hop_distance_matrix(CORES, W).astype(np.float64)
    best = min(ref_swap_delta(sym, pl, dist, a, b)
               for a in range(CORES) for b in range(a + 1, CORES))
    assert best >= -1e-3  # a swap-local optimum
    assert _cost(sym, pl) <= _cost(sym, start)  # never worse than the start


@pytest.mark.parametrize("seed", [3, 5])
def test_polish_search_matches_reference_bitwise(seed):
    c, trace_len = _instance(seed=seed)
    want = ref_mj.polish_search(c, CORES, W, trace_len, seed=seed, backend="jnp")
    got = md.polish_search(c, CORES, W, trace_len, seed=seed, device="cpu")
    np.testing.assert_array_equal(got.placement, want.placement)
    assert (got.avg_hop, got.history, got.evaluations) == (
        want.avg_hop, want.history, want.evaluations)


def test_polish_search_refuses_torus():
    c, trace_len = _instance()
    with pytest.raises(ValueError, match="mesh-only"):
        md.polish_search(c, CORES, W, trace_len, torus=True, device="cpu")


def test_delta_one_matches_reference_on_fixed_proposals():
    """The batched O(K) delta of every chain equals the reference's jnp
    `_delta_one` and the host formula exactly on integer traffic."""
    c, _ = _instance(seed=7)
    sym = _sym(c)
    dist = hop_distance_matrix(CORES, W).astype(np.float32)
    rng = np.random.default_rng(0)
    placements = np.stack([rng.permutation(CORES) for _ in range(6)])
    a = rng.integers(0, CORES, 6)
    b = (a + 1 + rng.integers(0, CORES - 1, 6)) % CORES
    got = md._delta_one(torch.tensor(sym, dtype=torch.float32),
                        torch.tensor(dist), torch.tensor(placements),
                        torch.tensor(a), torch.tensor(b)).numpy()
    for p in range(6):
        want = ref_mj._delta_one(jnp.asarray(sym, jnp.float32),
                                 jnp.asarray(dist), jnp.asarray(placements[p]),
                                 int(a[p]), int(b[p]))
        assert got[p] == float(want)
        assert got[p] == ref_swap_delta(sym, placements[p], dist.astype(np.float64),
                                        int(a[p]), int(b[p]))


def test_sa_search_jax_competitive_with_numpy_sa():
    """The reference's bound (tests/test_mapping_jax.py): within 1.15x of
    the serial numpy SA, and injective."""
    c, trace_len = _instance()
    r_np = sa_search(c, CORES, W, trace_len, seed=0, iters=15_000, device="cpu")
    r = md.sa_search_jax(c, CORES, W, trace_len, seed=0, iters=2_000, chains=4,
                         device="cpu")
    assert r.avg_hop <= r_np.avg_hop * 1.15
    assert len(set(r.placement.tolist())) == 15
    assert r.evaluations == 2_000 * 4
    assert len(r.history) == 2_000 // 64
    assert all(h1[1] <= h0[1] for h0, h1 in zip(r.history, r.history[1:]))


def test_sa_search_jax_is_deterministic_per_seed():
    c, trace_len = _instance(seed=2)
    kw = dict(seed=11, iters=640, chains=3, device="cpu")
    a = md.sa_search_jax(c, CORES, W, trace_len, **kw)
    b = md.sa_search_jax(c, CORES, W, trace_len, **kw)
    np.testing.assert_array_equal(a.placement, b.placement)
    assert a.avg_hop == b.avg_hop and a.history == b.history
    # Without the polish the chains' end state is reported as is.
    raw = md.sa_search_jax(c, CORES, W, trace_len, polish=False, **kw)
    assert raw.avg_hop >= a.avg_hop


@pytest.fixture(scope="module")
def smooth_320():
    return profile_snn(make_snn("smooth_320"), num_steps=300, seed=0)


def _exact_f32(traffic: np.ndarray, num_cores: int, mesh_w: int) -> bool:
    """Every swap delta's and cost's f32 sum is exact: each term and every
    partial sum is an integer below 2^24."""
    sym = traffic + traffic.T
    dmax = int(hop_distance_matrix(num_cores, mesh_w).max())
    return (2 * float(sym.sum(1).max()) * dmax < EXACT_F32
            and float(sym.sum()) * dmax < EXACT_F32)


@pytest.mark.parametrize("capacity", [256, 16])
@pytest.mark.parametrize("objective", ["cut", "volume"])
@pytest.mark.parametrize("mapper", ["polish", "sa_jax"])
def test_run_toolchain_device_mappers_match_reference(smooth_320, mapper,
                                                      objective, capacity):
    """``mapper="polish"`` is held to the reference's summary() bitwise
    where every swap delta's f32 sums stay exact, and to swap_delta's
    rtol 1e-4 on avg_hop otherwise; ``"sa_jax"`` draws from a
    torch.Generator, so it is held to the reference's 1.15x quality bound
    and to the reference's replay of its own placement."""
    mk = {"iters": 2_000, "chains": 4} if mapper == "sa_jax" else {}
    ref_mk = dict(mk, **({"polish_backend": "jnp"} if mapper == "sa_jax"
                         else {"backend": "jnp"}))
    kw = dict(mesh_w=W, mesh_h=W, seed=0, mapper=mapper, objective=objective,
              capacity=capacity, noc_kwargs={"stepper": "jax", "screen": "linkload"})
    want = ref_run_toolchain(smooth_320, mapper_kwargs=ref_mk, **kw)
    got = run_toolchain(interop.profile_from(smooth_320), mapper_kwargs=mk,
                        device="cpu", **kw)
    a = {k: v for k, v in got.summary().items() if k not in SECONDS}
    b = {k: v for k, v in want.summary().items() if k not in SECONDS}
    assert a["place_objective"] == "pairwise"  # the default tree falls back
    assert got.noc.congestion_count > 0  # the device stepper really ran
    if mapper == "polish":
        traffic = _traffic(got, smooth_320, objective, capacity)
        if _exact_f32(traffic, CORES, W):
            assert a == b, "exact f32 sums: the summary must be bitwise"
            np.testing.assert_array_equal(got.mapping.placement,
                                          want.mapping.placement)
        else:
            assert got.mapping.avg_hop == pytest.approx(
                want.mapping.avg_hop, rel=1e-4), \
                "inexact f32 sums: avg_hop within swap_delta's rtol 1e-4"
        return
    assert a["avg_hop"] <= 1.15 * b["avg_hop"]
    assert len(set(got.mapping.placement.tolist())) == got.partition.k
    replayed = ref_run_toolchain(
        smooth_320, mapper="polish", mapper_kwargs={
            "init": np.concatenate([got.mapping.placement, np.setdiff1d(
                np.arange(CORES), got.mapping.placement)]),
            "max_steps": 0, "backend": "jnp"},
        **{k: v for k, v in kw.items() if k != "mapper"})
    r = {k: v for k, v in replayed.summary().items() if k not in SECONDS}
    assert a == r


def _traffic(res, prof, objective, capacity):
    from repro_torch.core.pipeline import build_traffic

    cfg = ToolchainConfig(mesh_w=W, mesh_h=W, objective=objective,
                          capacity=capacity,
                          device="cpu").resolve(prof.graph.hyper)
    return build_traffic(interop.profile_from(prof), res.partition, cfg) \
        .astype(np.float64)


def test_device_mappers_refuse_an_explicit_tree_objective(smooth_320):
    prof = interop.profile_from(smooth_320)
    cfg = ToolchainConfig(mesh_w=W, mesh_h=W, objective="volume",
                          mapper="polish", place_objective="tree", device="cpu")
    pres = partition_phase(prof, cfg)
    with pytest.raises(ValueError, match="tree objective"):
        mapping_phase(prof, pres, cfg)


@pytest.mark.parametrize("mapper", sorted(DEVICE_MAPPERS))
def test_mapping_phase_threads_the_config_device(smooth_320, monkeypatch,
                                                 mapper):
    """Every device-capable mapper gets ``cfg.device``, so a CPU config
    never reaches for the card."""
    seen = {}
    inner = MAPPERS[mapper]

    def spy(*args, **kwargs):
        seen["device"] = kwargs.get("device")
        return inner(*args, **kwargs)

    monkeypatch.setitem(MAPPERS, mapper, spy)
    prof = interop.profile_from(smooth_320)
    cfg = ToolchainConfig(mesh_w=W, mesh_h=W, mapper=mapper, device="cpu",
                          mapper_kwargs={"iters": 640, "chains": 2}
                          if mapper == "sa_jax" else {"iters": 200}
                          if mapper == "sa" else {})
    mapping_phase(prof, partition_phase(prof, cfg), cfg)
    assert seen["device"] == "cpu"
