"""The engine cases of the reference's main-path suites on the card: each
runs the port with ``device="cuda"`` (the hand-written kernels:
replay_screen in the unicast replay's screens, link_loads in the multicast
replay's, swap_deltas in the SA scorer and the polish,
part_degrees and connectivity_degrees in the vec refiner, lif_step in the
profile) and with ``device="cpu"`` (their plain versions) on the same
inputs, and holds the two equal: bitwise for integer results, placements
and every NoCStats field; exact for swap_deltas' f32 deltas on integer
traffic.  The CPU side is held bitwise to the reference by the
``tests/test_torch_<suite>.py`` counterparts, so these cases tie the card
to the reference.  Each case also checks that its kernels launched.  Every
test is marked ``cuda`` and skips where CUDA is unavailable; this file
imports torch, numpy and the port only (its inputs come from
``tests/torch_builders.py``), so it runs where JAX is not installed.

    python -m pytest -q -m cuda tests/test_torch_cuda_engines.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_builders import (fanout_snn_graph, random_graph,  # noqa: E402
                            random_hypergraph, random_spike_trace)

from repro_torch.core import run_toolchain  # noqa: E402
from repro_torch.core.graph import comm_volume, edge_cut, validate_partition  # noqa: E402
from repro_torch.core.initpart import greedy_region_growing  # noqa: E402
from repro_torch.core.mapping import MAPPERS, sa_search  # noqa: E402
from repro_torch.core.placecost import PairwiseObjective  # noqa: E402
from repro_torch.core.refine_vec import refine_level_vec  # noqa: E402
from repro_torch.kernels.gain_eval import kernel as gain_kernel  # noqa: E402
from repro_torch.kernels.gain_eval import part_degrees  # noqa: E402
from repro_torch.kernels.lif_step import kernel as lif_kernel  # noqa: E402
from repro_torch.kernels.link_load import kernel as link_kernel  # noqa: E402
from repro_torch.kernels.swap_delta import kernel as swap_kernel  # noqa: E402
from repro_torch.kernels.swap_delta import swap_deltas_pairs  # noqa: E402
from repro_torch.nocsim import simulate_noc  # noqa: E402
from repro_torch.snn import make_snn, profile_snn  # noqa: E402

CARD_REPLAY = dict(screen="linkload", stepper="jax")


@pytest.fixture
def cuda():
    """The card, or a skip where CUDA (and so nvcc's kernels) is absent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


class launched:
    """Asserts on exit that each named kernel counter grew."""

    COUNTERS = {"link_loads": (link_kernel, "launches"),
                "replay_screen": (link_kernel, "screen_launches"),
                "swap_deltas": (swap_kernel, "launches"),
                "part_degrees": (gain_kernel, "launches"),
                "connectivity_degrees": (gain_kernel, "connectivity_launches"),
                "lif_step": (lif_kernel, "launches")}

    def __init__(self, *names):
        self.names = names

    def __enter__(self):
        self.before = {n: getattr(*self.COUNTERS[n]) for n in self.names}
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            for n in self.names:
                assert getattr(*self.COUNTERS[n]) > self.before[n], n


def same_stats(a, b) -> list[str]:
    """Names of the NoCStats fields that differ (bitwise for arrays)."""
    out = []
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not (np.array_equal(x, y) if isinstance(y, np.ndarray) else x == y):
            out.append(f.name)
    return out


def screen_kernel(cast: str = "unicast") -> str:
    """The kernel of the link-load screen of a ``cast`` replay."""
    return "replay_screen" if cast == "unicast" else "link_loads"


def replay(cuda, *args, **kw):
    """One replay on the card (link-load screen, torch stepper) against the
    same replay on the CPU; returns the card's stats."""
    with launched(screen_kernel(kw.get("cast", "unicast"))):
        got = simulate_noc(*args, device=cuda, **CARD_REPLAY, **kw)
    want = simulate_noc(*args, device="cpu", **CARD_REPLAY, **kw)
    assert same_stats(got, want) == []
    return got


# -------------------------------------------- tests/test_nocsim_engines.py


@pytest.mark.cuda
@pytest.mark.parametrize("link_capacity,inject_capacity", [
    (1, 256), (2, 256), (4, 3), (2, 1), (10_000, 256),
])
def test_batched_matches_ref_exactly(cuda, link_capacity, inject_capacity):
    """test_nocsim_engines.py::test_batched_matches_ref_exactly on the card:
    the card's replay equals the CPU's and the scalar engine's."""
    for seed in range(4):
        args = (*random_spike_trace(seed=seed, n_spikes=1500, timesteps=8), 3, 3)
        kw = dict(link_capacity=link_capacity, inject_capacity=inject_capacity)
        got = replay(cuda, *args, **kw)
        ref = simulate_noc(*args, engine="ref", device="cpu", **kw)
        assert same_stats(got, ref) == [], (seed, link_capacity)


@pytest.mark.cuda
def test_congested_windows_actually_step(cuda):
    """test_nocsim_engines.py::test_congested_windows_actually_step on the card."""
    args = (*random_spike_trace(seed=0, n_spikes=1500, timesteps=8), 3, 3)
    jam = replay(cuda, *args, link_capacity=1)
    assert jam.congestion_count > 0
    assert jam.avg_latency > jam.avg_hop


@pytest.mark.cuda
def test_screen_backends_do_not_change_results(cuda):
    """test_nocsim_engines.py::test_screen_backends_do_not_change_results on
    the card: the link-load screen there against the CPU's numpy screen."""
    args = (*random_spike_trace(seed=2, n_spikes=800, timesteps=6), 3, 3)
    for cast in ("unicast", "multicast"):
        base = simulate_noc(*args, link_capacity=2, cast=cast, device="cpu")
        with launched(screen_kernel(cast)):
            got = simulate_noc(*args, link_capacity=2, cast=cast,
                               screen="linkload", device=cuda)
        assert same_stats(got, base) == [], cast


def _shuffle_within_steps(t, src, dst, seed):
    rng = np.random.default_rng(seed)
    idx = np.arange(t.shape[0])
    for v in np.unique(t):
        m = np.flatnonzero(t == v)
        idx[m] = rng.permutation(idx[m])
    return src[idx], dst[idx]


@pytest.mark.cuda
@pytest.mark.parametrize("cast", ["unicast", "multicast"])
def test_stats_invariant_under_within_step_permutation(cuda, cast):
    """test_nocsim_engines.py::test_stats_invariant_under_within_step_permutation
    (the batched engine) on the card."""
    t, src, dst, part, placement = random_spike_trace(seed=9, n_spikes=1200,
                                                      timesteps=6)
    kw = dict(link_capacity=2, inject_capacity=3, cast=cast)
    base = replay(cuda, t, src, dst, part, placement, 3, 3, **kw)
    for pseed in (1, 2):
        s2, d2 = _shuffle_within_steps(t, src, dst, pseed)
        got = replay(cuda, t, s2, d2, part, placement, 3, 3, **kw)
        assert same_stats(base, got) == [], (cast, pseed)


# ---------------------------------------------- tests/test_multicast_noc.py


@pytest.mark.cuda
def test_multicast_queued_matches_analytic_static_quantities(cuda):
    """test_multicast_noc.py::test_multicast_queued_matches_analytic_static_quantities
    with the queued replay on the card."""
    args = (*random_spike_trace(seed=4), 3, 3)
    a = simulate_noc(*args, mode="analytic", cast="multicast", device="cpu")
    q = replay(cuda, *args, link_capacity=10_000, cast="multicast")
    assert a.num_noc_spikes == q.num_noc_spikes
    assert a.total_hops == q.total_hops
    assert a.link_traversals == q.link_traversals
    np.testing.assert_allclose(a.edge_variance, q.edge_variance)
    np.testing.assert_allclose(a.dynamic_energy_pj, q.dynamic_energy_pj)
    assert q.congestion_count == 0
    np.testing.assert_allclose(q.avg_latency, q.avg_hop)


@pytest.mark.cuda
def test_multicast_never_costs_more_energy_than_unicast(cuda):
    """test_multicast_noc.py::test_multicast_never_costs_more_energy_than_unicast
    with queued replays on the card."""
    args = (*random_spike_trace(seed=5, n_spikes=1000), 3, 3)
    uni = replay(cuda, *args)
    multi = replay(cuda, *args, cast="multicast")
    assert multi.dynamic_energy_pj <= uni.dynamic_energy_pj
    assert multi.num_noc_spikes <= uni.num_noc_spikes
    assert multi.link_traversals <= uni.link_traversals


@pytest.mark.cuda
def test_tree_engine_is_the_multicast_default(cuda):
    """test_nocsim_engines.py::test_tree_engine_is_the_multicast_default on
    the card: the tree-fork replay against the replica engine."""
    args = (*random_spike_trace(seed=7, n_spikes=1500), 3, 3)
    tree = replay(cuda, *args, link_capacity=1, cast="multicast")
    repl = simulate_noc(*args, link_capacity=1, cast="multicast", engine="ref",
                        device="cpu")
    assert tree.link_traversals < tree.total_hops
    assert tree.avg_latency < repl.avg_latency


@pytest.mark.cuda
def test_tree_static_quantities_match_replica_engine(cuda):
    """test_nocsim_engines.py::test_tree_static_quantities_match_replica_engine on the card."""
    args = (*random_spike_trace(seed=6, n_spikes=1500), 3, 3)
    for cap in (1, 4, 10_000):
        tree = replay(cuda, *args, link_capacity=cap, cast="multicast")
        repl = simulate_noc(*args, link_capacity=cap, cast="multicast",
                            engine="ref", device="cpu")
        for f in ("num_noc_spikes", "num_local_spikes", "total_hops",
                  "link_traversals", "dynamic_energy_pj", "edge_variance"):
            assert getattr(tree, f) == getattr(repl, f), (cap, f)
        np.testing.assert_array_equal(tree.per_link_hops, repl.per_link_hops)


@pytest.mark.cuda
@pytest.mark.parametrize("link_capacity", [1, 2, 4])
def test_tree_latency_tighter_than_replica_per_window(cuda, link_capacity):
    """test_nocsim_engines.py::test_tree_latency_tighter_than_replica_per_window on the card."""
    t, src, dst, part, placement = random_spike_trace(seed=5, n_spikes=1200,
                                                      timesteps=6)
    for step_t in np.unique(t):
        m = t == step_t
        args = (t[m], src[m], dst[m], part, placement, 3, 3)
        kw = dict(cast="multicast", link_capacity=link_capacity)
        wtree = replay(cuda, *args, **kw)
        wrepl = simulate_noc(*args, engine="ref", device="cpu", **kw)
        assert wtree.avg_latency <= wrepl.avg_latency + 1e-12
        assert wtree.max_latency <= wrepl.max_latency
        assert wtree.congestion_count <= wrepl.congestion_count


# ---------------------------------------------- tests/test_mapping_engines.py


def _pairwise_instance(k=20, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 200, (k, k)).astype(np.float64)
    np.fill_diagonal(c, 0)
    return c, int(c.sum())


@pytest.mark.cuda
def test_kernel_score_backend_matches_numpy_deltas(cuda):
    """test_mapping_engines.py::test_kernel_score_backend_matches_numpy_deltas
    on the card: K = 15 on a 5x5 mesh; the kernel's f32 deltas equal the
    plain version's (integer traffic) and the numpy batch within the
    reference test's rtol 1e-4 / atol 1e-3."""
    c, _ = _pairwise_instance(k=15, seed=3)
    rng = np.random.default_rng(0)
    nc, w = 25, 5
    obj = PairwiseObjective(c, nc, w)
    placement = rng.permutation(nc).astype(np.int64)
    obj.attach(placement)
    aa = rng.integers(0, nc, 64)
    b0 = rng.integers(0, nc - 1, 64)
    bb = np.where(b0 >= aa, b0 + 1, b0)
    x = (np.arange(nc) % w).astype(np.float32)
    y = (np.arange(nc) // w).astype(np.float32)
    args = [torch.tensor(obj.sym, dtype=torch.float32),
            torch.from_numpy(x[placement]), torch.from_numpy(y[placement]),
            torch.from_numpy(aa), torch.from_numpy(bb)]
    with launched("swap_deltas"):
        got = swap_deltas_pairs(*(a.to(cuda) for a in args)).cpu()
    assert torch.equal(got, swap_deltas_pairs(*args))
    np.testing.assert_allclose(got.numpy(), obj.swap_delta_batch(aa, bb),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_vec_sa_with_kernel_scoring_runs(cuda):
    """test_mapping_engines.py::test_vec_sa_with_kernel_scoring_runs on the
    card: the kernel-scored vec SA commits the CPU run's swaps."""
    c, tl = _pairwise_instance(seed=6)
    kw = dict(seed=0, iters=1500, impl="vec", batch=32, score_backend="auto")
    with launched("swap_deltas"):
        r = sa_search(c, 25, 5, tl, device=cuda, **kw)
    want = sa_search(c, 25, 5, tl, device="cpu", **kw)
    assert len(set(r.placement.tolist())) == 20
    np.testing.assert_array_equal(r.placement, want.placement)
    assert (r.avg_hop, r.evaluations) == (want.avg_hop, want.evaluations)
    assert [h for _, h in r.history] == [h for _, h in want.history]


@pytest.mark.cuda
def test_batched_sa_quality_matches_scalar(cuda):
    """test_mapping_engines.py::test_batched_sa_quality_matches_scalar[pairwise]
    with the vec SA scored on the card (the CPU run's placement, bitwise)."""
    ok = 0
    for seed in range(3):
        c, tl = _pairwise_instance(k=20, seed=seed)
        scalar = sa_search(c, 25, 5, tl, seed=seed, iters=8000, device="cpu")
        kw = dict(seed=seed, iters=8000, impl="vec", batch=32,
                  score_backend="auto")
        with launched("swap_deltas"):
            vec = sa_search(c, 25, 5, tl, device=cuda, **kw)
        want = sa_search(c, 25, 5, tl, device="cpu", **kw)
        np.testing.assert_array_equal(vec.placement, want.placement)
        assert vec.avg_hop == want.avg_hop
        if vec.avg_hop <= scalar.avg_hop * 1.10 + 1e-9:
            ok += 1
        assert len(set(vec.placement.tolist())) == vec.placement.shape[0]
    assert ok >= 2


@pytest.mark.cuda
def test_polish_registry_entry_runs(cuda):
    """test_mapping_engines.py::test_polish_registry_entry_runs on the card:
    the polish on swap_deltas gives the CPU run's placement and steps."""
    c, tl = _pairwise_instance(k=12, seed=1)
    with launched("swap_deltas"):
        res = MAPPERS["polish"](c, 16, 4, tl, seed=0, device=cuda)
    want = MAPPERS["polish"](c, 16, 4, tl, seed=0, device="cpu")
    np.testing.assert_array_equal(res.placement, want.placement)
    assert (res.avg_hop, res.history, res.evaluations) == (
        want.avg_hop, want.history, want.evaluations)
    rng = np.random.default_rng(1)
    rand = np.mean([PairwiseObjective(c, 16, 4).total(rng.permutation(16)) / tl
                    for _ in range(10)])
    assert res.avg_hop <= rand


# ------------------------------ tests/test_refine_vec.py, test_hypergraph.py


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(16, 3), (130, 25), (256, 128), (300, 140)])
def test_refine_level_vec_kernel_path_on_the_card(cuda, n, k):
    """test_refine_vec.py::test_gain_eval_degrees_interpret_vs_ref's shapes
    and ::test_refine_level_vec_kernel_path_parity: part_degrees on the
    card equals the plain version exactly, and the cut refiner on the
    kernel path gives the CPU run's partition and cut."""
    rng = np.random.default_rng(n)
    a = rng.integers(0, 50, (n, n)).astype(np.float32)
    a = a + a.T
    np.fill_diagonal(a, 0)
    p = torch.from_numpy(rng.integers(0, k, n).astype(np.int32))
    with launched("part_degrees"):
        got = part_degrees(torch.from_numpy(a).to(cuda), p.to(cuda), k).cpu()
    assert torch.equal(got, part_degrees(torch.from_numpy(a), p, k))
    g = random_graph(n, 0.1, seed=n)
    part = (np.arange(n) % k).astype(np.int64)
    cap = max(8, 2 * -(-n // k))
    with launched("part_degrees"):
        out, cut = refine_level_vec(g, part, k, cap, use_kernel=True, device=cuda)
    want, want_cut = refine_level_vec(g, part, k, cap, use_kernel=True,
                                      device="cpu")
    np.testing.assert_array_equal(out, want)
    assert cut == want_cut == edge_cut(g, out)
    validate_partition(g, out, k, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,k,cap,seed", [(200, 1000, 66, 5, 3),
                                            (400, 2000, 40, 12, 0)])
def test_refine_level_vec_volume_kernel_on_the_card(cuda, n, m, k, cap, seed):
    """test_hypergraph.py::test_refine_level_vec_volume_kernel_interpret_parity
    and ::test_refine_level_vec_volume_exact_and_monotone[0] with the
    connectivity_degrees kernel on the card: the CPU run's partition and
    volume."""
    g = random_hypergraph(n, m, seed=seed, max_fire=9)
    part = greedy_region_growing(g, k, cap, np.random.default_rng(seed))
    kw = dict(objective="volume", use_kernel=True)
    with launched("connectivity_degrees"):
        out, vol = refine_level_vec(g, part.copy(), k, cap, device=cuda, **kw)
    want, want_vol = refine_level_vec(g, part.copy(), k, cap, device="cpu", **kw)
    np.testing.assert_array_equal(out, want)
    assert vol == want_vol == comm_volume(g.hyper, out)
    assert vol <= comm_volume(g.hyper, part)
    validate_partition(g, out, k, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_refine_level_vec_fanout_both_modes(cuda, objective):
    """The vec refiner on the kernel path on a fan-out hypergraph
    (test_volume_engines.py's graph), cut and volume, card against CPU."""
    g = fanout_snn_graph(400, seed=0)
    k, cap = 40, 12
    part = greedy_region_growing(g, k, cap, np.random.default_rng(0))
    name = "part_degrees" if objective == "cut" else "connectivity_degrees"
    kw = dict(objective=objective, use_kernel=True)
    with launched(name):
        out, score = refine_level_vec(g, part.copy(), k, cap, device=cuda, **kw)
    want, want_score = refine_level_vec(g, part.copy(), k, cap, device="cpu", **kw)
    np.testing.assert_array_equal(out, want)
    assert score == want_score


# ---------------------------------------------- tests/test_pipeline_sneap.py


@pytest.fixture(scope="module")
def smooth_320():
    """smooth_320 profiled over 300 steps on the card (lif_step) and on
    the CPU; the two bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    with launched("lif_step"):
        card = profile_snn(make_snn("smooth_320"), num_steps=300, seed=0,
                           device="cuda")
    host = profile_snn(make_snn("smooth_320"), num_steps=300, seed=0,
                       device="cpu")
    for f in ("trace_t", "trace_src", "trace_dst", "fire_counts"):
        np.testing.assert_array_equal(getattr(card, f), getattr(host, f))
    return card


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_run_toolchain_sneap_on_the_card(cuda, smooth_320, objective):
    """test_pipeline_sneap.py's SNEAP run (5x5 mesh, seed 0, 4,000 SA
    iterations) with the replay on the card's link-load screen (and torch
    stepper); the cut run's vec SA is scored on the card (the volume run
    places with the tree objective, which the kernel scorer does not
    take): partition, placement and NoCStats equal the CPU run's."""
    mapper_kwargs = {"iters": 4000}
    kernels = [screen_kernel("multicast" if objective == "volume"
                             else "unicast")]
    if objective == "cut":
        mapper_kwargs.update(impl="vec", score_backend="auto")
        kernels.append("swap_deltas")
    kw = dict(method="sneap", mesh_w=5, mesh_h=5, seed=0, objective=objective,
              mapper_kwargs=mapper_kwargs, noc_kwargs=dict(CARD_REPLAY))
    with launched(*kernels):
        got = run_toolchain(smooth_320, device="cuda", **kw)
    want = run_toolchain(smooth_320, device="cpu", **kw)
    np.testing.assert_array_equal(got.partition.part, want.partition.part)
    assert (got.partition.edge_cut, got.partition.comm_volume) == (
        want.partition.edge_cut, want.partition.comm_volume)
    np.testing.assert_array_equal(got.mapping.placement, want.mapping.placement)
    assert (got.mapping.avg_hop, got.mapping.tree_hop) == (
        want.mapping.avg_hop, want.mapping.tree_hop)
    assert same_stats(got.noc, want.noc) == []
    assert got.partition.k <= 25
    assert len(set(got.mapping.placement.tolist())) == got.partition.k
