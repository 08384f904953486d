"""The port's baseline toolchains (SpiNeMap, SCO) against the reference on
the CPU: the partitioners and the sequential placement bitwise, the whole
``run_toolchain(method=...)`` summary equal, and the paper's orderings
(SNEAP beats SpiNeMap beats SCO) as `tests/test_pipeline_sneap.py` checks
them on the reference."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import fanout_snn_graph  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.core import run_toolchain as ref_run_toolchain  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    greedy_kl_partition,
    run_toolchain,
    sco_partition,
    sco_place,
)

SECONDS = ("partition_s", "mapping_s", "evaluate_s", "total_s")
# tests/test_pipeline_sneap.py's runs: 5x5 mesh, capacity 256.
RUN_KW = dict(mesh_w=5, mesh_h=5, seed=0)
MAPPER_KW = {"sneap": {"iters": 4000}, "spinemap": {"iters": 40},
             "sco": {"iters": 40}}


def _no_seconds(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in SECONDS}


@pytest.fixture(scope="module")
def smooth_320():
    return profile_snn(make_snn("smooth_320"), num_steps=300, seed=0)


@pytest.fixture(scope="module")
def synthetic():
    return fanout_snn_graph(600, fan=8, seed=4)


def _graphs(name, smooth_320, synthetic):
    ref = smooth_320.graph if name == "smooth_320" else synthetic
    return ref, interop.graph_from(ref)


def _same_partition(got, want):
    np.testing.assert_array_equal(got.part, want.part)
    assert (got.k, got.edge_cut, got.comm_volume, got.num_levels,
            got.capacity, got.objective) == (
        want.k, want.edge_cut, want.comm_volume, want.num_levels,
        want.capacity, want.objective)


@pytest.mark.parametrize("objective", ["cut", "volume"])
@pytest.mark.parametrize("graph", ["smooth_320", "synthetic"])
@pytest.mark.parametrize("capacity,seed", [(32, 0), (64, 3)])
def test_greedy_kl_partition_matches_reference(smooth_320, synthetic, graph,
                                               objective, capacity, seed):
    ref_g, g = _graphs(graph, smooth_320, synthetic)
    want = ref_baselines.greedy_kl_partition(ref_g, capacity=capacity,
                                             seed=seed, objective=objective)
    got = greedy_kl_partition(g, capacity=capacity, seed=seed,
                              objective=objective)
    _same_partition(got, want)


def test_greedy_kl_partition_caps_k_at_max_k(synthetic):
    g = interop.graph_from(synthetic)
    want = ref_baselines.greedy_kl_partition(synthetic, capacity=40, max_k=16)
    got = greedy_kl_partition(g, capacity=40, max_k=16)
    assert got.k == 16
    _same_partition(got, want)


@pytest.mark.parametrize("objective", ["cut", "volume"])
@pytest.mark.parametrize("graph", ["smooth_320", "synthetic"])
def test_sco_partition_matches_reference(smooth_320, synthetic, graph,
                                         objective):
    ref_g, g = _graphs(graph, smooth_320, synthetic)
    want = ref_baselines.sco_partition(ref_g, capacity=48, objective=objective)
    got = sco_partition(g, capacity=48, objective=objective)
    _same_partition(got, want)


def test_baselines_reject_unknown_objective(synthetic):
    g = interop.graph_from(synthetic)
    with pytest.raises(ValueError, match="unknown objective"):
        greedy_kl_partition(g, objective="hops")
    with pytest.raises(ValueError, match="unknown objective"):
        sco_partition(g, objective="hops")


def test_sco_place_matches_reference():
    got, want = sco_place(7, 9), ref_baselines.sco_place(7, 9)
    np.testing.assert_array_equal(got.placement, want.placement)
    assert np.isnan(got.avg_hop) and got.objective == want.objective
    with pytest.raises(ValueError, match="partitions > "):
        sco_place(10, 9)


@pytest.fixture(scope="module")
def runs(smooth_320):
    """Both packages' three toolchains on smooth_320, as
    tests/test_pipeline_sneap.py runs them."""
    prof = interop.profile_from(smooth_320)
    out = {}
    for method, kw in MAPPER_KW.items():
        out[method] = (
            run_toolchain(prof, method=method, mapper_kwargs=kw, device="cpu",
                          **RUN_KW),
            ref_run_toolchain(smooth_320, method=method, mapper_kwargs=kw,
                              **RUN_KW))
    return out


@pytest.mark.parametrize("method", ["spinemap", "sco"])
def test_baseline_toolchain_matches_reference(runs, method):
    got, want = runs[method]
    assert _no_seconds(got.summary()) == _no_seconds(want.summary())
    np.testing.assert_array_equal(got.partition.part, want.partition.part)
    np.testing.assert_array_equal(got.mapping.placement, want.mapping.placement)
    assert got.place_objective == want.place_objective == "pairwise"


@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_baseline_toolchains_match_reference_on_the_volume_path(smooth_320,
                                                                objective):
    """The baselines keep the pairwise placement objective under the
    multicast cast, as the reference does."""
    prof = interop.profile_from(smooth_320)
    kw = dict(RUN_KW, objective=objective, capacity=64, mapper_kwargs={"iters": 20})
    for method in ("spinemap", "sco"):
        got = run_toolchain(prof, method=method, device="cpu", **kw)
        want = ref_run_toolchain(smooth_320, method=method, **kw)
        assert _no_seconds(got.summary()) == _no_seconds(want.summary())


def test_sco_refuses_an_explicit_tree_objective(smooth_320):
    prof = interop.profile_from(smooth_320)
    with pytest.raises(ValueError, match="places sequentially"):
        run_toolchain(prof, method="sco", objective="volume",
                      place_objective="tree", device="cpu", **RUN_KW)


def test_unknown_method_raises(smooth_320):
    with pytest.raises(ValueError, match="unknown method"):
        run_toolchain(interop.profile_from(smooth_320), method="metis",
                      device="cpu", **RUN_KW)


# The orderings of tests/test_pipeline_sneap.py, on the port's runs.


def test_partition_cut_ordering(runs):
    cut = {m: r[0].partition.edge_cut for m, r in runs.items()}
    assert cut["sneap"] <= cut["spinemap"] <= cut["sco"]


def test_avg_hop_ordering(runs):
    assert runs["sneap"][0].mapping.avg_hop < runs["sco"][0].mapping.avg_hop


def test_noc_metrics_ordering(runs):
    s, sco = runs["sneap"][0].noc, runs["sco"][0].noc
    assert s.avg_latency < sco.avg_latency
    assert s.dynamic_energy_pj < sco.dynamic_energy_pj
    assert s.congestion_count <= sco.congestion_count
    assert s.edge_variance < sco.edge_variance


def test_all_partitions_fit_mesh(runs):
    for got, _ in runs.values():
        assert got.partition.k <= 25
        assert len(set(got.mapping.placement.tolist())) == got.partition.k


def test_summary_reports_phase_seconds(runs):
    for got, _ in runs.values():
        s = got.summary()
        assert s["evaluate_s"] == got.phase_seconds["evaluate"] > 0.0
        assert s["partition_s"] == got.phase_seconds["partition"]
        assert s["mapping_s"] == got.phase_seconds["mapping"]
