"""tests/test_pipeline_sneap.py held against the port on the CPU: the
paper's orderings (SNEAP <= SpiNeMap <= SCO on cut, hop, latency and
energy), the summary's phase seconds, ``noc_kwargs`` pass-through and
partition quality per time — every run's partition, placement and
NoCStats bitwise the reference's run on the same profile."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_parity import profiles, toolchain  # noqa: E402


@pytest.fixture(scope="module")
def profile():
    """(reference, port) profiles of smooth_320, bitwise equal."""
    return profiles("smooth_320", 300)


@pytest.fixture(scope="module")
def results(profile):
    out = {}
    for method in ("sneap", "spinemap", "sco"):
        kwargs = {"iters": 4000} if method == "sneap" else {"iters": 40}
        out[method] = toolchain(*profile, method=method, mesh_w=5, mesh_h=5,
                                seed=0, mapper_kwargs=kwargs)
    return out


def test_partition_cut_ordering(results):
    """Counterpart of test_pipeline_sneap.py::test_partition_cut_ordering."""
    assert results["sneap"].partition.edge_cut <= results["spinemap"].partition.edge_cut
    assert results["spinemap"].partition.edge_cut <= results["sco"].partition.edge_cut


def test_avg_hop_ordering(results):
    """Counterpart of test_pipeline_sneap.py::test_avg_hop_ordering."""
    assert results["sneap"].mapping.avg_hop < results["sco"].mapping.avg_hop


def test_noc_metrics_ordering(results):
    """Counterpart of test_pipeline_sneap.py::test_noc_metrics_ordering."""
    s, sco = results["sneap"].noc, results["sco"].noc
    assert s.avg_latency < sco.avg_latency
    assert s.dynamic_energy_pj < sco.dynamic_energy_pj
    assert s.congestion_count <= sco.congestion_count
    assert s.edge_variance < sco.edge_variance


def test_all_partitions_fit_mesh(results):
    """Counterpart of test_pipeline_sneap.py::test_all_partitions_fit_mesh."""
    for r in results.values():
        assert r.partition.k <= 25
        assert len(set(r.mapping.placement.tolist())) == r.partition.k


def test_summary_reports_evaluate_seconds(results):
    """Counterpart of test_pipeline_sneap.py::test_summary_reports_evaluate_seconds."""
    for r in results.values():
        s = r.summary()
        assert s["evaluate_s"] == r.phase_seconds["evaluate"] > 0.0
        assert s["partition_s"] == r.phase_seconds["partition"]
        assert s["mapping_s"] == r.phase_seconds["mapping"]


def test_noc_kwargs_pass_through(profile, results):
    """Counterpart of test_pipeline_sneap.py::test_noc_kwargs_pass_through."""
    base = results["sneap"]
    ref = toolchain(*profile, mesh_w=5, mesh_h=5, seed=0,
                    mapper_kwargs={"iters": 4000}, noc_kwargs={"engine": "ref"})
    np.testing.assert_array_equal(ref.partition.part, base.partition.part)
    assert ref.noc.avg_latency == base.noc.avg_latency
    assert ref.noc.congestion_count == base.noc.congestion_count
    uncapped = toolchain(*profile, mesh_w=5, mesh_h=5, seed=0,
                         mapper_kwargs={"iters": 4000},
                         noc_kwargs={"inject_capacity": 1_000_000,
                                     "link_capacity": 1_000_000})
    assert uncapped.noc.congestion_count == 0
    np.testing.assert_allclose(uncapped.noc.avg_latency, uncapped.noc.avg_hop)


def test_sneap_partition_quality_per_time():
    """Counterpart of test_pipeline_sneap.py::test_sneap_partition_quality_per_time."""
    prof = profiles("smooth_1280", 200)
    sneap = toolchain(*prof, method="sneap", mapper_kwargs={"iters": 200})
    spine = toolchain(*prof, method="spinemap", mapper_kwargs={"iters": 5})
    assert sneap.partition.edge_cut < spine.partition.edge_cut * 0.5
    assert sneap.phase_seconds["partition"] < \
        max(spine.phase_seconds["partition"], 0.02) * 5
