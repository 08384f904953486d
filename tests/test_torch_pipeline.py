"""The port's end-to-end toolchain against the reference on the CPU."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import run_toolchain as ref_run_toolchain  # noqa: E402
from repro.nocsim import simulate_noc as ref_simulate_noc  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ToolchainConfig,
    evaluate_phase,
    mapping_phase,
    run_toolchain,
)

SECONDS = ("partition_s", "mapping_s", "evaluate_s", "total_s")
SLICE_KW = dict(method="sneap", mesh_w=10, mesh_h=10, capacity=16, seed=0,
                partition_impl="vec", objective="cut", mapper="sa")


def _no_seconds(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in SECONDS}


@pytest.fixture(scope="module")
def smooth_320():
    return profile_snn(make_snn("smooth_320"), num_steps=300, seed=0)


@pytest.fixture(scope="module")
def smooth_1280():
    return profile_snn(make_snn("smooth_1280"), num_steps=200, seed=0)


@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_run_toolchain_matches_reference(smooth_320, objective):
    kw = dict(mesh_w=5, mesh_h=5, seed=0, mapper_kwargs={"iters": 4000},
              objective=objective)
    want = ref_run_toolchain(smooth_320, **kw)
    got = run_toolchain(interop.profile_from(smooth_320), device="cpu", **kw)
    assert _no_seconds(got.summary()) == _no_seconds(want.summary())
    np.testing.assert_array_equal(got.mapping.placement, want.mapping.placement)


def test_slice_shaped_run_matches_reference(smooth_1280):
    """The slice run's configuration (vec partition, batched SA on the
    kernel scorer, link-load screen) at a CPU-sized shape."""
    want = ref_run_toolchain(smooth_1280, noc_kwargs={"screen": "numpy"},
                             mapper_kwargs={"impl": "vec",
                                            "score_backend": "numpy"},
                             **SLICE_KW)
    prof = interop.profile_from(smooth_1280)
    got = run_toolchain(prof, noc_kwargs={"screen": "linkload"},
                        mapper_kwargs={"impl": "vec", "score_backend": "auto"},
                        device="cpu", **SLICE_KW)
    np.testing.assert_array_equal(got.partition.part, want.partition.part)
    assert got.partition.edge_cut == want.partition.edge_cut
    # f32 kernel-scored deltas steer the SA differently from f64 host ones.
    assert abs(got.mapping.avg_hop - want.mapping.avg_hop) <= 0.02 * want.mapping.avg_hop
    noc = ref_simulate_noc(smooth_1280.trace_t, smooth_1280.trace_src,
                           smooth_1280.trace_dst, got.partition.part,
                           got.mapping.placement, 10, 10)
    for f in dataclasses.fields(noc):
        a, b = getattr(got.noc, f.name), getattr(noc, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_mapping_and_evaluate_phases_fed_the_reference_partition(smooth_1280):
    """Stage by stage: the port's mapping and replay phases, fed the
    reference's own profile and partition, give its placement and stats."""
    kw = dict(SLICE_KW, mapper_kwargs={"impl": "vec", "score_backend": "numpy"},
              noc_kwargs={"screen": "linkload"})
    want = ref_run_toolchain(smooth_1280, **kw)
    prof = interop.profile_from(smooth_1280)
    pres = interop.partition_from(want.partition)
    cfg = ToolchainConfig(**kw, device="cpu")
    mres, place, _, _ = mapping_phase(prof, pres, cfg)
    np.testing.assert_array_equal(mres.placement, want.mapping.placement)
    assert (mres.avg_hop, mres.tree_hop, place) == (
        want.mapping.avg_hop, want.mapping.tree_hop, want.place_objective)
    noc = evaluate_phase(prof, pres, mres, cfg)
    for f in dataclasses.fields(noc):
        a, b = getattr(noc, f.name), getattr(want.noc, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_run_toolchain_defaults_to_the_card(smooth_320):
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_toolchain(interop.profile_from(smooth_320))


@pytest.mark.parametrize("kwargs,match", [
    ({"method": "spinemap"}, "baselines"),
    ({"method": "sco"}, "baselines"),
    ({"mapper": "sa_jax"}, "device searches"),
    ({"mapper": "island"}, "island SA"),
    ({"fault_schedule": object()}, "fault"),
    ({"partition_kwargs": {"shards": 2}}, "shards"),
    ({"noc_kwargs": {"stepper": "jax"}}, "stepper"),
])
def test_unported_features_raise(smooth_320, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        run_toolchain(interop.profile_from(smooth_320), mesh_w=5, mesh_h=5,
                      device="cpu", mapper_kwargs={"iters": 100}, **kwargs)
