"""The port's profiling phase against the reference on the CPU: identical
rasters, traces, fire counts, graphs and hypergraphs."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.snn import LIFParams as RefLIFParams  # noqa: E402
from repro.snn import lif_run as ref_lif_run  # noqa: E402
from repro.snn import make_snn as ref_make_snn  # noqa: E402
from repro.snn import profile_snn as ref_profile_snn  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.snn import LIFParams, lif_run, make_snn, profile_snn  # noqa: E402

STEPS = 300  # as tests/test_pipeline_sneap.py profiles smooth_320


def _drive(topo, steps, seed=0):
    """profile_snn's stimulus, rebuilt the same way from the same seed."""
    rng = np.random.default_rng(seed)
    drive = np.zeros((steps, topo.num_neurons), dtype=np.float32)
    events = rng.random((steps, topo.input_size)) < topo.input_rate
    drive[:, : topo.input_size] = events * topo.input_amp
    return drive


def _margin_report(topo, drive, ref_raster, got_raster, params):
    """Where rasters differ, the reference membrane's distance to threshold
    at the first differing step (how close the neuron was to the edge)."""
    t0 = int(np.argwhere((ref_raster != got_raster).any(axis=1))[0, 0])
    w = topo.weights.astype(np.float32)
    v = np.zeros(topo.num_neurons, np.float32)
    refr = np.zeros(topo.num_neurons, np.int32)
    spikes = np.zeros(topo.num_neurons, np.float32)
    for t in range(t0 + 1):
        active = refr <= 0
        v2 = np.where(active, np.float32(params.decay) * v + (spikes @ w + drive[t]), v)
        fired = ref_raster[t].astype(bool)
        v = np.where(fired, np.float32(params.v_reset), v2)
        refr = np.where(fired, params.refractory, np.maximum(refr - 1, 0))
        spikes = fired.astype(np.float32)
    bad = np.flatnonzero(ref_raster[t0] != got_raster[t0])
    return {int(i): float(v2[i] - params.threshold) for i in bad}


def test_topology_is_a_verbatim_copy():
    for name in ("smooth_320", "edge_5120"):
        a, b = ref_make_snn(name), make_snn(name)
        for f in ("syn_src", "syn_dst", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.layer_sizes, a.input_rate, a.target_spikes) == (
            b.layer_sizes, b.input_rate, b.target_spikes)


def test_raster_matches_reference_bitwise():
    topo = make_snn("smooth_320")
    drive = _drive(topo, STEPS)
    want = ref_lif_run(jnp.asarray(topo.weights), jnp.asarray(drive), RefLIFParams())
    got = lif_run(torch.from_numpy(topo.weights), torch.from_numpy(drive), LIFParams())
    assert got.dtype == np.uint8 and got.shape == want.shape
    if not np.array_equal(got, want):
        margins = _margin_report(topo, drive, want, got, LIFParams())
        pytest.fail(f"raster differs; neuron -> margin to threshold: {margins}")


def test_profile_matches_reference_bitwise():
    ref_topo = ref_make_snn("smooth_320")
    want = ref_profile_snn(ref_topo, num_steps=STEPS, seed=0)
    # The port profiles the reference's own topology, carried over.
    got = profile_snn(interop.topology_from(ref_topo), num_steps=STEPS,
                      seed=0, device="cpu")
    assert (got.num_neurons, got.num_steps) == (want.num_neurons, want.num_steps)
    for f in ("trace_t", "trace_src", "trace_dst", "fire_counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for f in ("xadj", "adjncy", "adjwgt", "vwgt"):
        np.testing.assert_array_equal(getattr(got.graph, f),
                                      getattr(want.graph, f), err_msg=f)
    for f in ("hxadj", "hpins", "hwgt", "hsrc", "hfire"):
        np.testing.assert_array_equal(getattr(got.hyper, f),
                                      getattr(want.hyper, f), err_msg=f)
    # interop carries the reference's profile over field for field.
    carried = interop.profile_from(want)
    for f in ("trace_t", "trace_src", "trace_dst", "fire_counts"):
        np.testing.assert_array_equal(getattr(carried, f), getattr(got, f))
    np.testing.assert_array_equal(carried.hyper.hpins, got.hyper.hpins)


def test_truncation_at_target_spikes_matches_reference():
    topo = dataclasses.replace(make_snn("smooth_320"), target_spikes=20_000)
    ref_topo = dataclasses.replace(ref_make_snn("smooth_320"), target_spikes=20_000)
    got = profile_snn(topo, num_steps=200, seed=1, device="cpu")
    want = ref_profile_snn(ref_topo, num_steps=200, seed=1)
    assert got.num_steps == want.num_steps < 200
    np.testing.assert_array_equal(got.trace_t, want.trace_t)
    np.testing.assert_array_equal(got.fire_counts, want.fire_counts)


def test_profile_cache_is_content_keyed(tmp_path):
    topo = make_snn("smooth_320")
    a = profile_snn(topo, num_steps=50, seed=0, cache_dir=tmp_path, device="cpu")
    hit = profile_snn(topo, num_steps=50, seed=0, cache_dir=tmp_path, device="cpu")
    np.testing.assert_array_equal(a.trace_dst, hit.trace_dst)
    assert len(list(tmp_path.glob("profile_torch_smooth_320_*.npz"))) == 1
    # Same name and size, different connectivity: must miss the cache.
    other = dataclasses.replace(topo, syn_dst=topo.syn_dst[::-1].copy())
    b = profile_snn(other, num_steps=50, seed=0, cache_dir=tmp_path, device="cpu")
    assert len(list(tmp_path.glob("profile_torch_smooth_320_*.npz"))) == 2
    assert not np.array_equal(a.trace_dst, b.trace_dst)


def test_profile_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only behaviour")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_snn(make_snn("smooth_320"), num_steps=5)
