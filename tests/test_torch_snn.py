"""tests/test_snn.py held against the port on the CPU: the LIF dynamics
(the port's fused LIF step on CPU tensors, its plain version), trace
expansion, profiling and its cache, and the paper's topologies — each
raster, trace and topology bitwise the reference's on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.snn import lif as ref_lif  # noqa: E402
from repro.snn import simulate as ref_simulate  # noqa: E402
from repro.snn.topology import make_snn as ref_make_snn  # noqa: E402
from torch_parity import assert_bitwise, profiles  # noqa: E402

from repro_torch.snn.lif import LIFParams, lif_run  # noqa: E402
from repro_torch.snn.simulate import _expand_trace, profile_snn  # noqa: E402
from repro_torch.snn.topology import PAPER_SNNS, make_snn  # noqa: E402


def _run(w, drive, **params):
    """The port's raster on CPU tensors, bitwise the reference's."""
    got = lif_run(torch.from_numpy(w), torch.from_numpy(drive), LIFParams(**params))
    assert_bitwise(got, ref_lif.lif_run(jnp.asarray(w), jnp.asarray(drive),
                                        ref_lif.LIFParams(**params)))
    return got


def test_lif_fires_on_suprathreshold_input():
    """Counterpart of test_snn.py::test_lif_fires_on_suprathreshold_input."""
    n = 4
    w = np.zeros((n, n), np.float32)
    drive = np.zeros((10, n), np.float32)
    drive[2, 1] = 5.0
    raster = _run(w, drive, threshold=1.0)
    assert raster[2, 1] == 1
    assert raster.sum() == 1


def test_lif_subthreshold_decays_no_fire():
    """Counterpart of test_snn.py::test_lif_subthreshold_decays_no_fire."""
    n = 2
    w = np.zeros((n, n), np.float32)
    drive = np.full((50, n), 0.05, np.float32)
    raster = _run(w, drive, decay=0.9, threshold=1.0)
    assert raster.sum() == 0


def test_lif_synaptic_propagation():
    """Counterpart of test_snn.py::test_lif_synaptic_propagation."""
    w = np.zeros((2, 2), np.float32)
    w[0, 1] = 2.0
    drive = np.zeros((6, 2), np.float32)
    drive[1, 0] = 2.0
    raster = _run(w, drive)
    assert raster[1, 0] == 1 and raster[2, 1] == 1


def test_expand_trace_counts():
    """Counterpart of test_snn.py::test_expand_trace_counts."""
    raster = np.zeros((3, 3), np.uint8)
    raster[0, 0] = 1
    raster[2, 1] = 1
    xadj = np.array([0, 2, 3, 3])
    adjncy = np.array([1, 2, 2])
    out = _expand_trace(raster, xadj, adjncy)
    for a, b in zip(out, ref_simulate._expand_trace(raster, xadj, adjncy)):
        assert_bitwise(a, b)
    t, s, d = out
    assert len(t) == 3
    assert (s == np.array([0, 0, 1])).all()
    assert (d == np.array([1, 2, 2])).all()
    assert (t == np.array([0, 0, 2])).all()


def test_profile_consistency_small():
    """Counterpart of test_snn.py::test_profile_consistency_small."""
    topo = make_snn("smooth_320")
    _, prof = profiles("smooth_320", 100)
    assert prof.graph.total_adjwgt == prof.num_spikes
    assert prof.graph.num_vertices == topo.num_neurons
    syn = set(zip(topo.syn_src.tolist(), topo.syn_dst.tolist()))
    pick = np.random.default_rng(0).integers(0, prof.num_spikes, 50)
    for i in pick:
        assert (int(prof.trace_src[i]), int(prof.trace_dst[i])) in syn


def test_profile_cache_misses_on_content_change(tmp_path):
    """Counterpart of test_snn.py::test_profile_cache_misses_on_content_change."""
    kw = dict(num_steps=100, seed=0, cache_dir=tmp_path, device="cpu")
    topo = make_snn("smooth_320")
    first = profile_snn(topo, **kw)
    assert len(list(tmp_path.glob("profile_*.npz"))) == 1

    mutated = make_snn("smooth_320")
    mutated.weights = mutated.weights * 1.5
    second = profile_snn(mutated, **kw)
    assert len(list(tmp_path.glob("profile_*.npz"))) == 2
    assert not np.array_equal(first.fire_counts, second.fire_counts) or \
        first.num_spikes != second.num_spikes
    ref_mutated = ref_make_snn("smooth_320")
    ref_mutated.weights = ref_mutated.weights * 1.5
    want = ref_simulate.profile_snn(ref_mutated, num_steps=100, seed=0)
    np.testing.assert_array_equal(second.trace_src, want.trace_src)
    np.testing.assert_array_equal(second.fire_counts, want.fire_counts)

    again = profile_snn(make_snn("smooth_320"), **kw)
    assert len(list(tmp_path.glob("profile_*.npz"))) == 2
    assert np.array_equal(first.trace_t, again.trace_t)
    assert np.array_equal(first.trace_src, again.trace_src)
    assert np.array_equal(first.fire_counts, again.fire_counts)


def test_all_paper_snns_build():
    """Counterpart of test_snn.py::test_all_paper_snns_build."""
    for name in PAPER_SNNS:
        topo = make_snn(name)
        assert topo.num_neurons == int(name.split("_")[1])
        assert topo.weights.shape == (topo.num_neurons,) * 2
        want = ref_make_snn(name)
        for f in ("syn_src", "syn_dst", "weights"):
            assert_bitwise(getattr(topo, f), getattr(want, f))
        del topo, want
