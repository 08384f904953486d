"""The fused LIF run (synaptic product inside the step) on the CPU: its
synapse list, and its raster against the reference's dense-product
``lif_run`` bitwise.  The order of each neuron's sum is what makes it
bitwise: ascending source order, as the reference's product adds."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.snn import LIFParams as RefLIFParams  # noqa: E402
from repro.snn import lif_run as ref_lif_run  # noqa: E402

from repro_torch.kernels.lif_step import (  # noqa: E402
    Synapses,
    lif_steps,
    lif_steps_ref,
    synapses_from_dense,
)
from repro_torch.kernels.lif_step import kernel as lif_kernel  # noqa: E402
from repro_torch.snn import LIFParams, lif_run, make_snn, profile_drive  # noqa: E402

KW = dict(decay=0.9, threshold=1.0, v_reset=0.0, refractory=1)


def _random_weights(n, density, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, n)).astype(np.float32)
    w *= rng.random((n, n)) < density
    w[:, : n // 7] = 0.0  # destinations without synapses
    return w


@pytest.mark.parametrize("name,steps", [("smooth_320", 300), ("edge_5120", 300)])
def test_fused_raster_matches_reference_bitwise(name, steps):
    """edge_5120's interior weights are 0.1f, ten of which must reach the
    threshold exactly: a pairwise sum first breaks the raster at step 4."""
    topo = make_snn(name)
    drive = profile_drive(topo, steps, 0)
    want = ref_lif_run(jnp.asarray(topo.weights), jnp.asarray(drive), RefLIFParams())
    syn = synapses_from_dense(torch.from_numpy(topo.weights))
    raster, v, refr = lif_steps_ref(syn.src, syn.w, syn.deg,
                                    torch.from_numpy(drive), **KW)
    assert raster.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(raster.numpy(), want)
    assert int(want.sum()) > 0
    # The public entry point takes the same path on the CPU.
    got = lif_run(torch.from_numpy(topo.weights), torch.from_numpy(drive),
                  LIFParams())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,density", [(1, 1.0), (97, 0.1), (320, 0.02)])
def test_fused_random_population_matches_reference_bitwise(n, density):
    w = _random_weights(n, density, seed=n)
    drive = np.random.default_rng(1).uniform(0.0, 0.7, (40, n)).astype(np.float32)
    want = ref_lif_run(jnp.asarray(w), jnp.asarray(drive), RefLIFParams())
    got = lif_run(torch.from_numpy(w), torch.from_numpy(drive), LIFParams())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["smooth_320", "edge_5120", "random"])
def test_synapse_list_is_the_dense_nonzeros_in_ascending_source_order(name):
    w = (_random_weights(300, 0.05, seed=3) if name == "random"
         else make_snn(name).weights.astype(np.float32))
    n = w.shape[0]
    syn = synapses_from_dense(torch.from_numpy(w))
    src, ell_w, deg = syn.src.numpy(), syn.w.numpy(), syn.deg.numpy()
    assert src.dtype == np.int32 and ell_w.dtype == np.float32
    assert deg.dtype == np.int32 and src.shape == ell_w.shape
    np.testing.assert_array_equal(deg, (w != 0).sum(axis=0))
    assert src.shape == (int(deg.max()), n)
    live = np.arange(src.shape[0])[:, None] < deg[None, :]
    # Ascending (hence distinct) sources inside each destination.
    steps = np.diff(src, axis=0)
    assert np.all(steps[live[1:]] > 0)
    # Exactly the non-zeros, and zero padding.
    dense = np.zeros_like(w)
    cols = np.broadcast_to(np.arange(n), src.shape)
    dense[src[live], cols[live]] = ell_w[live]
    np.testing.assert_array_equal(dense, w)
    assert np.all(ell_w[~live] == 0) and np.all(src[~live] == 0)
    assert np.all(ell_w[live] != 0)


def test_empty_population_and_no_steps():
    syn = synapses_from_dense(torch.zeros(0, 0))
    assert syn.src.shape == (0, 0) and syn.deg.shape == (0,)
    raster, v, refr = lif_steps(syn, torch.zeros(3, 0), **KW)
    assert raster.shape == (3, 0) and v.shape == (0,) and refr.shape == (0,)
    syn = synapses_from_dense(torch.eye(4))
    raster, _, _ = lif_steps(syn, torch.zeros(0, 4), **KW)
    assert raster.shape == (0, 4)


def test_cpu_path_counts_no_launch_and_synapses_move_by_copy():
    syn = synapses_from_dense(torch.from_numpy(_random_weights(50, 0.2, seed=5)))
    before = lif_kernel.launches
    lif_steps(syn, torch.full((5, 50), 0.6), **KW)
    assert lif_kernel.launches == before
    moved = syn.to("cpu")
    assert isinstance(moved, Synapses)
    for a, b in ((moved.src, syn.src), (moved.w, syn.w), (moved.deg, syn.deg)):
        assert torch.equal(a, b)


def test_fused_kernel_wrapper_refuses_cpu_tensors():
    syn = synapses_from_dense(torch.eye(4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        lif_kernel.lif_steps_cuda(syn.src, syn.w, syn.deg, torch.zeros(2, 4), **KW)
    with pytest.raises(ValueError, match="cuda or cpu"):
        lif_steps(syn, torch.zeros(2, 4, device="meta"), **KW)
