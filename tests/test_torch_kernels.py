"""The port's kernels on the CPU: each plain PyTorch version against the
reference's jnp oracle and its Pallas kernel in interpret mode, at the
tolerances of tests/test_kernels.py, and the wrappers' dispatch rules.
The CUDA kernels themselves are held against their plain versions in
tests/test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.hopcost import hop_distance_matrix, swap_delta  # noqa: E402
from repro.core.mapping import pad_traffic  # noqa: E402
from repro.kernels import gain_eval as ref_gain  # noqa: E402
from repro.kernels import lif_step as ref_lif  # noqa: E402
from repro.kernels import link_load as ref_link  # noqa: E402
from repro.kernels import swap_delta as ref_swap  # noqa: E402
from repro.nocsim.xy import link_ids_for_routes  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gain_eval import kernel as gain_kernel  # noqa: E402
from repro_torch.kernels.gain_eval import part_degrees  # noqa: E402
from repro_torch.kernels.lif_step import kernel as lif_kernel  # noqa: E402
from repro_torch.kernels.lif_step import lif_step  # noqa: E402
from repro_torch.kernels.link_load import kernel as link_kernel  # noqa: E402
from repro_torch.kernels.link_load import link_loads, window_link_loads  # noqa: E402
from repro_torch.kernels.swap_delta import kernel as swap_kernel  # noqa: E402
from repro_torch.kernels.swap_delta import swap_deltas, swap_deltas_pairs  # noqa: E402

RNG = np.random.default_rng(0)
LIF_KW = dict(decay=0.9, threshold=1.0, v_reset=0.0, refractory=2)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -------------------------------------------------------------- lif_step

@pytest.mark.parametrize("n", [1, 8, 127, 128, 1000, 4096])
def test_lif_step_plain_matches_reference(n):
    v = RNG.standard_normal(n).astype(np.float32)
    refr = RNG.integers(0, 3, n).astype(np.int32)
    cur = RNG.standard_normal(n).astype(np.float32)
    got = [x.numpy() for x in lif_step(t(v), t(refr), t(cur), **LIF_KW)]
    args = (jnp.asarray(v), jnp.asarray(refr), jnp.asarray(cur))
    for want in (ref_lif.lif_step_ref(*args, **LIF_KW),
                 ref_lif.lif_step(*args, backend="interpret", **LIF_KW)):
        np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_lif_step_refractory_blocks_fire():
    _, _, fired = lif_step(torch.tensor([5.0, 5.0]),
                           torch.tensor([2, 0], dtype=torch.int32),
                           torch.zeros(2), decay=1.0, threshold=1.0,
                           v_reset=0.0, refractory=2)
    assert not bool(fired[0]) and bool(fired[1])


# ------------------------------------------------------------- gain_eval

@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (128, 128), (200, 60),
                                 (513, 130)])
def test_part_degrees_plain_matches_reference(n, k):
    a = RNG.integers(0, 40, (n, n)).astype(np.float32)
    a = a + a.T
    np.fill_diagonal(a, 0)
    p = RNG.integers(0, k, n).astype(np.int32)
    got = part_degrees(t(a), t(p), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref_gain.part_degrees_ref(jnp.asarray(a), jnp.asarray(p), k)))
    np.testing.assert_array_equal(
        got, np.asarray(ref_gain.part_degrees(jnp.asarray(a), jnp.asarray(p), k,
                                              backend="interpret")))
    rows = RNG.permutation(n)[: max(1, n // 3)].astype(np.int64)
    np.testing.assert_array_equal(
        part_degrees(t(a), t(p), k, t(rows)).numpy(), got[rows])


# ------------------------------------------------------------ swap_delta

@pytest.mark.parametrize("k,cores,w", [(5, 25, 5), (25, 25, 5), (100, 256, 16),
                                       (256, 256, 16)])
def test_swap_deltas_plain_matches_reference(k, cores, w):
    c = RNG.integers(0, 100, (k, k)).astype(np.float64)
    padded = pad_traffic(c, cores)
    sym = (padded + padded.T).astype(np.float32)
    placement = RNG.permutation(cores)
    x = (placement % w).astype(np.float32)
    y = (placement // w).astype(np.float32)
    got = swap_deltas(t(sym), t(x), t(y)).numpy()
    jargs = (jnp.asarray(sym), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got, np.asarray(ref_swap.swap_deltas_ref(*jargs)),
                               rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(
        got, np.asarray(ref_swap.swap_deltas(*jargs, backend="interpret")),
        rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.diag(got), 0.0, atol=1e-3)
    dist = hop_distance_matrix(cores, w).astype(np.float64)
    aa = RNG.integers(0, cores, 10)
    bb = RNG.integers(0, cores, 10)
    pairs = swap_deltas_pairs(t(sym), t(x), t(y), t(aa), t(bb)).numpy()
    for i, (a, b) in enumerate(zip(aa, bb)):
        expect = swap_delta(sym.astype(np.float64), placement, dist, int(a), int(b))
        np.testing.assert_allclose(pairs[i], expect, rtol=1e-5, atol=1e-2)


# ------------------------------------------------------------- link_load

@pytest.mark.parametrize("k,w,h", [(5, 5, 5), (256, 16, 16), (30, 8, 4)])
def test_link_loads_plain_matches_reference(k, w, h):
    c = RNG.integers(0, 30, (k, k)).astype(np.float32)
    cores = RNG.permutation(w * h)[:k]
    x, y = (cores % w).astype(np.int32), (cores // w).astype(np.int32)
    got = link_loads(t(c[None].astype(np.int32)), t(x), t(y), w, h).numpy()[0]
    jargs = (jnp.asarray(c), jnp.asarray(x.astype(np.float32)),
             jnp.asarray(y.astype(np.float32)), w, h)
    for maps in (ref_link.link_loads_ref(*jargs),
                 ref_link.link_loads(*jargs, backend="interpret")):
        flat = np.asarray(ref_link.flatten_link_maps(*maps, w, h))
        np.testing.assert_array_equal(got, np.rint(flat).astype(np.int32))


@pytest.mark.parametrize("w,h,windows", [(8, 4, 3), (16, 16, 2)])
def test_window_link_loads_match_reference_and_route_bincount(w, h, windows):
    k = w * h
    counts = RNG.integers(0, 4, (windows, k, k)) * (RNG.random((windows, k, k)) < 0.2)
    got = window_link_loads(counts, w, h, device="cpu", chunk=2)
    np.testing.assert_array_equal(
        got, ref_link.window_link_loads(counts, w, h, backend="jnp"))
    # Independent check: histogram the expanded XY routes directly.
    b, s, d = np.nonzero(counts)
    reps = counts[b, s, d]
    b, s, d = np.repeat(b, reps), np.repeat(s, reps), np.repeat(d, reps)
    ids, pkt = link_ids_for_routes(s, d, w, h)
    nl = got.shape[1]
    expect = np.bincount(b[pkt] * nl + ids, minlength=windows * nl)
    np.testing.assert_array_equal(got, expect.reshape(windows, nl))


# ------------------------------------------------------ dispatch / guards

def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (lif_kernel.launches, gain_kernel.launches, swap_kernel.launches,
              link_kernel.launches)
    lif_step(torch.zeros(4), torch.zeros(4, dtype=torch.int32), torch.ones(4),
             **LIF_KW)
    part_degrees(torch.ones(3, 3), torch.zeros(3, dtype=torch.int32), 2)
    swap_deltas(torch.ones(3, 3), torch.zeros(3), torch.zeros(3))
    link_loads(torch.ones(1, 4, 4, dtype=torch.int32),
               torch.tensor([0, 1, 0, 1], dtype=torch.int32),
               torch.tensor([0, 0, 1, 1], dtype=torch.int32), 2, 2)
    assert before == (lif_kernel.launches, gain_kernel.launches,
                      swap_kernel.launches, link_kernel.launches)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs a plain version: it validates and raises."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        lif_kernel.lif_step_cuda(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                                 torch.ones(4), **LIF_KW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gain_kernel.part_degrees_cuda(torch.ones(3, 3),
                                      torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swap_kernel.swap_deltas_cuda(torch.ones(3, 3), torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        link_kernel.link_loads_cuda(torch.ones(1, 4, 4, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32), 2, 2)


def test_ops_refuse_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        part_degrees(torch.ones(3, 3, device="meta"),
                     torch.zeros(3, dtype=torch.int32, device="meta"), 2)


def test_kernel_build_hash_tracks_source():
    """Library names carry a hash of source + flags, so an edited source
    never loads a stale build; the build directory is the checkout's."""
    paths = {n: _build._lib_path(n) for n in _build.KERNELS}
    assert len(set(paths.values())) == len(_build.KERNELS)
    for name, path in paths.items():
        assert path.parent == _build.build_dir()
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()
