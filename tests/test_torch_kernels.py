"""The port's kernels on the CPU: each plain PyTorch version against the
reference's jnp oracle and its Pallas kernel in interpret mode, at the
tolerances of tests/test_kernels.py, and the wrappers' dispatch rules.
The CUDA kernels themselves are held against their plain versions in
tests/test_torch_cuda_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from repro.core.graph import build_hypergraph as ref_build_hypergraph  # noqa: E402
from repro.core.graph import edge_partition_counts as ref_edge_partition_counts  # noqa: E402
from repro.core.graph import volume_degrees as ref_volume_degrees  # noqa: E402
from repro.core.hopcost import hop_distance_matrix, swap_delta  # noqa: E402
from repro.core.mapping import pad_traffic  # noqa: E402
from repro.kernels import gain_eval as ref_gain  # noqa: E402
from repro.kernels import hop_eval as ref_hop  # noqa: E402
from repro.kernels import lif_step as ref_lif  # noqa: E402
from repro.kernels import link_load as ref_link  # noqa: E402
from repro.kernels import swap_delta as ref_swap  # noqa: E402
from repro.nocsim.replay import _window_loads_linkload as ref_window_loads  # noqa: E402
from repro.nocsim.xy import link_ids_for_routes  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.gain_eval import kernel as gain_kernel  # noqa: E402
from repro_torch.kernels.gain_eval import (  # noqa: E402
    connectivity_degrees_ref,
    gain_matrix,
    gain_matrix_ref,
    part_degrees,
    volume_degree_rows,
)
from repro_torch.kernels.hop_eval import hop_cost  # noqa: E402
from repro_torch.kernels.hop_eval import kernel as hop_kernel  # noqa: E402
from repro_torch.kernels.lif_step import kernel as lif_kernel  # noqa: E402
from repro_torch.kernels.lif_step import lif_step  # noqa: E402
from repro_torch.kernels.link_load import kernel as link_kernel  # noqa: E402
from repro_torch.kernels.link_load import link_loads, window_link_loads  # noqa: E402
from repro_torch.kernels.link_load import edge_variance, flatten_link_maps  # noqa: E402
from repro_torch.kernels.link_load import (  # noqa: E402
    PAST,
    STEPPED,
    link_loads_records,
    link_loads_records_ref,
    link_loads_ref,
    record_link_loads,
    record_replay_screen,
    replay_screen,
)
from repro_torch.kernels.link_load.ref import dense_to_records, pack_routes  # noqa: E402
from repro_torch.kernels.swap_delta import kernel as swap_kernel  # noqa: E402
from repro_torch.kernels.swap_delta import swap_deltas, swap_deltas_pairs  # noqa: E402
from repro_torch.nocsim.replay import _inject_cycles, _window_ids  # noqa: E402

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


@pytest.mark.parametrize("n,e,k", [(1, 1, 1), (7, 5, 3), (128, 128, 128),
                                   (150, 90, 70), (260, 513, 130)])
def test_connectivity_degrees_plain_matches_reference(n, e, k):
    """Integer incidence against 0/1 presence: every sum is an exact f32
    integer, so the dense plain statement of the TPU kernel's product
    equals the reference bitwise."""
    inc = (RNG.random((n, e)) < 0.2).astype(np.float32) * RNG.integers(1, 9, (n, e))
    inc = inc.astype(np.float32)
    pres = (RNG.random((e, k)) < 0.3).astype(np.float32)
    got = connectivity_degrees_ref(t(inc), t(pres)).numpy()
    jargs = (jnp.asarray(inc), jnp.asarray(pres))
    np.testing.assert_array_equal(
        got, np.asarray(ref_gain.connectivity_degrees_ref(*jargs)))
    np.testing.assert_array_equal(
        got, np.asarray(ref_gain.connectivity_degrees(*jargs, backend="interpret")))
    rows = RNG.permutation(n)[: max(1, n // 3)].astype(np.int64)
    np.testing.assert_array_equal(
        connectivity_degrees_ref(t(inc), t(pres), t(rows)).numpy(), got[rows])


def _volume_case(n, pins, k, seed):
    """A reference hypergraph, a partition, its Φ and a random Φ in 0..3."""
    r = np.random.default_rng(seed)
    src, dst = r.integers(0, n, pins), r.integers(0, n, pins)
    hg = ref_build_hypergraph(n, src, dst, r.integers(1, 9, n))
    part = r.integers(0, k, n).astype(np.int64)
    phi = np.asarray(ref_edge_partition_counts(hg, part, k), dtype=np.int32)
    noise = r.integers(0, 4, phi.shape).astype(np.int32)
    return hg, part, phi, noise, r


@pytest.mark.parametrize("n,pins,k", [(1, 1, 1), (40, 200, 5), (120, 500, 66),
                                      (300, 2500, 130)])
def test_volume_degree_rows_plain_matches_reference(n, pins, k):
    """The plain volume_degree_rows over the incidence CSR equals the
    reference's _volume_degrees_via_kernel (its Pallas connectivity kernel
    in interpret mode plus the own-column overwrite) bitwise: with Φ from
    the partition (then also graph.volume_degrees) and with Φ drawn from
    0..3, so both presence halves matter; all rows and a permuted subset."""
    hg, part, phi, noise, r = _volume_case(n, pins, k, seed=n)
    vxadj, vedges = hg.incidence()
    csr = (t(vxadj.astype(np.int32)), t(vedges.astype(np.int32)),
           t(hg.hfire[vedges].astype(np.float32)))
    inc = ref_refine_vec._dense_incidence(hg)
    for table, extra in ((phi, ref_volume_degrees(hg, part, k)), (noise, None)):
        for rows in (np.arange(n, dtype=np.int64), r.permutation(n)[: n // 3 + 1]):
            want = ref_refine_vec._volume_degrees_via_kernel(
                inc, hg, part, k, rows, "interpret", phi=table)
            got = volume_degree_rows(*csr, t(table), t(rows), t(part[rows]))
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
            if extra is not None:
                np.testing.assert_array_equal(got.numpy(), extra[rows])
    all_rows = volume_degree_rows(*csr, t(noise), None, t(part)).numpy()
    np.testing.assert_array_equal(
        all_rows, ref_refine_vec._volume_degrees_via_kernel(
            inc, hg, part, k, np.arange(n), "interpret", phi=noise))


@pytest.mark.parametrize("n,k", [(7, 3), (200, 60), (513, 130)])
def test_gain_matrix_matches_reference(n, k):
    a = RNG.integers(0, 40, (n, n)).astype(np.float32)
    a = a + a.T
    np.fill_diagonal(a, 0)
    p = RNG.integers(0, k, n).astype(np.int32)
    got = gain_matrix(t(a), t(p), k).numpy()
    jargs = (jnp.asarray(a), jnp.asarray(p), k)
    np.testing.assert_array_equal(got, np.asarray(ref_gain.gain_matrix_ref(*jargs)))
    np.testing.assert_array_equal(
        got, np.asarray(ref_gain.gain_matrix(*jargs, backend="interpret")))
    np.testing.assert_array_equal(gain_matrix_ref(t(a), t(p), k).numpy(), got)
    assert (got[np.arange(n), p] == 0).all()


# -------------------------------------------------------------- hop_eval

@pytest.mark.parametrize("k", [1, 7, 25, 128, 256, 300, 513])
def test_hop_cost_plain_matches_reference(k):
    c = RNG.integers(0, 100, (k, k)).astype(np.float32)
    x = RNG.integers(0, 16, k).astype(np.float32)
    y = RNG.integers(0, 16, k).astype(np.float32)
    got = hop_cost(t(c), t(x), t(y))
    assert got.dtype == torch.float32 and got.dim() == 0
    jargs = (jnp.asarray(c), jnp.asarray(x), jnp.asarray(y))
    for want in (ref_hop.hop_cost_ref(*jargs),
                 ref_hop.hop_cost(*jargs, backend="interpret")):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    brute = (c.astype(np.float64) * (np.abs(x[:, None] - x[None, :])
                                     + np.abs(y[:, None] - y[None, :]))).sum()
    np.testing.assert_allclose(float(got), brute, rtol=1e-6)


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


@pytest.mark.parametrize("k,w", [(1, 1), (5, 5), (100, 16), (256, 16)])
def test_swap_deltas_plain_is_symmetric(k, w):
    """On symmetric traffic the delta matrix is symmetric (the CUDA kernel
    computes the upper tiles and mirrors them): exactly for integer
    traffic, where every sum is exact, and within the swap_deltas parity
    tolerance (rtol 1e-4 / atol 1e-2) otherwise."""
    place = RNG.permutation(max(k, w * w))[:k]
    x, y = t((place % w).astype(np.float32)), t((place // w).astype(np.float32))
    c = RNG.integers(0, 600, (k, k)).astype(np.float32)
    got = swap_deltas(t(c + c.T), x, y)
    assert torch.equal(got, got.T)
    c = RNG.random((k, k)).astype(np.float32)
    got = swap_deltas(t(c + c.T), x, y)
    torch.testing.assert_close(got, got.T, rtol=1e-4, atol=1e-2)


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


@pytest.mark.parametrize("k,w,h,pad", [(5, 5, 5, 0), (30, 8, 4, 3), (256, 16, 16, 1)])
def test_flatten_link_maps_matches_reference_bitwise(k, w, h, pad):
    """The reference's (E, W, S, N) maps, padded by ``pad`` rows and
    columns as a kernel's output may be, flatten to the same ids."""
    c = RNG.integers(0, 30, (k, k)).astype(np.float32)
    cores = RNG.permutation(w * h)[:k]
    maps = ref_link.link_loads_ref(jnp.asarray(c), jnp.asarray(cores % w),
                                   jnp.asarray(cores // w), w, h)
    maps = [jnp.pad(m, ((0, pad), (0, pad))) for m in maps]
    got = flatten_link_maps(*[t(np.asarray(m)) for m in maps], w, h)
    want = np.asarray(ref_link.flatten_link_maps(*maps, w, h))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,w,h", [(5, 5, 5), (30, 8, 4), (141, 16, 16), (256, 16, 16)])
def test_edge_variance_matches_reference(k, w, h):
    """Eq. 4-5 over partition traffic placed on the mesh: the reference's
    f32 variance within rtol 1e-6; float counts and int counts agree."""
    c = RNG.integers(0, 600, (k, k)) * (RNG.random((k, k)) < 0.3)
    cores = RNG.permutation(w * h)[:k]
    x, y = (cores % w).astype(np.int32), (cores // w).astype(np.int32)
    want = float(ref_link.edge_variance(jnp.asarray(c.astype(np.float32)),
                                        jnp.asarray(x), jnp.asarray(y), w, h,
                                        backend="jnp"))
    got = edge_variance(t(c), t(x), t(y), w, h)
    assert got.dtype == torch.float64 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    same = edge_variance(t(c.astype(np.float32)), t(x), t(y), w, h)
    assert float(same) == float(got)
    with pytest.raises(ValueError, match="integer"):
        edge_variance(t(c + 0.5), t(x), t(y), w, h)


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


def _packets(kind, w, h, n_win, per_window, seed):
    """Window-sorted packets (win, src core, dst core): unicast packets at
    random, or multicast replicas (each firing sends one packet to each of
    a few distinct cores), in windows 0..n_win-1 some of which stay empty."""
    rng = np.random.default_rng(seed)
    k = w * h
    used = np.sort(rng.choice(n_win, max(1, (n_win * 2) // 3), replace=False))
    wins, srcs, dsts = [], [], []
    for win in used:
        m = int(rng.integers(1, per_window + 1))
        if kind == "unicast":
            s, d = rng.integers(0, k, m), rng.integers(0, k, m)
            # Runs of one route, as consecutive packets of a firing give.
            s, d = np.repeat(s, 3)[:m], np.repeat(d, 3)[:m]
        else:
            fan = rng.integers(1, min(k, 6) + 1, m)
            s = np.repeat(rng.integers(0, k, m), fan)
            d = np.concatenate([rng.choice(k, f, replace=False) for f in fan])
        wins.append(np.full(s.shape[0], win))
        srcs.append(s)
        dsts.append(d)
    return (np.concatenate(wins).astype(np.int64),
            np.concatenate(srcs).astype(np.int64),
            np.concatenate(dsts).astype(np.int64))


def _dense_counts(win, s, d, n_win, k):
    counts = np.zeros((n_win, k, k), dtype=np.int64)
    np.add.at(counts, (win, s, d), 1)
    return counts


@pytest.mark.parametrize("kind,w,h,n_win,per_window", [
    ("unicast", 4, 4, 5, 40),       # some windows empty
    ("unicast", 4, 4, 1, 300),      # one window
    ("unicast", 3, 2, 300, 6),      # more than 256 windows
    ("multicast", 4, 4, 7, 30),
    ("multicast", 5, 3, 270, 4),
    ("unicast", 16, 16, 3, 2000),   # the slice's mesh
])
def test_record_link_loads_match_reference_and_dense(kind, w, h, n_win, per_window):
    """The packet-record plain version equals the reference's
    ``_window_loads_linkload`` and the port's dense ``window_link_loads``."""
    win, s, d = _packets(kind, w, h, n_win, per_window, seed=n_win)
    got = record_link_loads(win, s, d, n_win, w, h, device="cpu")
    assert got.dtype == np.int64 and got.shape == (n_win, 2 * (w - 1) * h
                                                   + 2 * w * (h - 1))
    want = ref_window_loads(win, s, d, n_win, w, h, backend="jnp")
    np.testing.assert_array_equal(got, want)
    dense = window_link_loads(_dense_counts(win, s, d, n_win, w * h), w, h,
                              device="cpu")
    np.testing.assert_array_equal(got, dense)
    assert got.sum() == np.abs(s % w - d % w).sum() + np.abs(s // w - d // w).sum()


def test_record_link_loads_of_no_packets():
    empty = np.empty(0, dtype=np.int64)
    got = record_link_loads(empty, empty, empty, 4, 3, 3, device="cpu")
    np.testing.assert_array_equal(got, np.zeros((4, 24), dtype=np.int64))
    assert record_link_loads(empty, empty, empty, 0, 3, 3,
                             device="cpu").shape == (0, 24)


@pytest.mark.parametrize("b,w,h", [(1, 5, 5), (4, 8, 4), (3, 16, 16)])
def test_weighted_records_match_dense_plain_version(b, w, h):
    """Dense counts as weighted records (one per non-zero entry) give the
    dense plain version's loads."""
    k = w * h
    counts = RNG.integers(0, 6, (b, k, k)) * (RNG.random((b, k, k)) < 0.2)
    counts[0] = 0  # an empty window
    c = t(counts.astype(np.int32))
    cores = torch.arange(k, dtype=torch.int32)
    x, y = cores % w, cores // w
    woff, rec, cnt = dense_to_records(c)
    assert woff.dtype == rec.dtype == cnt.dtype == torch.int32
    assert int(woff[-1]) == rec.shape[0] == int((counts != 0).sum())
    got = link_loads_records(woff, rec, cnt, x, y, w, h)
    assert torch.equal(got, link_loads_ref(c, x, y, w, h))
    assert torch.equal(got, link_loads_records_ref(woff, rec, cnt, x, y, w, h))


def test_route_records_pack_src_and_dst():
    s = torch.tensor([0, 5, 32767, 255])
    d = torch.tensor([0, 65535, 1, 255])
    rec = pack_routes(s, d)
    assert rec.dtype == torch.int32
    assert torch.equal((rec >> 16).long(), s) and torch.equal((rec & 0xFFFF).long(), d)


def test_record_link_loads_refuses_bad_windows():
    s = np.array([0, 1, 2])
    with pytest.raises(ValueError, match="sorted"):
        record_link_loads(np.array([0, 2, 1]), s, s, 3, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        record_link_loads(np.array([0, 1, 3]), s, s, 3, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="cores"):
        record_link_loads(np.zeros(3, np.int64), s, s, 1, 256, 256, device="cpu")


def _screen_trace(kind, w, h, inject_capacity, seed):
    """A replay's NoC-bound packets (win, src, dst, inject, n_win): window
    ids and injection cycles as the replay computes them.  ``random``: 6
    windows of random packets; ``single``: one window; ``quiet``: busy
    windows between windows of a few packets, which hold no hot pair;
    ``cold``: a few packets a window, no hot pair at all."""
    rng = np.random.default_rng(seed)
    k = w * h
    if kind == "quiet":
        sizes = [600, 3, 500, 2, 4, 700]
    else:
        sizes = {"random": [int(rng.integers(100, 700)) for _ in range(6)],
                 "single": [900], "cold": [1, 3, 2, 4, 1]}[kind]
    t = np.repeat(np.arange(len(sizes)) * 3, sizes)
    s, d = rng.integers(0, k, t.shape[0]), rng.integers(0, k, t.shape[0])
    d = np.where(s == d, (d + 1) % k, d)  # NoC-bound only
    # The short windows' packets hop 0 -> 1 -> 2 ...: no link is loaded
    # twice, so these windows hold no hot pair.
    for lo, n in zip(np.cumsum([0] + sizes[:-1]), sizes):
        if n < 5:
            s[lo:lo + n] = np.arange(n)
            d[lo:lo + n] = np.arange(n) + 1
    win, n_win = _window_ids(t)
    return win, s, d, _inject_cycles(win, s, k, inject_capacity), n_win


def _host_screens(win, s, d, inject, n_win, w, h, cap):
    """The replay's host screens on the ``linkload`` path as they were:
    packets crossing a (window, link) pair loaded above ``cap`` are past;
    of those, the packets of windows whose unobstructed (cycle, link)
    schedule oversubscribes a bucket are stepped, where a peak link load
    above ``cap`` x the window's span marks the window at once
    (pigeonhole).  Returns (past, stepped, per_link, counts)."""
    nl = 2 * (w - 1) * h + 2 * w * (h - 1)
    ids, pkt, step = link_ids_for_routes(s, d, w, h, with_steps=True)
    key = win[pkt] * nl + ids
    loads = np.bincount(key, minlength=n_win * nl)
    past = np.zeros(s.shape[0], dtype=bool)
    past[pkt[loads[key] > cap]] = True
    m = past[pkt]
    pw, cyc, link = win[pkt[m]], inject[pkt[m]] + step[m], ids[m]
    span = np.zeros(n_win, dtype=np.int64)
    np.maximum.at(span, pw, cyc + 1)
    peak = np.bincount(pw * nl + link, minlength=n_win * nl)
    bad = peak.reshape(n_win, nl).max(axis=1) > cap * span
    cycles = int(cyc.max()) + 1 if cyc.shape[0] else 1
    buckets = np.bincount((pw * cycles + cyc) * nl + link)
    bad[np.flatnonzero(buckets > cap) // (cycles * nl)] = True
    counts = dict(hot_pairs=int((loads > cap).sum()),
                  past_screen=int(past.sum()), bad_windows=int(bad.sum()))
    return past, past & bad[win], loads.reshape(n_win, nl).sum(axis=0), counts


@pytest.mark.parametrize("kind,w,h,link_capacity,inject_capacity", [
    *[("random", w, h, cap, inj) for w, h in ((4, 4), (5, 3), (16, 16))
      for cap in (1, 2, 4) for inj in (1, 3, 256)],
    ("single", 4, 4, 2, 3),
    ("quiet", 5, 3, 2, 256),
    ("cold", 4, 4, 4, 1),
])
def test_replay_screen_plain_matches_host_screens(kind, w, h, link_capacity,
                                                  inject_capacity):
    """The replay's two tier-1 screens in one pass (the plain version on
    CPU tensors) step exactly the packets the host screens stepped, with
    the same per-link totals and counts."""
    win, s, d, inject, n_win = _screen_trace(kind, w, h, inject_capacity,
                                             seed=w * h + link_capacity)
    past, stepped, per_link, counts = _host_screens(win, s, d, inject, n_win,
                                                    w, h, link_capacity)
    got_link, flags, got = record_replay_screen(
        win, s, d, inject, n_win, w, h, link_capacity, device="cpu")
    assert flags.dtype == np.uint8 and flags.shape == s.shape
    np.testing.assert_array_equal(flags & PAST != 0, past)
    np.testing.assert_array_equal(np.flatnonzero(flags & STEPPED),
                                  np.flatnonzero(stepped))
    np.testing.assert_array_equal(got_link, per_link)
    assert got == counts
    if kind == "cold":
        assert counts["hot_pairs"] == 0 and not flags.any()
    if kind == "quiet":
        assert 0 < counts["past_screen"] < s.shape[0]


# ------------------------------------------------------ dispatch / guards

def _tiny_csr(device="cpu"):
    """(vxadj, vedges, w, phi) of two vertices sharing one hyperedge, k = 3."""
    return (torch.tensor([0, 1, 2], dtype=torch.int32, device=device),
            torch.tensor([0, 0], dtype=torch.int32, device=device),
            torch.ones(2, device=device),
            torch.tensor([[2, 0, 1]], dtype=torch.int32, device=device))


@pytest.mark.parametrize("k,sms,blocks", [(1, 132, 1), (3, 132, 1),
                                           (141, 132, 20), (1000, 132, 528),
                                           (4096, 132, 528), (4096, 114, 456)])
def test_hop_cost_grid_fills_the_card_or_the_work(k, sms, blocks):
    """One launch's grid: a float4 vector a thread at small K, capped at
    BLOCKS_PER_SM blocks an SM."""
    assert hop_kernel.grid_blocks(k, sms) == blocks


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    def counts():
        return (lif_kernel.launches, gain_kernel.launches,
                gain_kernel.connectivity_launches, swap_kernel.launches,
                link_kernel.launches, link_kernel.screen_launches,
                hop_kernel.launches)

    before = counts()
    lif_step(torch.zeros(4), torch.zeros(4, dtype=torch.int32), torch.ones(4),
             **LIF_KW)
    part_degrees(torch.ones(3, 3), torch.zeros(3, dtype=torch.int32), 2)
    gain_matrix(torch.ones(3, 3), torch.zeros(3, dtype=torch.int32), 2)
    volume_degree_rows(*_tiny_csr(), None, torch.zeros(2, dtype=torch.int64))
    hop_cost(torch.ones(3, 3), torch.zeros(3), torch.zeros(3))
    swap_deltas(torch.ones(3, 3), torch.zeros(3), torch.zeros(3))
    link_loads(torch.ones(1, 4, 4, dtype=torch.int32),
               torch.tensor([0, 1, 0, 1], dtype=torch.int32),
               torch.tensor([0, 0, 1, 1], dtype=torch.int32), 2, 2)
    replay_screen(torch.tensor([0, 2], dtype=torch.int32),
                  pack_routes(torch.tensor([0, 1]), torch.tensor([3, 2])),
                  torch.zeros(2, dtype=torch.int32), 2, 2, 1)
    assert before == counts()


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never runs a plain version: it validates and raises."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        lif_kernel.lif_step_cuda(torch.zeros(4), torch.zeros(4, dtype=torch.int32),
                                 torch.ones(4), **LIF_KW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gain_kernel.part_degrees_cuda(torch.ones(3, 3),
                                      torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        gain_kernel.volume_degree_rows_cuda(*_tiny_csr(), None,
                                            torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        swap_kernel.swap_deltas_cuda(torch.ones(3, 3), torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        hop_kernel.hop_cost_cuda(torch.ones(3, 3), torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        link_kernel.link_loads_cuda(torch.ones(1, 4, 4, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32),
                                    torch.zeros(4, dtype=torch.int32), 2, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        link_kernel.replay_screen_cuda(torch.tensor([0, 1], dtype=torch.int32),
                                       torch.zeros(1, dtype=torch.int32),
                                       torch.zeros(1, dtype=torch.int32), 2, 2, 1)


def test_record_kernel_wrapper_refuses_cpu_tensors_and_counts_no_cpu_launch():
    woff = torch.tensor([0, 2], dtype=torch.int32)
    rec = pack_routes(torch.tensor([0, 1]), torch.tensor([3, 2]))
    x = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    y = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        link_kernel.link_loads_records_cuda(woff, rec, None, x, y, 2, 2)
    before = link_kernel.launches
    got = link_loads_records(woff, rec, None, x, y, 2, 2)
    assert link_kernel.launches == before
    assert int(got.sum()) == 4
    with pytest.raises(ValueError, match="cuda or cpu"):
        link_loads_records(woff.to("meta"), rec.to("meta"), None, x.to("meta"),
                           y.to("meta"), 2, 2)


def test_ops_refuse_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        part_degrees(torch.ones(3, 3, device="meta"),
                     torch.zeros(3, dtype=torch.int32, device="meta"), 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        volume_degree_rows(*_tiny_csr("meta"), None,
                           torch.zeros(2, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        hop_cost(torch.ones(3, 3, device="meta"), torch.zeros(3, device="meta"),
                 torch.zeros(3, device="meta"))


def test_kernel_build_hash_tracks_source():
    """Library names carry a hash of source + flags, so an edited source
    never loads a stale build; the build directory is the checkout's."""
    paths = {n: _build._lib_path(n) for n in _build.KERNELS}
    assert len(set(paths.values())) == len(_build.KERNELS)
    for name, path in paths.items():
        assert path.parent == _build.build_dir()
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()
