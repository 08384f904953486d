"""The port's CUDA kernels against their plain PyTorch versions on the
card: bitwise for lif_step (alone and fused with the synaptic product
over T steps), exact for part_degrees, volume_degree_rows
(the connectivity_degrees kernel), volume_select (the chosen set and its
counts, over calls sharing one slot state, and the volume refiner on the
card against the host) and link_loads (packet records, weighted
records and dense counts), exact for swap_deltas on
integer traffic and rtol 1e-4 / atol 1e-2 on fractional traffic, rtol
1e-6 (and bitwise repeatable, one launch) for hop_cost; and the device
searches and stepper on the card: the torch stepper against the numpy
stepper, the greedy polish on swap_deltas, the population SA's CUDA graph
against its eager epochs, the batched population SA's elements
against single searches, bitwise, and the island SA's repeatability,
quality bound and exchange.  Every test is marked ``cuda`` and skips
where CUDA is unavailable; this file imports torch and numpy only, so it
runs where the reference's JAX is not installed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gain_eval import kernel as gain_kernel  # noqa: E402
from repro_torch.kernels.gain_eval import part_degrees_ref  # noqa: E402
from repro_torch.kernels.gain_eval import volume_degree_rows_ref  # noqa: E402
from repro_torch.kernels.gain_eval import SelectSlots, volume_select_ref  # noqa: E402
from repro_torch.kernels.hop_eval import hop_cost_ref  # noqa: E402
from repro_torch.kernels.hop_eval import kernel as hop_kernel  # noqa: E402
from repro_torch.kernels.lif_step import kernel as lif_kernel  # noqa: E402
from repro_torch.kernels.lif_step import lif_step_ref, lif_steps_ref  # noqa: E402
from repro_torch.kernels.lif_step import synapses_from_dense  # noqa: E402
from repro_torch.kernels.link_load import kernel as link_kernel  # noqa: E402
from repro_torch.kernels.link_load import link_loads_records_ref  # noqa: E402
from repro_torch.kernels.link_load import link_loads_ref, window_link_loads  # noqa: E402
from repro_torch.kernels.link_load import replay_screen_ref  # noqa: E402
from repro_torch.kernels.link_load import edge_variance  # noqa: E402
from repro_torch.kernels.link_load.ref import dense_to_records, pack_routes  # noqa: E402
from repro_torch.snn import make_snn, profile_drive  # noqa: E402
from repro_torch.kernels.swap_delta import kernel as swap_kernel  # noqa: E402
from repro_torch.kernels.swap_delta import swap_deltas_ref  # noqa: E402

RNG = np.random.default_rng(0)
LIF_KW = dict(decay=0.9, threshold=1.0, v_reset=0.0, refractory=2)


@pytest.fixture
def cuda():
    """The card, or a skip where CUDA (and so nvcc's kernels) is absent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 127, 5120])
def test_lif_step_kernel_matches_plain_bitwise(cuda, n):
    v = torch.tensor(RNG.uniform(-0.5, 1.2, n).astype(np.float32), device=cuda)
    refr = torch.tensor(RNG.integers(0, 3, n).astype(np.int32), device=cuda)
    cur = torch.tensor(RNG.uniform(0, 0.6, n).astype(np.float32), device=cuda)
    got = lif_kernel.lif_step_cuda(v, refr, cur, **LIF_KW)
    want = lif_step_ref(v, refr, cur, **LIF_KW)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _population(name, steps):
    """(weights, drive) of edge_5120 as profile_snn drives it, or of a
    random sparse population whose first columns have no synapses and whose
    size is not a multiple of the kernel's 64-thread block."""
    if name == "edge_5120":
        topo = make_snn(name)
        return topo.weights.astype(np.float32), profile_drive(topo, steps, 0)
    n = int(name)
    w = RNG.standard_normal((n, n)).astype(np.float32)
    w *= RNG.random((n, n)) < 0.05
    w[:, : n // 5] = 0.0
    return w, RNG.uniform(0.3, 1.2, (steps, n)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("name,steps", [("edge_5120", 60), ("1", 3),
                                        ("1000", 40), ("333", 1)])
def test_fused_lif_kernel_matches_plain_bitwise(cuda, name, steps):
    """T steps from rest (t = 0 reads no previous spikes): raster, v and
    refr bitwise equal to the plain fused version, one launch a step."""
    w, drive = _population(name, steps)
    syn = synapses_from_dense(torch.from_numpy(w)).to(cuda)
    d = torch.from_numpy(drive).to(cuda)
    kw = dict(LIF_KW, refractory=1)
    before = lif_kernel.launches
    got = lif_kernel.lif_steps_cuda(syn.src, syn.w, syn.deg, d, **kw)
    assert lif_kernel.launches == before + steps
    want = lif_steps_ref(syn.src, syn.w, syn.deg, d, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[0].sum()) > 0


@pytest.mark.cuda
def test_fused_lif_kernel_builds_synapses_on_the_card(cuda):
    w, _ = _population("500", 1)
    on_card = synapses_from_dense(torch.from_numpy(w).to(cuda))
    on_host = synapses_from_dense(torch.from_numpy(w))
    for a, b in ((on_card.src, on_host.src), (on_card.w, on_host.w),
                 (on_card.deg, on_host.deg)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(7, 3), (513, 130), (3072, 141)])
def test_part_degrees_kernel_matches_plain_exactly(cuda, n, k):
    a = RNG.integers(0, 40, (n, n)).astype(np.float32) * (RNG.random((n, n)) < 0.05)
    a = a + a.T
    adj = torch.tensor(a, device=cuda)
    part = torch.tensor(RNG.integers(0, k, n).astype(np.int32), device=cuda)
    rows = torch.tensor(RNG.permutation(n)[: n // 2 + 1], device=cuda)
    assert torch.equal(gain_kernel.part_degrees_cuda(adj, part, k, rows),
                       part_degrees_ref(adj, part, k, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,k,longest", [(7, 5, 3, 5), (260, 513, 130, 500),
                                           (50, 64, 300, 64),
                                           (3072, 4096, 141, 700)])
def test_connectivity_degrees_kernel_matches_plain_exactly(cuda, n, e, k, longest):
    """volume_degree_rows on a sparse incidence CSR (integer hfire-like
    weights, lists up to ``longest`` entries: longer than the kernel's
    256-entry shared segment) against Φ in 0..3, all rows and a subset;
    k = 300 runs two column passes."""
    counts = RNG.integers(0, longest + 1, n)
    vxadj = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    vedges = np.concatenate(
        [RNG.choice(e, c, replace=False) for c in counts]).astype(np.int32)
    args = (torch.tensor(vxadj, device=cuda), torch.tensor(vedges, device=cuda),
            torch.tensor(RNG.integers(1, 9, vedges.shape[0]).astype(np.float32),
                         device=cuda),
            torch.tensor(RNG.integers(0, 4, (e, k)).astype(np.int32), device=cuda))
    own = torch.tensor(RNG.integers(0, k, n), device=cuda)
    rows = torch.tensor(RNG.permutation(n)[: n // 2 + 1], device=cuda)
    for r, o in ((rows, own[rows]), (None, own)):
        assert torch.equal(gain_kernel.volume_degree_rows_cuda(*args, r, o),
                           volume_degree_rows_ref(*args, r, o))


def _select_call(rng, n, nc, cols):
    """One selection call's candidates: ids, own and target columns drawn
    from the first ``cols`` columns (fewer columns, more contention) and
    distinct priorities 1..nc."""
    cand = np.sort(rng.choice(n, nc, replace=False))
    own = rng.integers(0, cols, nc)
    target = (own + rng.integers(1, cols, nc)) % cols
    pri = np.empty(nc, dtype=np.int64)
    pri[rng.permutation(nc)] = np.arange(nc, 0, -1)
    return [torch.tensor(a.astype(np.int32)) for a in (cand, own, target, pri)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,e,k,nc,longest,cols", [
    (7, 5, 3, 4, 5, 3),             # tiny, every slot shared
    (600, 300, 64, 40, 30, 64),     # a positive call: few candidates
    (3072, 4096, 141, 2000, 66, 141),  # an escape call's shape
    (5120, 4096, 141, 4000, 60, 4),    # > 100k contended keys
])
def test_volume_select_kernel_matches_plain_exactly(cuda, n, e, k, nc, longest,
                                                    cols):
    """volume_select against its plain version: the chosen bytes and the
    header (contended keys, rounds run) equal, over three calls sharing one
    slot state with Φ changed between them, and the counts left at zero."""
    rng = np.random.default_rng(n)
    counts = rng.integers(0, longest + 1, n)
    vxadj = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    vedges = np.concatenate(
        [rng.choice(e, c, replace=False) for c in counts]).astype(np.int32)
    phi = torch.tensor(rng.integers(0, 3, (e, k)).astype(np.int32))
    csr = (torch.tensor(vxadj), torch.tensor(vedges))
    slots = SelectSlots(phi.numel(), cuda)
    before = gain_kernel.select_launches
    for call in range(3):
        args = _select_call(rng, n, nc, cols)
        want = volume_select_ref(*csr, phi, *args, 4)
        got = gain_kernel.volume_select_cuda(
            *(t.to(cuda) for t in csr), phi.to(cuda),
            *(t.to(cuda) for t in args), 4, slots)
        assert torch.equal(got.cpu(), want)
        head = want[:8].view(torch.int32).tolist()
        if nc >= 4000:
            assert head[0] > 100_000
        phi = torch.clamp(phi + torch.tensor(
            rng.integers(-1, 2, (e, k)).astype(np.int32)), min=0)
    assert gain_kernel.select_launches == before + 3
    assert slots.calls == 3
    assert not slots.buf[:slots.slots].any()  # the counts are zero at rest


@pytest.mark.cuda
@pytest.mark.parametrize("k,cap", [(60, 30), (80, 20)])
def test_volume_refine_on_the_card_equals_the_host(cuda, k, cap):
    """refine_level_vec on the card (the selection kernel on every level,
    the connectivity kernel where k >= 64) gives the host's partition and
    score, every selection span reading ``kernel``, one launch each."""
    from repro_torch import spans
    from repro_torch.core.initpart import greedy_region_growing
    from repro_torch.core.refine_vec import refine_level_vec
    from torch_builders import fanout_snn_graph

    g = fanout_snn_graph(1500, seed=1)
    p0 = greedy_region_growing(g, k, cap, np.random.default_rng(1))
    want = refine_level_vec(g, p0.copy(), k, cap, objective="volume",
                            device="cpu")
    before = gain_kernel.select_launches
    spans.clear()
    with spans.recording():
        got = refine_level_vec(g, p0.copy(), k, cap, objective="volume",
                               device=cuda)
    sel = [s for s in spans.spans() if s.name == "sneap.partition.refine.select"]
    spans.clear()
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert sel and {s.attrs["engine"] for s in sel} == {"kernel"}
    assert gain_kernel.select_launches - before == len(sel)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 141, 256, 513, 1000, 4096])
@pytest.mark.parametrize("offset", [0, 1])
def test_hop_cost_kernel_matches_plain_and_repeats(cuda, k, offset):
    """One launch a call, rtol 1e-6 to the plain version, bitwise
    repeatable; ``offset`` = 1 starts the traffic and the coordinates 4
    bytes past a 16-byte boundary (the kernel's scalar head and its
    row-wrapping vector path)."""
    def placed(a):
        buf = torch.tensor(np.concatenate([np.zeros(offset, np.float32),
                                           a.astype(np.float32).ravel()]),
                           device=cuda)
        return buf[offset:].view(a.shape)

    c = placed(RNG.integers(0, 100, (k, k)))
    x = placed(RNG.integers(0, 16, k))
    y = placed(RNG.integers(0, 16, k))
    before = hop_kernel.launches
    got = hop_kernel.hop_cost_cuda(c, x, y)
    assert hop_kernel.launches == before + 1
    assert got.dim() == 0 and got.dtype == torch.float32
    torch.testing.assert_close(got, hop_cost_ref(c, x, y), rtol=1e-6, atol=0.0)
    for _ in range(3):
        assert torch.equal(hop_kernel.hop_cost_cuda(c, x, y), got)


def _swap_inputs(cuda, k, traffic):
    """Symmetric traffic C + C^T and coordinates on the smallest square
    mesh with k cores (16 x 16 up to 256, 32 x 32 beyond)."""
    w = 16 if k <= 256 else 32
    place = RNG.permutation(max(k, w * w))[:k]
    sym = torch.tensor(traffic + traffic.T, device=cuda)
    x = torch.tensor((place % w).astype(np.float32), device=cuda)
    y = torch.tensor((place // w).astype(np.float32), device=cuda)
    return sym, x, y


@pytest.mark.cuda
@pytest.mark.parametrize("k,top", [(1, 50), (5, 50), (16, 8000), (100, 50),
                                   (256, 50), (300, 50), (1024, 50), (1030, 50)])
def test_swap_deltas_kernel_matches_plain_exactly_on_integer_traffic(cuda, k, top):
    """Integer traffic whose sums stay below 2^24 (top = 8000 needs the
    second TF32 split): the split-TF32 tensor core products are exact, so
    the kernel equals the plain version bit for bit; the output is
    symmetric with a zero diagonal, in one launch."""
    sym, x, y = _swap_inputs(cuda, k, RNG.integers(0, top, (k, k)).astype(np.float32))
    before = swap_kernel.launches
    got = swap_kernel.swap_deltas_cuda(sym, x, y)
    assert swap_kernel.launches == before + 1
    assert torch.equal(got, swap_deltas_ref(sym, x, y))
    assert torch.equal(got, got.T)
    assert float(torch.diagonal(got).abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 100, 256, 300])
def test_swap_deltas_kernel_matches_plain(cuda, k):
    """Fractional traffic in [0, 2): within rtol 1e-4 / atol 1e-2 of the
    plain f32 version (both round their f32 sums, in different orders)."""
    sym, x, y = _swap_inputs(cuda, k, RNG.random((k, k)).astype(np.float32))
    got = swap_kernel.swap_deltas_cuda(sym, x, y)
    torch.testing.assert_close(got, swap_deltas_ref(sym, x, y), rtol=1e-4, atol=1e-2)
    assert torch.equal(got, got.T)
    assert float(torch.diagonal(got).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,h", [(1, 5, 5), (3, 8, 4), (256, 16, 16)])
def test_link_loads_kernel_matches_plain_exactly(cuda, b, w, h):
    k = w * h
    counts = RNG.integers(0, 5, (b, k, k)) * (RNG.random((b, k, k)) < 0.1)
    counts = torch.tensor(counts.astype(np.int32), device=cuda)
    cores = torch.arange(k, dtype=torch.int32, device=cuda)
    x, y = cores % w, cores // w
    assert torch.equal(link_kernel.link_loads_cuda(counts, x, y, w, h),
                       link_loads_ref(counts, x, y, w, h))


def _mesh(cuda, w, h):
    cores = torch.arange(w * h, dtype=torch.int32, device=cuda)
    return cores % w, cores // w


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "one_route", "weighted", "empty",
                                  "many_windows", "slice"])
def test_link_loads_record_kernel_matches_plain_exactly(cuda, case):
    """Packet records: at random over windows with empty ones among them;
    every packet on one route (the warp aggregation's worst case); weighted
    records; no packets; 600 short windows (segments below the shared
    histogram's threshold); the check shape of the slice."""
    w, h = (16, 16) if case in ("one_route", "slice") else (8, 4)
    k = w * h
    sizes = {"random": RNG.integers(0, 3000, 9), "one_route": [50_000, 7],
             "weighted": RNG.integers(0, 500, 5), "empty": [0, 0, 0],
             "many_windows": RNG.integers(0, 40, 600),
             "slice": np.full(256, 8000)}[case]
    n = int(np.sum(sizes))
    woff = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32),
                        device=cuda)
    if case == "one_route":
        s, d = torch.full((n,), 17, device=cuda), torch.full((n,), 250, device=cuda)
    else:
        s = torch.tensor(RNG.integers(0, k, n), device=cuda)
        d = torch.tensor(RNG.integers(0, k, n), device=cuda)
    rec = pack_routes(s, d)
    count = (torch.tensor(RNG.integers(0, 9, n).astype(np.int32), device=cuda)
             if case == "weighted" else None)
    x, y = _mesh(cuda, w, h)
    before = link_kernel.launches
    got = link_kernel.link_loads_records_cuda(woff, rec, count, x, y, w, h)
    assert link_kernel.launches == before + 1
    assert got.shape == (len(sizes), 2 * (w - 1) * h + 2 * w * (h - 1))
    assert torch.equal(got, link_loads_records_ref(woff, rec, count, x, y, w, h))


def _screen_case(case):
    """(mesh w, h, link capacity, windows of (src, dst, inject) arrays)."""
    def random_window(n, k, inj_cap, cores=None):
        s = RNG.integers(0, k, n) if cores is None else RNG.choice(cores, n)
        d = (s + RNG.integers(1, k, n)) % k
        rank = np.zeros(n, dtype=np.int64)
        for c in np.unique(s):
            rank[s == c] = np.arange((s == c).sum())
        return s, d, rank // inj_cap

    if case == "random":  # the replay's capacities, empty windows among them
        return 16, 16, 4, [random_window(int(n), 256, 256)
                           for n in RNG.integers(0, 4000, 12)]
    if case == "few_sources":  # inject up to ~250: four bucket passes
        return 16, 16, 1, [random_window(2000, 256, 1, cores=np.arange(8))]
    if case == "late_conflict":
        # Core 0 sends 200 packets east along row 0, core 1 first 100 west,
        # then 100 east: no (cycle, link) bucket holds two until cycle 100,
        # past the first pass's cycles on 16 x 16; a second window stays
        # clean through all its passes (one source, one packet a cycle).
        a = (np.zeros(200, int), np.full(200, 15), np.arange(200))
        b = (np.ones(200, int), np.r_[np.zeros(100, int), np.full(100, 15)],
             np.arange(200))
        clean = (np.zeros(300, int), np.full(300, 15), np.arange(300))
        return 16, 16, 1, [tuple(np.r_[x, y] for x, y in zip(a, b)), clean]
    if case in ("cap_16bit", "cap_32bit"):  # one route, counters wider than 8 bits
        n, inj_cap, cap = ((80_000, 256, 255) if case == "cap_16bit"
                           else (80_000, 100_000, 70_000))
        return 16, 16, cap, [(np.full(n, 17), np.full(n, 250),
                              np.arange(n) // inj_cap)]
    return 4, 4, 2, [random_window(int(n), 16, 3)  # small mesh, many windows
                     for n in RNG.integers(1, 60, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "few_sources", "late_conflict",
                                  "cap_16bit", "cap_32bit", "many_windows"])
def test_replay_screen_kernel_matches_plain_exactly(cuda, case):
    """The replay's two screens in one launch: flags, per-link totals and
    counts equal the plain version's, on random windows (empty ones among
    them), windows whose cycles need several bucket passes, a conflict only
    past the first pass, bucket counters of 16 and 32 bits, and 300 short
    windows on a 4 x 4 mesh."""
    w, h, cap, windows = _screen_case(case)
    sizes = [len(x[0]) for x in windows]
    woff = torch.tensor(np.r_[0, np.cumsum(sizes)].astype(np.int32), device=cuda)
    s, d, inj = (torch.tensor(np.concatenate([x[i] for x in windows]),
                              device=cuda) for i in range(3))
    rec = pack_routes(s, d)
    inj = inj.to(torch.int32)
    before = link_kernel.screen_launches
    flags, totals = link_kernel.replay_screen_cuda(woff, rec, inj, w, h, cap)
    assert link_kernel.screen_launches == before + 1
    want_flags, want_totals = replay_screen_ref(woff, rec, inj, w, h, cap)
    assert torch.equal(flags, want_flags)
    assert torch.equal(totals, want_totals)
    if case == "late_conflict":  # the first window steps, the clean one not
        assert bool((flags[:400] == 3).all()) and bool((flags[400:] == 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k,w,h", [(5, 5, 5), (141, 16, 16), (256, 16, 16)])
def test_edge_variance_kernel_matches_plain(cuda, k, w, h):
    """Eq. 4-5 on the card (one link_loads launch) equals the CPU's plain
    version within rtol 1e-12: the loads are exact integers on both, and
    the f64 variance over them reduces in another order on the card."""
    c = RNG.integers(0, 600, (k, k)) * (RNG.random((k, k)) < 0.3)
    cores = RNG.permutation(w * h)[:k]
    x = torch.tensor((cores % w).astype(np.int32))
    y = torch.tensor((cores // w).astype(np.int32))
    traffic = torch.tensor(c.astype(np.int32))
    before = link_kernel.launches
    got = edge_variance(traffic.to(cuda), x.to(cuda), y.to(cuda), w, h)
    assert link_kernel.launches == before + 1
    assert got.device.type == "cuda"
    np.testing.assert_allclose(float(got), float(edge_variance(traffic, x, y, w, h)),
                               rtol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,h", [(3, 8, 4), (300, 4, 4)])
def test_dense_counts_through_window_link_loads(cuda, b, w, h):
    k = w * h
    counts = RNG.integers(0, 5, (b, k, k)) * (RNG.random((b, k, k)) < 0.1)
    counts[b // 2] = 0
    got = window_link_loads(counts, w, h, device="cuda", chunk=128)
    cores = torch.arange(k, dtype=torch.int32)
    want = link_loads_ref(torch.tensor(counts.astype(np.int32)), cores % w,
                          cores // w, w, h)
    np.testing.assert_array_equal(got, want.numpy().astype(np.int64))
    c = torch.tensor(counts.astype(np.int32), device=cuda)
    woff, rec, cnt = dense_to_records(c)
    x, y = _mesh(cuda, w, h)
    assert torch.equal(link_kernel.link_loads_records_cuda(woff, rec, cnt, x, y, w, h),
                       link_loads_ref(c, x, y, w, h))


@pytest.mark.cuda
@pytest.mark.parametrize("link_capacity", [1, 2, 4])
def test_device_stepper_on_the_card_equals_numpy_stepper(cuda, link_capacity):
    """A few thousand random packets over 12 windows of a 16 x 16 mesh: the
    torch stepper on the card gives the numpy joint stepper's latencies
    and blocked count."""
    from repro_torch.nocsim.replay import _joint_stepper
    from repro_torch.nocsim.replay_device import joint_stepper_device
    from repro_torch.nocsim.xy import link_count, link_ids_for_routes

    w = h = 16
    n = 6000
    src = RNG.integers(0, w * h, n)
    dst = (src + RNG.integers(1, w * h, n)) % (w * h)
    win = np.sort(RNG.integers(0, 12, n))
    inject = RNG.integers(0, 8, n)
    nl = link_count(w, h)
    ids, pkt, step = link_ids_for_routes(src, dst, w, h, with_steps=True)
    want = _joint_stepper(ids, pkt, step, np.bincount(pkt, minlength=n), inject,
                          win, nl, link_capacity, 100_000)
    got = joint_stepper_device(src, dst, inject, win, w, h, nl, link_capacity,
                               100_000, device=cuda)
    assert want[1] > 0
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.cuda
def test_greedy_polish_on_the_card_reaches_a_swap_local_optimum(cuda):
    """The polish on the swap_deltas kernel: every step one launch, the
    result a swap-local optimum under the card's own deltas, and equal to
    the CPU polish on integer traffic."""
    from repro_torch.core import mapping_device as md

    rng = np.random.default_rng(7)  # a start that converges in < 256 steps
    k, cores, w = 141, 256, 16
    c = np.zeros((cores, cores), np.float32)
    c[:k, :k] = rng.integers(0, 300, (k, k)) * (rng.random((k, k)) < 0.1)
    np.fill_diagonal(c, 0.0)
    sym = torch.tensor(c + c.T, device=cuda)
    x, y = md._coords(cores, w, cuda)
    start = torch.tensor(rng.permutation(cores), device=cuda)
    before = swap_kernel.launches
    got, steps = md.greedy_polish(sym, start, x, y)
    assert swap_kernel.launches == before + steps and 1 < steps < 256
    deltas = swap_kernel.swap_deltas_cuda(sym, x[got], y[got])
    deltas.fill_diagonal_(float("inf"))
    assert float(deltas.min()) >= -1e-6
    cpu, cpu_steps = md.greedy_polish(sym.cpu(), start.cpu(), x.cpu(), y.cpu())
    assert torch.equal(got.cpu(), cpu) and steps == cpu_steps


@pytest.mark.cuda
def test_population_sa_graph_replay_equals_eager_epochs(cuda):
    """The CUDA graph of an SA epoch gives, on the same draws, the eager
    epoch's placements and costs; sa_search_jax on the card is injective,
    repeatable and within 1.15x of the serial SA."""
    from repro_torch.core import mapping_device as md
    from repro_torch.core.hopcost import hop_distance_matrix
    from repro_torch.core.mapping import pad_traffic, sa_search

    c = RNG.integers(0, 100, (15, 15)).astype(np.float64)
    np.fill_diagonal(c, 0)
    padded = pad_traffic(c, 25)
    sym = torch.tensor(padded + padded.T, dtype=torch.float64, device=cuda)
    dist = torch.tensor(hop_distance_matrix(25, 5), dtype=torch.float64,
                        device=cuda)
    pops = []
    for _ in range(2):
        gen = torch.Generator(device=cuda)
        gen.manual_seed(5)
        start = torch.rand((4, 25), generator=gen, device=cuda).argsort(dim=1)
        pops.append(md._Population(sym[None], dist, start[None], [50.0], 64,
                                   [gen]))
    graphed, eager = pops
    for _ in range(3):
        best = graphed.run_epoch()
        eager.draw()
        eager.epoch()
        assert torch.equal(graphed.placement, eager.placement)
        assert torch.equal(graphed.cost, eager.cost)
        assert torch.equal(best, eager.best)
    trace_len = int(c.sum())
    a = md.sa_search_jax(c, 25, 5, trace_len, seed=0, iters=2_000, chains=4,
                         device=cuda)
    b = md.sa_search_jax(c, 25, 5, trace_len, seed=0, iters=2_000, chains=4,
                         device=cuda)
    np.testing.assert_array_equal(a.placement, b.placement)
    assert len(set(a.placement.tolist())) == 15
    r_np = sa_search(c, 25, 5, trace_len, seed=0, iters=15_000, device="cpu")
    assert a.avg_hop <= 1.15 * r_np.avg_hop


@pytest.mark.cuda
@pytest.mark.parametrize("k,cores,w,top", [(12, 16, 4, 50), (141, 256, 16, 60_000)])
def test_population_sa_batch_equals_single_on_the_card(cuda, k, cores, w, top):
    """Element i of sa_search_jax_batch is bitwise the single call on the
    card, also where the traffic's f32 sums would round (the second
    case's row sums exceed 2^24 once multiplied by hop distances)."""
    from repro_torch.core import mapping_device as md

    rng = np.random.default_rng(k)
    traffics = []
    for kk in (k, k - 2, k):
        t = rng.integers(0, top, (kk, kk)).astype(np.float64)
        np.fill_diagonal(t, 0)
        traffics.append(t)
    tls = [int(t.sum()) for t in traffics]
    seeds = [5, 9, 5]
    kw = dict(iters=1_280, chains=8, device=cuda)
    batch = md.sa_search_jax_batch(traffics, cores, w, tls, seeds, **kw)
    for t, tl, s, b in zip(traffics, tls, seeds, batch):
        single = md.sa_search_jax(t, cores, w, tl, seed=s, **kw)
        np.testing.assert_array_equal(single.placement, b.placement)
        assert single.avg_hop == b.avg_hop and single.history == b.history
        assert len(set(b.placement.tolist())) == t.shape[0]


@pytest.mark.cuda
def test_island_sa_on_the_card_repeats_and_meets_the_bound(cuda):
    """tests/test_island_sa.py's inputs on the card: the islands' graphed
    epochs and on-device exchange give an injective placement within 1.3x
    the serial SA, the same for the same seed."""
    from repro_torch.core.mapping import sa_search
    from repro_torch.core.mapping_device import island_sa

    rng = np.random.default_rng(0)
    k, cores, w = 12, 16, 4
    c = rng.integers(0, 100, (k, k)).astype(np.float64)
    np.fill_diagonal(c, 0)
    tl = int(c.sum())
    kw = dict(n_dev=4, rounds=2, iters_per_round=1500, chains_per_device=2,
              seed=0, device=cuda)
    a = island_sa(c, cores, w, tl, **kw)
    b = island_sa(c, cores, w, tl, **kw)
    np.testing.assert_array_equal(a.placement, b.placement)
    assert a.avg_hop == b.avg_hop
    assert len(set(a.placement.tolist())) == k
    serial = sa_search(c, cores, w, tl, seed=0, iters=6000, device=cuda)
    assert a.avg_hop <= 1.3 * serial.avg_hop


@pytest.mark.cuda
def test_island_exchange_on_the_card_matches_a_recount(cuda):
    """After graphed epochs on the card, the exchange puts the lowest-cost
    chain of all islands, and its cost, into each island's highest-cost
    chain and leaves every other chain alone; every cost equals an f64
    recount of its chain on the host."""
    from repro_torch.core import mapping_device as md
    from repro_torch.core.hopcost import hop_distance_matrix
    from repro_torch.core.mapping import pad_traffic

    rng = np.random.default_rng(0)
    k, cores, w = 12, 16, 4
    c = rng.integers(0, 100, (k, k)).astype(np.float64)
    np.fill_diagonal(c, 0)
    padded = pad_traffic(c, cores)
    sym_np = padded + padded.T
    dist_np = hop_distance_matrix(cores, w).astype(np.float64)
    sym = torch.tensor(sym_np, dtype=torch.float64, device=cuda)
    dist = torch.tensor(dist_np, dtype=torch.float64, device=cuda)
    islands, chains = 4, 3
    gens, starts = zip(*(md._chains(s, chains, cores, cuda)
                         for s in range(islands)))
    pop = md._Population(sym.expand(islands, cores, cores), dist,
                         torch.stack(starts), [40.0] * islands, 64, list(gens))
    for _ in range(3):
        pop.run_epoch()
    before_place = pop.placement.cpu().numpy()
    before_cost = pop.cost.cpu().numpy()
    g = int(before_cost.reshape(-1).argmin())
    best_place = before_place.reshape(-1, cores)[g]
    worst = before_cost.argmax(axis=1)
    md._exchange(pop.placement, pop.cost)
    after_place = pop.placement.cpu().numpy()
    after_cost = pop.cost.cpu().numpy()
    for i in range(islands):
        for p in range(chains):
            pl = after_place[i, p]
            recount = (sym_np * dist_np[pl[:, None], pl[None, :]]).sum() / 2.0
            assert after_cost[i, p] == recount
            if p == int(worst[i]):
                np.testing.assert_array_equal(pl, best_place)
                assert after_cost[i, p] == before_cost.reshape(-1)[g]
            else:
                np.testing.assert_array_equal(pl, before_place[i, p])
                assert after_cost[i, p] == before_cost[i, p]
