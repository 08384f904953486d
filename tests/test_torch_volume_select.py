"""The volume refiner's conflict-free mover selection on the CPU: the plain
PyTorch selection (``gain_eval.volume_select_ref``, the kernel's plain
version) against the numpy selection (``refine_vec._select_volume_host``)
on the calls the refiner makes, positive and escape (jittered), on small
generated hypergraphs and on coarse levels of the edge_5120 network, and on
calls where every candidate is contended, through each of the numpy
selection's branches; and ``refine_level_vec`` with the device selection
forced to its plain version, bitwise the numpy path's and the reference's."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from torch_parity import assert_bitwise, pair  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import refine_vec as rv  # noqa: E402
from repro_torch.core.coarsen import coarsen  # noqa: E402
from repro_torch.core.graph import edge_partition_counts  # noqa: E402
from repro_torch.core.initpart import greedy_region_growing  # noqa: E402
from repro_torch.core.refine import project  # noqa: E402
from repro_torch.kernels.gain_eval import read_select, volume_select_ref  # noqa: E402
from repro_torch.snn import make_snn, profile_snn  # noqa: E402

SELECT = "sneap.partition.refine.select"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its tensors are small, and
    idle worker threads of several test processes at once on the same cores
    cost many times the work itself."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plain(hyper, phi, part, target, cand, pri):
    """The plain selection's (chosen ids, contended keys, rounds)."""
    vxadj, vedges = hyper.incidence()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))
    chosen, contended, rounds = read_select(volume_select_ref(
        t(vxadj), t(vedges), t(phi), t(cand), t(part[cand]), t(target[cand]),
        t(pri), rv._LUBY_ROUNDS))
    return cand[chosen], contended, rounds


def _assert_same(got, movers, contended, rounds):
    np.testing.assert_array_equal(got[0], np.sort(movers))
    assert got[1:] == (contended, rounds)


def _checked_calls(monkeypatch, g, part, k, cap, every=4):
    """Refine ``part`` on the numpy selection, holding every ``every``-th
    call's movers, contended keys and rounds to the plain selection's on
    the same inputs (Φ, partition and targets as they are at that call).
    Returns the checked calls' (escape, contended keys)."""
    checked = []
    real = rv._select_volume_host
    calls = iter(range(1 << 30))

    def check(hyper, k_, part_, target, cand, pri, phi=None, **kw):
        got = real(hyper, k_, part_, target, cand, pri, phi=phi, **kw)
        i = next(calls)
        if i % every == 0:
            _assert_same(_plain(hyper, phi, part_, target, cand, pri), *got)
            checked.append((i, got[1]))
        return got

    monkeypatch.setattr(rv, "_select_volume_host", check)
    spans.clear()
    with spans.recording():
        rv.refine_level_vec(g, part, k, cap, objective="volume",
                            use_kernel=False, device="cpu")
    sel = [s for s in spans.spans() if s.name == SELECT]
    spans.clear()
    assert len(sel) == next(calls) > 0
    return [(sel[i].attrs["escape"], contended) for i, contended in checked]


@pytest.fixture(scope="module")
def edge_levels():
    """Coarse levels of the edge_5120 network (its synapses, fire counts
    from a short profile), coarsened as the partitioner does at k = 141,
    capacity 40, with the region-grown start on the coarsest."""
    prof = profile_snn(make_snn("edge_5120"), num_steps=120, seed=0,
                       device="cpu")
    k, cap = 141, 40
    levels = coarsen(prof.graph, np.random.default_rng(0),
                     coarsen_to=4 * k, max_vwgt=cap // 3, impl="vec",
                     contract_hyper=True)
    p0 = greedy_region_growing(levels[-1], k, cap, np.random.default_rng(0),
                               impl="auto")
    return levels, p0, k, cap


def _case(name, edge_levels):
    if name == "edge_5120_coarsest":
        levels, p0, k, cap = edge_levels
        return levels[-1], p0, k, cap
    if name == "edge_5120_next":
        levels, p0, k, cap = edge_levels
        p1, _ = rv.refine_level_vec(levels[-1], p0, k, cap,
                                    objective="volume", device="cpu")
        return levels[-2], project(p1, levels[-1].cmap), k, cap
    args, k, cap, seed = {
        "fanout_1500": (("fanout_snn_graph", 1500), 60, 30, 1),
        "fanout_400": (("fanout_snn_graph", 400), 40, 12, 3),
        "random_1200": (("random_hypergraph", 1200, 7200), 40, 36, 1),
    }[name]
    _, g = pair(*args, seed=seed)
    p0 = greedy_region_growing(g, k, cap, np.random.default_rng(seed))
    return g, p0, k, cap


@pytest.mark.parametrize("name", ["fanout_1500", "fanout_400", "random_1200",
                                  "edge_5120_coarsest", "edge_5120_next"])
def test_plain_selection_equals_numpy_on_the_refiners_calls(
        monkeypatch, edge_levels, name):
    g, p0, k, cap = _case(name, edge_levels)
    checked = _checked_calls(monkeypatch, g, p0, k, cap)
    assert {esc for esc, _ in checked} == {False, True}  # positive, escape
    assert max(contended for _, contended in checked) > 0


class _Incidence:
    """A hypergraph as the selection reads it: its vertex -> edge CSR."""

    def __init__(self, vxadj, vedges):
        self._inc = (vxadj, vedges)

    def incidence(self):
        return self._inc


@pytest.mark.parametrize("branch", ["bincount", "buffered", "no_phi"])
@pytest.mark.parametrize("seed", [0, 1])
def test_every_candidate_contended(branch, seed):
    """Every candidate leaves column 0 of hyperedge 0, whose count is 1:
    no candidate is free, so the rounds alone pick the movers; the numpy
    selection's three ways of counting give the plain version's set."""
    rng = np.random.default_rng(seed)
    n, nc = 3000, 700
    e_num, k = (9000, 128) if branch == "buffered" else (600, 64)
    assert (e_num * k > rv._SLOT_BINCOUNT_MAX) == (branch == "buffered")
    lists = [np.concatenate([[0], rng.choice(np.arange(1, e_num),
                                             rng.integers(0, 40), replace=False)])
             for _ in range(n)]
    vxadj = np.concatenate([[0], np.cumsum([len(x) for x in lists])])
    vedges = np.concatenate(lists).astype(np.int64)
    hyper = _Incidence(vxadj, vedges)
    phi = rng.integers(0, 3, (e_num, k)).astype(np.int32)
    phi[0, 0] = 1
    cand = np.sort(rng.choice(n, nc, replace=False))
    part = rng.integers(1, k, n)
    part[cand] = 0
    target = rng.integers(1, k, n)
    pri = np.empty(nc, dtype=np.int32)
    pri[rng.permutation(nc)] = np.arange(nc, 0, -1, dtype=np.int32)
    size = phi.size
    bufs = (np.zeros(size, np.int32) if branch == "buffered" else None,
            np.zeros(size, np.int32) if branch == "buffered" else None,
            np.zeros(size, np.int32), np.zeros(size, bool))
    flat = phi.reshape(-1)
    if branch == "no_phi":
        movers, contended, rounds = rv._select_volume_host(
            hyper, k, part, target, cand, pri,
            slot_phi=lambda s: flat[s].astype(np.int64))
    else:
        movers, contended, rounds = rv._select_volume_host(
            hyper, k, part, target, cand, pri, phi=phi, bufs=bufs)
        for b in bufs:  # left as found: zero
            assert b is None or not b.any()
    _assert_same(_plain(hyper, phi, part, target, cand, pri), movers,
                 contended, rounds)
    assert contended >= nc and rounds >= 2  # a winner, then the excluded
    assert 0 < movers.shape[0] < nc
    assert cand[pri.argmax()] in movers  # the top priority always wins


def _refine_spans(g, part, k, cap, **kw):
    spans.clear()
    with spans.recording():
        got = rv.refine_level_vec(g, part, k, cap, objective="volume",
                                  device="cpu", **kw)
    sel = [s for s in spans.spans() if s.name == SELECT]
    spans.clear()
    return got, sel


@pytest.mark.parametrize("n,k,cap,seed", [(400, 40, 12, 0), (1500, 60, 30, 1),
                                          (1500, 60, 30, 3)])
def test_refine_with_the_plain_device_selection_is_bitwise(n, k, cap, seed):
    """Forced kernel path on the CPU (D* rows and the selection on their
    plain versions): part and score equal the numpy path's and the
    reference's; every selection says which engine ran it."""
    ref, g = pair("fanout_snn_graph", n, seed=seed)
    p0 = greedy_region_growing(g, k, cap, np.random.default_rng(seed))
    (pk, sk), sel_k = _refine_spans(g, p0.copy(), k, cap, use_kernel=True)
    (ph, sh), sel_h = _refine_spans(g, p0.copy(), k, cap, use_kernel=False)
    pr, sr = ref_refine_vec.refine_level_vec(ref, p0.copy(), k, cap,
                                             objective="volume")
    assert_bitwise(pk, pr)
    assert_bitwise(ph, pr)
    assert sk == sh == sr
    assert {s.attrs["engine"] for s in sel_k} == {"kernel"}
    assert {s.attrs["engine"] for s in sel_h} == {"host"}
    assert [s.attrs["winners"] for s in sel_k] == \
        [s.attrs["winners"] for s in sel_h]


@pytest.mark.parametrize("how", ["sharded", "phi_less", "cpu_default"])
def test_host_selection_where_the_device_path_does_not_engage(monkeypatch, how):
    """Sharded levels, levels without a live Φ table and CPU runs left to
    the rule keep the numpy selection, with the reference's result."""
    ref, g = pair("fanout_snn_graph", 400, seed=2)
    k, cap = 40, 12
    p0 = greedy_region_growing(g, k, cap, np.random.default_rng(2))
    kw = {"sharded": dict(use_kernel=True, shards=2),
          "phi_less": dict(use_kernel=True), "cpu_default": {}}[how]
    if how == "phi_less":
        monkeypatch.setattr(rv, "_PHI_MAX_ENTRIES", 0)
        monkeypatch.setattr(ref_refine_vec, "_PHI_MAX_ENTRIES", 0)
    (got, score), sel = _refine_spans(g, p0.copy(), k, cap, **kw)
    want = ref_refine_vec.refine_level_vec(
        ref, p0.copy(), k, cap, objective="volume",
        **({"shards": 2} if how == "sharded" else {}))
    assert_bitwise(got, want[0])
    assert score == want[1]
    assert sel and {s.attrs["engine"] for s in sel} == {"host"}


def test_phi_less_plain_selection_matches_a_recount(monkeypatch):
    """Without a live table the numpy selection counts Φ per slot from the
    partition; the plain version given the recounted table agrees."""
    _, g = pair("fanout_snn_graph", 400, seed=1)
    k, cap = 40, 12
    p0 = greedy_region_growing(g, k, cap, np.random.default_rng(1))
    calls = []
    real = rv._select_volume_host

    def record(hyper, k_, part_, target, cand, pri, phi=None, **kw):
        got = real(hyper, k_, part_, target, cand, pri, phi=phi, **kw)
        calls.append((part_.copy(), target.copy(), cand.copy(), pri.copy(), got))
        return got

    monkeypatch.setattr(rv, "_PHI_MAX_ENTRIES", 0)
    monkeypatch.setattr(rv, "_select_volume_host", record)
    rv.refine_level_vec(g, p0, k, cap, objective="volume", device="cpu")
    assert calls
    for part, target, cand, pri, got in calls:
        phi = edge_partition_counts(g.hyper, part, k)
        _assert_same(_plain(g.hyper, phi, part, target, cand, pri), *got)
