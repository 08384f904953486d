"""tests/test_hypergraph.py held against the port on the CPU: hypergraph
construction, comm_volume, exact λ-gains, contraction invariance, the
volume refiners (the vec one also on its degree-kernel path, whose plain
version runs on the CPU) and the volume partitioning path — each with the
reference's invariants and bitwise the reference's result on the same
inputs."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from repro.core import initpart as ref_initpart  # noqa: E402
from repro.core import refine as ref_refine  # noqa: E402
from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from repro.core.baselines import greedy_kl_partition as ref_greedy_kl  # noqa: E402
from repro.core.partition import sneap_partition as ref_sneap_partition  # noqa: E402
from torch_parity import assert_bitwise, assert_hyper_equal, assert_levels_equal, mismatched, pair  # noqa: E402

from repro_torch.core.baselines import greedy_kl_partition  # noqa: E402
from repro_torch.core.coarsen import coarsen  # noqa: E402
from repro_torch.core.graph import (  # noqa: E402
    build_graph,
    build_hypergraph,
    comm_volume,
    edge_cut,
    validate_partition,
    volume_degrees,
)
from repro_torch.core.initpart import greedy_region_growing  # noqa: E402
from repro_torch.core.partition import sneap_partition  # noqa: E402
from repro_torch.core.refine import refine_level  # noqa: E402
from repro_torch.core.refine_vec import refine_level_vec  # noqa: E402


def brute_volume(hyper, part):
    vol = 0
    for e in range(hyper.num_hyperedges):
        mem = hyper.members(e)
        vol += int(hyper.hfire[e]) * (len({int(part[v]) for v in mem}) - 1)
    return vol


def _hyper_pair(n, pins, seed):
    """(reference, port) hypergraphs of ``random_snn_traffic``."""
    src, dst, fire = pair("random_snn_traffic", n, pins, seed=seed)[1]
    got = build_hypergraph(n, src, dst, fire)
    want = ref_graph.build_hypergraph(n, src, dst, fire)
    assert_hyper_equal(got, want)
    return want, got


def _same_refine(got, want):
    assert_bitwise(got[0], want[0])
    assert got[1] == want[1]


def test_build_hypergraph_dedups_and_drops_self_pins():
    """Counterpart of test_hypergraph.py::test_build_hypergraph_dedups_and_drops_self_pins."""
    kw = dict(src=[0, 0, 0, 0], dst=[1, 1, 2, 0], fire_counts=np.array([5, 0, 0]))
    hg = build_hypergraph(3, **kw)
    assert hg.num_hyperedges == 1
    assert hg.hsrc.tolist() == [0]
    s, e = hg.hxadj[0], hg.hxadj[1]
    assert sorted(hg.hpins[s:e].tolist()) == [1, 2]
    assert hg.hwgt[s:e].sum() == 15
    assert hg.hfire.tolist() == [5]
    assert_hyper_equal(hg, ref_graph.build_hypergraph(3, **kw))


def test_comm_volume_matches_bruteforce():
    """Counterpart of test_hypergraph.py::test_comm_volume_matches_bruteforce."""
    ref, hg = _hyper_pair(40, 150, seed=1)
    r = np.random.default_rng(2)
    for _ in range(10):
        part = r.integers(0, 5, 40)
        assert comm_volume(hg, part) == brute_volume(hg, part)
        assert comm_volume(hg, part) == ref_graph.comm_volume(ref, part)


def test_comm_volume_equals_cut_on_unicast():
    """Counterpart of test_hypergraph.py::test_comm_volume_equals_cut_on_unicast."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(n=st.integers(5, 50), k=st.integers(2, 5), seed=st.integers(0, 10_000))
    @settings(max_examples=30, deadline=None)
    def check(n, k, seed):
        r = np.random.default_rng(seed)
        src = np.arange(n)
        dst = (src + r.integers(1, n, n)) % n
        fire = r.integers(0, 20, n)
        g = build_graph(n, src, dst, fire[src])
        hg = build_hypergraph(n, src, dst, fire)
        part = r.integers(0, k, n)
        assert comm_volume(hg, part) == edge_cut(g, part)
        assert comm_volume(hg, part) == ref_graph.comm_volume(
            ref_graph.build_hypergraph(n, src, dst, fire), part)

    check()


def test_volume_degrees_gains_exact():
    """Counterpart of test_hypergraph.py::test_volume_degrees_gains_exact."""
    ref, hg = _hyper_pair(35, 140, seed=3)
    r = np.random.default_rng(4)
    k = 4
    for _ in range(5):
        part = r.integers(0, k, 35)
        D = volume_degrees(hg, part, k)
        assert_bitwise(D, ref_graph.volume_degrees(ref, part, k))
        base = brute_volume(hg, part)
        for v in r.integers(0, 35, 8):
            a = part[v]
            for b in range(k):
                moved = part.copy()
                moved[v] = b
                assert D[v, b] - D[v, a] == base - brute_volume(hg, moved)


def test_volume_degrees_row_subset_matches_full():
    """Counterpart of test_hypergraph.py::test_volume_degrees_row_subset_matches_full."""
    ref, hg = _hyper_pair(50, 200, seed=5)
    part = np.random.default_rng(6).integers(0, 6, 50)
    full = volume_degrees(hg, part, 6)
    rows = np.array([0, 7, 13, 49])
    sub = volume_degrees(hg, part, 6, rows=rows)
    np.testing.assert_array_equal(sub, full[rows])
    np.testing.assert_array_equal(
        sub, ref_graph.volume_degrees(ref, part, 6, rows=rows))


def test_comm_volume_invariant_under_contraction():
    """Counterpart of test_hypergraph.py::test_comm_volume_invariant_under_contraction."""
    ref, g = pair("random_hypergraph", 300, 1500, seed=7)
    rng = np.random.default_rng(8)
    levels = coarsen(g, rng, coarsen_to=32, impl="vec")
    assert_levels_equal(levels, ref_coarsen.coarsen(
        ref, np.random.default_rng(8), coarsen_to=32, impl="vec"))
    assert len(levels) > 2
    part = rng.integers(0, 4, levels[-1].num_vertices)
    vols = []
    for coarse in reversed(levels):
        vols.append(comm_volume(coarse.hyper, part))
        if coarse.cmap is not None:
            part = part[coarse.cmap]
    assert len(set(vols)) == 1


def test_contraction_drops_internalized_pins():
    """Counterpart of test_hypergraph.py::test_contraction_drops_internalized_pins."""
    ref, g = pair("random_hypergraph", 200, 900, seed=9)
    levels = coarsen(g, np.random.default_rng(10), coarsen_to=32)
    assert_levels_equal(levels, ref_coarsen.coarsen(
        ref, np.random.default_rng(10), coarsen_to=32))
    assert levels[-1].hyper.num_pins < levels[0].hyper.num_pins


def test_contraction_conserves_delivered_spike_ledger():
    """Counterpart of test_hypergraph.py::test_contraction_conserves_delivered_spike_ledger."""
    ref, g = pair("random_hypergraph", 200, 900, seed=13)
    levels = coarsen(g, np.random.default_rng(14), coarsen_to=32)
    assert_levels_equal(levels, ref_coarsen.coarsen(
        ref, np.random.default_rng(14), coarsen_to=32))
    for fine, coarse in zip(levels[:-1], levels[1:]):
        fh, ch, cmap = fine.hyper, coarse.hyper, coarse.cmap
        src_of_pin = fh.hsrc[fh.pin_edge].astype(np.int64)
        internal = cmap[fh.hpins.astype(np.int64)] == cmap[src_of_pin]
        assert int(ch.hwgt.sum()) == int(fh.hwgt[~internal].sum())


def _refine_case(seed, n=120, m=600, k=6, cap=30):
    ref, g = pair("random_hypergraph", n, m, seed=seed, max_fire=9)
    part = greedy_region_growing(g, k, cap, np.random.default_rng(seed))
    want = ref_initpart.greedy_region_growing(ref, k, cap,
                                              np.random.default_rng(seed))
    np.testing.assert_array_equal(part, want)
    return ref, g, part, k, cap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_level_volume_exact_and_monotone(seed):
    """Counterpart of test_hypergraph.py::test_refine_level_volume_exact_and_monotone."""
    ref, g, part, k, cap = _refine_case(seed)
    v0 = comm_volume(g.hyper, part)
    refined, vol = refine_level(g, part.copy(), k, cap, objective="volume")
    _same_refine((refined, vol), ref_refine.refine_level(
        ref, part.copy(), k, cap, objective="volume"))
    assert vol == comm_volume(g.hyper, refined)
    assert vol <= v0
    validate_partition(g, refined, k, cap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_level_vec_volume_exact_and_monotone(seed):
    """Counterpart of test_hypergraph.py::test_refine_level_vec_volume_exact_and_monotone."""
    ref, g, part, k, cap = _refine_case(seed, n=400, m=2000, k=40, cap=12)
    v0 = comm_volume(g.hyper, part)
    refined, vol = refine_level_vec(g, part.copy(), k, cap, objective="volume",
                                    device="cpu")
    _same_refine((refined, vol), ref_refine_vec.refine_level_vec(
        ref, part.copy(), k, cap, objective="volume"))
    assert vol == comm_volume(g.hyper, refined)
    assert vol <= v0
    validate_partition(g, refined, k, cap)


def test_refine_level_vec_volume_kernel_interpret_parity():
    """Counterpart of test_hypergraph.py::test_refine_level_vec_volume_kernel_interpret_parity:
    the port's degree-kernel path on a CPU tensor (the kernel's plain
    version) against its numpy path and, bitwise, the reference's
    interpret-mode kernel path."""
    ref, g, part, k, cap = _refine_case(3, n=200, m=1000, k=66, cap=5)
    pk, vk = refine_level_vec(g, part.copy(), k, cap, objective="volume",
                              use_kernel=True, device="cpu")
    pn, vn = refine_level_vec(g, part.copy(), k, cap, objective="volume",
                              use_kernel=False, device="cpu")
    assert vk == comm_volume(g.hyper, pk)
    np.testing.assert_array_equal(pk, pn)
    assert vk == vn
    _same_refine((pk, vk), ref_refine_vec.refine_level_vec(
        ref, part.copy(), k, cap, objective="volume", use_kernel=True,
        kernel_backend="interpret"))


def test_refine_rejects_volume_without_hyper():
    """Counterpart of test_hypergraph.py::test_refine_rejects_volume_without_hyper."""
    g = build_graph(10, [0, 1], [1, 2], [3, 3])
    with pytest.raises(ValueError):
        refine_level(g, np.zeros(10, dtype=np.int64), 2, 10, objective="volume")
    with pytest.raises(ValueError):
        refine_level_vec(g, np.zeros(10, dtype=np.int64), 2, 10,
                         objective="volume", device="cpu")


@pytest.mark.parametrize("impl", ["scalar", "vec"])
def test_sneap_partition_volume_objective(impl):
    """Counterpart of test_hypergraph.py::test_sneap_partition_volume_objective."""
    ref, g = pair("random_hypergraph", 600, 4000, seed=11, max_fire=9)
    res = {}
    for objective in ("cut", "volume"):
        kw = dict(capacity=48, seed=0, impl=impl, objective=objective)
        res[objective] = sneap_partition(g, device="cpu", **kw)
        assert mismatched(res[objective], ref_sneap_partition(ref, **kw)) == []
    cut_res, vol_res = res["cut"], res["volume"]
    assert cut_res.objective == "cut" and vol_res.objective == "volume"
    assert vol_res.comm_volume == comm_volume(g.hyper, vol_res.part)
    assert cut_res.comm_volume == comm_volume(g.hyper, cut_res.part)
    assert vol_res.comm_volume <= cut_res.comm_volume
    validate_partition(g, vol_res.part, vol_res.k, 48)


def test_sneap_partition_volume_requires_hyper():
    """Counterpart of test_hypergraph.py::test_sneap_partition_volume_requires_hyper."""
    g = build_graph(50, np.arange(49), np.arange(1, 50), np.ones(49))
    with pytest.raises(ValueError):
        sneap_partition(g, capacity=10, objective="volume", device="cpu")


def test_greedy_kl_volume_objective():
    """Counterpart of test_hypergraph.py::test_greedy_kl_volume_objective."""
    ref, g = pair("random_hypergraph", 150, 800, seed=12, max_fire=9)
    res = greedy_kl_partition(g, capacity=30, seed=0, objective="volume")
    want = ref_greedy_kl(ref, capacity=30, seed=0, objective="volume")
    assert mismatched(res, want) == []
    assert res.comm_volume == comm_volume(g.hyper, res.part)
    validate_partition(g, res.part, res.k, 30)
