"""The port's partitioning phase against the reference on the CPU, fed the
reference's own profile: the kernel paths of the vec refiner (here the
degree kernels' plain PyTorch versions, cut and volume) and both engines
must reproduce the reference's partitions bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import initpart as ref_initpart  # noqa: E402
from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from repro.core.graph import build_hypergraph as ref_build_hypergraph  # noqa: E402
from repro.core.graph import comm_volume as ref_comm_volume  # noqa: E402
from repro.core.graph import volume_degrees as ref_volume_degrees  # noqa: E402
from repro.core.partition import sneap_partition as ref_sneap_partition  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402
from conftest import random_hypergraph  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import refine_vec  # noqa: E402
from repro_torch.core.graph import comm_volume, edge_cut  # noqa: E402
from repro_torch.core.graph import edge_partition_counts  # noqa: E402
from repro_torch.core.refine import VolumeState  # noqa: E402
from repro_torch.core.partition import sneap_partition  # noqa: E402

CAPACITY = 16  # smooth_1280 at capacity 16: k = 88 >= the kernel's 64


@pytest.fixture(scope="module")
def ref_profile():
    return profile_snn(make_snn("smooth_1280"), num_steps=200, seed=0)


def _levels(g, contract_hyper):
    """The reference's coarsening levels and initial partition (vec)."""
    k = int(np.ceil(np.ceil(g.total_vwgt / CAPACITY) * 1.10))
    rng = np.random.default_rng(5)
    levels = ref_coarsen.coarsen(g, rng, coarsen_to=4 * k,
                                 max_vwgt=CAPACITY // 3, impl="vec",
                                 contract_hyper=contract_hyper)
    coarse = ref_initpart.greedy_region_growing(levels[-1], k, CAPACITY, rng,
                                                impl="auto")
    return levels, coarse, k


@pytest.fixture(scope="module")
def ref_levels(ref_profile):
    return _levels(ref_profile.graph, contract_hyper=False)


@pytest.fixture(scope="module")
def ref_volume_levels(ref_profile):
    """Levels that carry the contracted hypergraph, as objective='volume'
    coarsens."""
    return _levels(ref_profile.graph, contract_hyper=True)


def _hyper_case():
    """tests/test_hypergraph.py's kernel-parity case: n=200, k=66, cap 5."""
    g = random_hypergraph(200, 1000, seed=3, max_fire=9)
    part = ref_initpart.greedy_region_growing(g, 66, 5,
                                              np.random.default_rng(3))
    return g, part, 66, 5


def test_refine_level_kernel_path_matches_reference(ref_profile):
    g = ref_profile.graph
    k, cap = 88, 20
    base = ref_sneap_partition(g, capacity=CAPACITY, seed=3, impl="vec")
    rng = np.random.default_rng(0)
    part = base.part.copy()
    idx = rng.choice(g.num_vertices, 200, replace=False)
    part[idx] = rng.integers(0, k, 200)
    want_np = ref_refine_vec.refine_level_vec(g, part, k, cap, use_kernel=False)
    want_kernel = ref_refine_vec.refine_level_vec(
        g, part, k, cap, use_kernel=True, kernel_backend="interpret")
    got = refine_vec.refine_level_vec(interop.graph_from(g), part, k, cap,
                                      use_kernel=True, device="cpu")
    for want in (want_np, want_kernel):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert comm_volume(interop.hypergraph_from(g.hyper), got[0]) == \
        ref_comm_volume(g.hyper, want_np[0])


def test_uncoarsen_kernel_path_matches_reference(ref_levels):
    levels, coarse, k = ref_levels
    want = ref_refine_vec.uncoarsen_vec(levels, coarse, k, CAPACITY,
                                        use_kernel=False)
    port_levels = [interop.graph_from(g) for g in levels]
    got = refine_vec.uncoarsen_vec(port_levels, coarse, k, CAPACITY,
                                   use_kernel=True, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == edge_cut(port_levels[0], got[0])


@pytest.mark.parametrize("impl", ["scalar", "vec"])
@pytest.mark.parametrize("objective", ["cut", "volume"])
def test_sneap_partition_matches_reference(ref_profile, impl, objective):
    want = ref_sneap_partition(ref_profile.graph, capacity=CAPACITY, seed=3,
                               impl=impl, objective=objective)
    got = sneap_partition(interop.graph_from(ref_profile.graph),
                          capacity=CAPACITY, seed=3, impl=impl,
                          objective=objective, device="cpu")
    np.testing.assert_array_equal(got.part, want.part)
    assert (got.k, got.edge_cut, got.comm_volume, got.num_levels) == (
        want.k, want.edge_cut, want.comm_volume, want.num_levels)


def test_kernel_auto_rule_keys_on_the_card(ref_profile, monkeypatch):
    """use_kernel=None takes the kernel path only on CUDA, for cut levels
    that pass the reference's three gates; the CPU keeps numpy."""
    g = interop.graph_from(ref_profile.graph)
    calls = []
    real = refine_vec._degrees_via_kernel
    monkeypatch.setattr(refine_vec, "_degrees_via_kernel",
                        lambda *a: calls.append(1) or real(*a))
    part = sneap_partition(g, capacity=CAPACITY, seed=3, impl="vec",
                           device="cpu").part
    refine_vec.refine_level_vec(g, part, 88, CAPACITY, device="cpu")
    assert calls == []
    refine_vec.refine_level_vec(g, part, 88, CAPACITY, use_kernel=True,
                                device="cpu")
    assert calls


# ------------------------------------------------ volume objective kernel


def test_volume_degrees_via_kernel_matches_reference():
    """tests/test_kernels.py's exactness case: the volume kernel path (the
    incidence CSR and Φ resident, or Φ recounted per call) reproduces
    graph.volume_degrees bit for bit, all rows and a subset."""
    r = np.random.default_rng(7)
    n, k = 120, 66
    src, dst = r.integers(0, n, 500), r.integers(0, n, 500)
    hg = ref_build_hypergraph(n, src, dst, r.integers(1, 9, n))
    part = r.integers(0, k, n).astype(np.int64)
    rows = np.arange(n, dtype=np.int64)
    want = ref_volume_degrees(hg, part, k)
    np.testing.assert_array_equal(
        ref_refine_vec._volume_degrees_via_kernel(
            ref_refine_vec._dense_incidence(hg), hg, part, k, rows, "interpret"),
        want)
    hyper = interop.hypergraph_from(hg)
    from repro_torch.core.graph import edge_partition_counts
    phi = edge_partition_counts(hyper, part, k)
    cpu = torch.device("cpu")
    kstate = refine_vec._VolumeKernelState(hyper, phi, cpu)
    got = refine_vec._volume_degrees_via_kernel(kstate, part, rows)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    sub = r.permutation(n)[:37]
    np.testing.assert_array_equal(
        refine_vec._volume_degrees_via_kernel(
            refine_vec._VolumeKernelState(hyper, None, cpu), part, sub, phi=phi),
        want[sub])


def _port_hyper_case(seed: int):
    """A random SNN graph with its hypergraph (port types), a random
    partition into k = 70 parts and the rng that made them."""
    r = np.random.default_rng(seed)
    g = interop.graph_from(random_hypergraph(150, 900, seed=seed, max_fire=9))
    return g, r.integers(0, 70, g.num_vertices).astype(np.int64), 70, r


@pytest.mark.parametrize("seed", [0, 1])
def test_volume_kernel_csr_lists_the_dense_incidence(seed):
    """The CSR the volume kernel path takes from VolumeState lists exactly
    the non-zeros of _dense_incidence, once each, with the same weights
    (plus the memberships of hyperedges whose source never fired, with
    weight 0, which add nothing)."""
    g, part, k, _ = _port_hyper_case(seed)
    vstate = VolumeState(g, part, k)
    kstate = refine_vec._VolumeKernelState(vstate.hyper, vstate.phi,
                                           torch.device("cpu"))
    vxadj, vedges, w = (kstate.vxadj.numpy(), kstate.vedges.numpy(),
                        kstate.w.numpy())
    np.testing.assert_array_equal(vxadj, vstate.vxadj)
    np.testing.assert_array_equal(vedges, vstate.vedges)
    dense = refine_vec._dense_incidence(g.hyper)
    verts = np.repeat(np.arange(g.num_vertices), np.diff(vxadj))
    assert len(set(zip(verts.tolist(), vedges.tolist()))) == vedges.shape[0]
    assert np.count_nonzero(w) == np.count_nonzero(dense)
    assert (g.hyper.hfire[vedges[w == 0]] == 0).all()
    rebuilt = np.zeros_like(dense)
    rebuilt[verts, vedges] = w
    np.testing.assert_array_equal(rebuilt, dense)
    np.testing.assert_array_equal(kstate.phi.numpy(), vstate.phi)


def test_volume_kernel_phi_mirror_follows_apply_moves():
    """Batches whose movers share hyperedges (several movers on one slot,
    merged into counts above 1) keep the kernel path's Φ equal to
    VolumeState's after every batch."""
    g, part, k, r = _port_hyper_case(3)
    hyper = g.hyper
    vstate = VolumeState(g, part, k)
    kstate = refine_vec._VolumeKernelState(hyper, vstate.phi,
                                           torch.device("cpu"))
    for _ in range(6):
        e = int(r.integers(0, hyper.num_hyperedges))
        members = np.unique(hyper.members(e).astype(np.int64))
        extra = r.choice(g.num_vertices, 5, replace=False)
        movers = np.unique(np.concatenate([members, extra]))
        prev = part[movers].copy()
        # One destination for the whole batch: the edge's members all
        # enter the slot (e, d), so merged counts exceed 1.
        d = int(r.choice(np.setdiff1d(np.arange(k), prev)))
        dest = np.full_like(prev, d)
        part[movers] = dest
        keys, deltas = vstate.apply_moves(movers, prev, dest)
        assert deltas.max() > 1
        kstate.apply(keys, deltas)
        np.testing.assert_array_equal(kstate.phi.numpy(), vstate.phi)
    np.testing.assert_array_equal(vstate.phi, edge_partition_counts(hyper, part, k))


@pytest.mark.parametrize("case", ["smooth_1280", "hypergraph"])
def test_refine_level_volume_kernel_path_matches_reference(ref_profile, case):
    if case == "smooth_1280":
        g = ref_profile.graph
        k, cap = 88, CAPACITY
        part = ref_sneap_partition(g, capacity=cap, seed=3, impl="vec").part
        rng = np.random.default_rng(1)
        idx = rng.choice(g.num_vertices, 200, replace=False)
        part = part.copy()
        part[idx] = part[rng.permutation(idx)]  # keeps every weight in cap
    else:
        g, part, k, cap = _hyper_case()
    want_np = ref_refine_vec.refine_level_vec(g, part.copy(), k, cap,
                                              objective="volume",
                                              use_kernel=False)
    want_kernel = ref_refine_vec.refine_level_vec(
        g, part.copy(), k, cap, objective="volume", use_kernel=True,
        kernel_backend="interpret")
    got = refine_vec.refine_level_vec(interop.graph_from(g), part.copy(), k,
                                      cap, objective="volume", use_kernel=True,
                                      device="cpu")
    for want in (want_np, want_kernel):
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert got[1] == ref_comm_volume(g.hyper, got[0]) < ref_comm_volume(g.hyper, part)


def test_uncoarsen_volume_kernel_path_matches_reference(ref_volume_levels):
    levels, coarse, k = ref_volume_levels
    want = ref_refine_vec.uncoarsen_vec(levels, coarse, k, CAPACITY,
                                        use_kernel=False, objective="volume")
    port_levels = [interop.graph_from(g) for g in levels]
    got = refine_vec.uncoarsen_vec(port_levels, coarse, k, CAPACITY,
                                   use_kernel=True, objective="volume",
                                   device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == comm_volume(port_levels[0].hyper, got[0])


def test_volume_kernel_auto_rule_keys_on_the_card_and_gates(
        ref_profile, ref_volume_levels, monkeypatch):
    """use_kernel=None takes the volume kernel path only on CUDA and only
    within the reference's gates (n, E <= _KERNEL_MAX_N, k >= _KERNEL_MIN_K,
    2 * sum(hfire) < 2^24); the CPU keeps numpy."""
    g = interop.graph_from(ref_profile.graph)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert refine_vec._kernel_auto(g, 88, "volume", cuda)
    assert not refine_vec._kernel_auto(g, 88, "volume", cpu)
    assert not refine_vec._kernel_auto(g, refine_vec._KERNEL_MIN_K - 1,
                                       "volume", cuda)
    # The coarsest level has more hyperedges than vertices (322 < 639):
    # with the dense gate between the two, volume refuses while cut, which
    # densifies only the adjacency, still takes its kernel.
    coarse = interop.graph_from(ref_volume_levels[0][-1])
    n, ne = coarse.num_vertices, coarse.hyper.num_hyperedges
    assert n < ne
    monkeypatch.setattr(refine_vec, "_KERNEL_MAX_N", n)
    assert not refine_vec._kernel_auto(coarse, 88, "volume", cuda)
    assert refine_vec._kernel_auto(coarse, 88, "cut", cuda)
    monkeypatch.setattr(refine_vec, "_KERNEL_MAX_N", ne)
    assert refine_vec._kernel_auto(coarse, 88, "volume", cuda)
    monkeypatch.undo()
    # 2 * sum(hfire) at 2^24 or above: f32 sums are no longer exact.
    hot = interop.graph_from(ref_profile.graph)
    hot.hyper.hfire = np.full_like(hot.hyper.hfire, (1 << 23) // len(hot.hyper.hfire) + 1)
    assert not refine_vec._kernel_auto(hot, 88, "volume", cuda)

    calls = []
    real = refine_vec._volume_degrees_via_kernel
    monkeypatch.setattr(refine_vec, "_volume_degrees_via_kernel",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    part = sneap_partition(g, capacity=CAPACITY, seed=3, impl="vec",
                           device="cpu").part
    refine_vec.refine_level_vec(g, part, 88, CAPACITY, objective="volume",
                                device="cpu")
    assert calls == []
    refine_vec.refine_level_vec(g, part, 88, CAPACITY, objective="volume",
                                use_kernel=True, device="cpu")
    assert calls
