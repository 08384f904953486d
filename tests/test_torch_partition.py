"""The port's partitioning phase against the reference on the CPU, fed the
reference's own profile: the kernel path of the vec refiner (here the
degree kernel's plain PyTorch version) and both engines must reproduce the
reference's partitions bitwise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import initpart as ref_initpart  # noqa: E402
from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from repro.core.graph import comm_volume as ref_comm_volume  # noqa: E402
from repro.core.partition import sneap_partition as ref_sneap_partition  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import refine_vec  # noqa: E402
from repro_torch.core.graph import comm_volume, edge_cut  # noqa: E402
from repro_torch.core.partition import sneap_partition  # noqa: E402

CAPACITY = 16  # smooth_1280 at capacity 16: k = 88 >= the kernel's 64


@pytest.fixture(scope="module")
def ref_profile():
    return profile_snn(make_snn("smooth_1280"), num_steps=200, seed=0)


@pytest.fixture(scope="module")
def ref_levels(ref_profile):
    """The reference's coarsening levels and initial partition (vec)."""
    g = ref_profile.graph
    k = int(np.ceil(np.ceil(g.total_vwgt / CAPACITY) * 1.10))
    rng = np.random.default_rng(5)
    levels = ref_coarsen.coarsen(g, rng, coarsen_to=4 * k,
                                 max_vwgt=CAPACITY // 3, impl="vec",
                                 contract_hyper=False)
    coarse = ref_initpart.greedy_region_growing(levels[-1], k, CAPACITY, rng,
                                                impl="auto")
    return levels, coarse, k


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


def test_unported_partition_features_raise(ref_profile):
    g = interop.graph_from(ref_profile.graph)
    with pytest.raises(NotImplementedError, match="shards"):
        sneap_partition(g, capacity=CAPACITY, impl="vec", shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="connectivity"):
        refine_vec.refine_level_vec(g, np.zeros(g.num_vertices, np.int64), 88,
                                    CAPACITY, use_kernel=True,
                                    objective="volume", device="cpu")


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
