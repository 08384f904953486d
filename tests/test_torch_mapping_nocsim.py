"""The port's mapping and NoC replay against the reference on the CPU, fed
the reference's own traffic, partition and placement."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sa_search as ref_sa_search  # noqa: E402
from repro.core import sneap_partition as ref_sneap_partition  # noqa: E402
from repro.core.hopcost import core_coords, traffic_matrix  # noqa: E402
from repro.core.placecost import PairwiseObjective as RefPairwise  # noqa: E402
from repro.kernels.swap_delta import swap_deltas_pairs as ref_swap_pairs  # noqa: E402
from repro.nocsim import simulate_noc as ref_simulate_noc  # noqa: E402
from repro.snn import make_snn, profile_snn  # noqa: E402

from repro_torch.core import mapping  # noqa: E402
from repro_torch.core.placecost import PairwiseObjective  # noqa: E402
from repro_torch.nocsim import simulate_noc  # noqa: E402

MESH = 5


@pytest.fixture(scope="module")
def ref_run():
    """The reference's smooth_320 profile, a capacity-16 partition (k = 22
    on the 5x5 mesh) and its unicast traffic matrix."""
    prof = profile_snn(make_snn("smooth_320"), num_steps=300, seed=0)
    pres = ref_sneap_partition(prof.graph, capacity=16, seed=1, max_k=MESH * MESH)
    traffic = traffic_matrix(pres.part, prof.trace_src, prof.trace_dst, pres.k)
    return prof, pres, traffic


@pytest.mark.parametrize("impl", ["scalar", "vec"])
def test_sa_search_numpy_scorer_matches_reference(ref_run, impl):
    _, _, traffic = ref_run
    n = int(traffic.sum())
    kw = dict(seed=7, iters=4000, impl=impl, score_backend="numpy")
    want = ref_sa_search(traffic, MESH * MESH, MESH, n, **kw)
    got = mapping.sa_search(traffic, MESH * MESH, MESH, n, device="cpu", **kw)
    np.testing.assert_array_equal(got.placement, want.placement)
    assert got.avg_hop == want.avg_hop
    assert got.evaluations == want.evaluations


def test_kernel_scorer_deltas_match_reference_on_fixed_proposals(ref_run):
    _, _, traffic = ref_run
    cores = MESH * MESH
    rng = np.random.default_rng(3)
    placement = rng.permutation(cores).astype(np.int64)
    obj = PairwiseObjective(traffic, cores, MESH)
    obj.attach(placement)
    scorer = mapping._make_batch_scorer(obj, cores, MESH, "auto",
                                        torch.device("cpu"))
    aa = rng.integers(0, cores, 256)
    bb = (aa + 1 + rng.integers(0, cores - 1, 256)) % cores
    got = scorer(placement, aa, bb)
    ref_obj = RefPairwise(traffic, cores, MESH)
    xy = core_coords(cores, MESH).astype(np.float32)
    want = np.asarray(ref_swap_pairs(
        jnp.asarray(ref_obj.sym, jnp.float32), jnp.asarray(xy[placement, 0]),
        jnp.asarray(xy[placement, 1]), aa, bb, backend="jnp"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    # ... and the f64 host deltas the numpy scorer would have given.
    np.testing.assert_allclose(got, obj.swap_delta_batch(aa, bb), rtol=1e-4,
                               atol=1e-2)


def test_sa_search_refuses_unknown_score_backend(ref_run):
    _, _, traffic = ref_run
    with pytest.raises(ValueError, match="score_backend"):
        mapping.sa_search(traffic, 25, MESH, 1, impl="vec",
                          score_backend="pallas", device="cpu")


@pytest.mark.parametrize("cast", ["unicast", "multicast"])
@pytest.mark.parametrize("screen", ["numpy", "linkload"])
def test_simulate_noc_matches_reference_exactly(ref_run, cast, screen):
    prof, pres, _ = ref_run
    placement = np.random.default_rng(2).permutation(MESH * MESH)[: pres.k]
    args = (prof.trace_t, prof.trace_src, prof.trace_dst, pres.part, placement,
            MESH, MESH)
    want = ref_simulate_noc(*args, cast=cast, link_capacity=2)
    got = simulate_noc(*args, cast=cast, link_capacity=2, screen=screen,
                       device="cpu")
    assert want.congestion_count > 0  # the replay really queued packets
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("cast", ["unicast", "multicast"])
@pytest.mark.parametrize("link_capacity", [1, 3])
def test_linkload_screen_stats_equal_numpy_screen(ref_run, cast, link_capacity):
    """The record-driven link-load screen changes no NoCStats field."""
    prof, pres, _ = ref_run
    placement = np.random.default_rng(5).permutation(MESH * MESH)[: pres.k]
    args = (prof.trace_t, prof.trace_src, prof.trace_dst, pres.part, placement,
            MESH, MESH)
    kw = dict(cast=cast, link_capacity=link_capacity, device="cpu")
    a = simulate_noc(*args, screen="linkload", **kw)
    b = simulate_noc(*args, screen="numpy", **kw)
    assert b.num_noc_spikes > 0
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_unported_replay_options_raise(ref_run):
    prof, pres, _ = ref_run
    args = (prof.trace_t, prof.trace_src, prof.trace_dst, pres.part,
            np.arange(pres.k), MESH, MESH)
    with pytest.raises(ValueError, match="stepper"):
        simulate_noc(*args, stepper="pallas", device="cpu")
    with pytest.raises(ValueError, match="screen"):
        simulate_noc(*args, screen="pallas", device="cpu")
