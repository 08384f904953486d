"""tests/test_volume_engines.py held against the port on the CPU: scalar
FM vs the vec engine's incremental-Φ + plateau-walk volume refinement,
the walk's strict improvement and no-regression, volume levels never
delegated to the scalar refiner, and the vec coarsening round count on
layered graphs — each refinement and hierarchy bitwise the reference's on
the same inputs."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import initpart as ref_initpart  # noqa: E402
from repro.core import refine as ref_refine  # noqa: E402
from repro.core import refine_vec as ref_refine_vec  # noqa: E402
from torch_parity import assert_levels_equal, pair  # noqa: E402

from repro_torch.core import refine_vec as rv  # noqa: E402
from repro_torch.core.coarsen import coarsen  # noqa: E402
from repro_torch.core.graph import comm_volume, validate_partition  # noqa: E402
from repro_torch.core.initpart import greedy_region_growing  # noqa: E402
from repro_torch.core.refine import refine_level  # noqa: E402
from repro_torch.core.refine_vec import refine_level_vec, uncoarsen_vec  # noqa: E402

SWEEP = [
    (400, 40, 12, 0),
    (400, 40, 12, 1),
    (400, 40, 12, 2),
    (400, 40, 12, 3),
    (1500, 60, 30, 0),
    (1500, 60, 30, 3),
]


def _start(n, k, cap, seed):
    """(reference graph, port graph, region-grown partition), the
    partition bitwise the reference's."""
    ref, g = pair("fanout_snn_graph", n, seed=seed)
    p0 = greedy_region_growing(g, k, cap, np.random.default_rng(seed))
    np.testing.assert_array_equal(p0, ref_initpart.greedy_region_growing(
        ref, k, cap, np.random.default_rng(seed)))
    return ref, g, p0


def _vec(ref, g, p0, k, cap, **kw):
    """The port's volume refine_level_vec, bitwise the reference's."""
    got = refine_level_vec(g, p0.copy(), k, cap, objective="volume",
                           device="cpu", **kw)
    want = ref_refine_vec.refine_level_vec(ref, p0.copy(), k, cap,
                                           objective="volume", **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    return got


@pytest.mark.parametrize("n,k,cap,seed", SWEEP)
def test_cross_engine_volume_within_5pct(n, k, cap, seed):
    """Counterpart of test_volume_engines.py::test_cross_engine_volume_within_5pct."""
    ref, g, p0 = _start(n, k, cap, seed)
    ps, vs = refine_level(g, p0.copy(), k, cap, objective="volume")
    want_s = ref_refine.refine_level(ref, p0.copy(), k, cap, objective="volume")
    np.testing.assert_array_equal(ps, want_s[0])
    assert vs == want_s[1]
    pv, vv = _vec(ref, g, p0, k, cap)
    assert vs == comm_volume(g.hyper, ps)
    assert vv == comm_volume(g.hyper, pv)
    validate_partition(g, pv, k, cap)
    assert vv <= 1.05 * vs, f"vec {vv} vs scalar {vs} ({vv / vs:.3f}x)"
    assert vv <= comm_volume(g.hyper, p0)


def test_plateau_walk_strictly_improves():
    """Counterpart of test_volume_engines.py::test_plateau_walk_strictly_improves."""
    k, cap = 40, 12
    ref, g, p0 = _start(400, k, cap, 0)
    _, v_nowalk = _vec(ref, g, p0, k, cap, plateau_rounds=0)
    stats: dict = {}
    pw, v_walk = refine_level_vec(g, p0.copy(), k, cap, objective="volume",
                                  stats=stats, device="cpu")
    want_stats: dict = {}
    want = ref_refine_vec.refine_level_vec(ref, p0.copy(), k, cap,
                                           objective="volume", stats=want_stats)
    np.testing.assert_array_equal(pw, want[0])
    assert v_walk == want[1] and stats == want_stats
    assert v_walk == comm_volume(g.hyper, pw)
    assert stats["escapes"] > 0
    assert v_walk < v_nowalk, (v_walk, v_nowalk)


def test_plateau_walk_never_regresses():
    """Counterpart of test_volume_engines.py::test_plateau_walk_never_regresses."""
    for seed in range(3):
        k, cap = 25, 12
        ref, g, p0 = _start(250, k, cap, seed)
        _, v_off = _vec(ref, g, p0, k, cap, plateau_rounds=0)
        _, v_on = _vec(ref, g, p0, k, cap)
        assert v_on <= v_off


def test_uncoarsen_vec_volume_never_delegates_to_scalar(monkeypatch):
    """Counterpart of test_volume_engines.py::test_uncoarsen_vec_volume_never_delegates_to_scalar
    (the port's own scalar refiner is the one patched to raise)."""
    ref, g = pair("fanout_snn_graph", 300, seed=1)
    k, cap = 12, 32
    rng = np.random.default_rng(1)
    levels = coarsen(g, rng, coarsen_to=4 * k, max_vwgt=cap // 3, impl="vec")
    coarse_part = greedy_region_growing(levels[-1], k, cap, rng)
    ref_rng = np.random.default_rng(1)
    ref_levels = ref_coarsen.coarsen(ref, ref_rng, coarsen_to=4 * k,
                                     max_vwgt=cap // 3, impl="vec")
    assert_levels_equal(levels, ref_levels)
    ref_coarse = ref_initpart.greedy_region_growing(ref_levels[-1], k, cap, ref_rng)
    want = ref_refine_vec.uncoarsen_vec(ref_levels, ref_coarse, k, cap,
                                        objective="volume")

    def boom(*a, **kw):
        raise AssertionError("volume level delegated to scalar refine_level")

    monkeypatch.setattr(rv, "refine_level", boom)
    part, vol = uncoarsen_vec(levels, coarse_part, k, cap, objective="volume",
                              device="cpu")
    np.testing.assert_array_equal(part, want[0])
    assert vol == want[1]
    assert vol == comm_volume(g.hyper, part)
    with pytest.raises(AssertionError, match="delegated"):
        uncoarsen_vec(levels, coarse_part, k, cap, objective="cut", device="cpu")


def test_vec_coarsening_rounds_on_layered_graph():
    """Counterpart of test_volume_engines.py::test_vec_coarsening_rounds_on_layered_graph."""
    ref, g = pair("layered_snn_graph", (512, 512, 512, 512), seed=0)
    assert g.num_vertices == 2048
    levels = {}
    for impl in ("scalar", "vec"):
        kw = dict(coarsen_to=128, max_vwgt=85, impl=impl, contract_hyper=False)
        levels[impl] = coarsen(g, np.random.default_rng(0), **kw)
        assert_levels_equal(levels[impl], ref_coarsen.coarsen(
            ref, np.random.default_rng(0), **kw))
    scalar_levels, vec_levels = levels["scalar"], levels["vec"]
    scalar_rounds = len(scalar_levels) - 1
    vec_rounds = len(vec_levels) - 1
    assert vec_levels[-1].num_vertices <= 2 * scalar_levels[-1].num_vertices
    assert vec_rounds <= 2 * scalar_rounds, (vec_rounds, scalar_rounds)
