"""tests/test_hypergraph_property.py held against the port on the CPU (with
the reference's hypothesis settings): hyperedge dedup and pin-set
contraction preserve comm_volume and the λ-gain matrix, and the port's
deduped and contracted hypergraphs and coarsening levels are bitwise the
reference's on the same inputs."""
import numpy as np
import pytest

pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import coarsen as ref_coarsen  # noqa: E402
from repro.core import graph as ref_graph  # noqa: E402
from torch_parity import assert_hyper_equal, assert_levels_equal, pair  # noqa: E402

from repro_torch.core.coarsen import coarsen, contract_hypergraph  # noqa: E402
from repro_torch.core.graph import (  # noqa: E402
    Hypergraph,
    comm_volume,
    dedup_hyperedges,
    volume_degrees,
)


def stack_duplicates(h, copies: int, seed: int, cls=Hypergraph):
    """The reference suite's duplicate factory, building a ``cls``."""
    r = np.random.default_rng(seed)
    scale = r.integers(1, 4, copies * h.num_hyperedges)
    d = np.diff(h.hxadj)
    hxadj = np.concatenate([[0], np.cumsum(np.tile(d, copies))])
    pin_scale = np.repeat(scale, np.tile(d, copies))
    return cls(
        hxadj=hxadj.astype(np.int64),
        hpins=np.tile(h.hpins, copies),
        hwgt=np.tile(h.hwgt, copies) * pin_scale,
        hsrc=np.tile(h.hsrc, copies),
        hfire=np.tile(h.hfire, copies) * scale,
        num_vertices=h.num_vertices,
    )


@given(n=st.integers(10, 60), pins=st.integers(20, 200),
       copies=st.integers(2, 4), k=st.integers(2, 6),
       seed=st.integers(0, 10_000))
@settings(max_examples=30, deadline=None)
def test_dedup_preserves_volume_and_gains(n, pins, copies, k, seed):
    """Counterpart of test_hypergraph_property.py::test_dedup_preserves_volume_and_gains."""
    ref_g, g = pair("random_hypergraph", n, pins, seed=seed)
    base = g.hyper
    stacked = stack_duplicates(base, copies, seed)
    deduped = dedup_hyperedges(stacked)
    assert_hyper_equal(deduped, ref_graph.dedup_hyperedges(
        stack_duplicates(ref_g.hyper, copies, seed, ref_graph.Hypergraph)))
    deduped.validate(check_dedup=True)
    assert deduped.num_hyperedges == base.num_hyperedges
    assert int(deduped.hfire.sum()) == int(stacked.hfire.sum())
    assert int(deduped.hwgt.sum()) == int(stacked.hwgt.sum())
    r = np.random.default_rng(seed + 1)
    for _ in range(3):
        part = r.integers(0, k, n)
        assert comm_volume(stacked, part) == comm_volume(deduped, part)
        np.testing.assert_array_equal(volume_degrees(stacked, part, k),
                                      volume_degrees(deduped, part, k))


@given(n=st.integers(10, 80), pins=st.integers(20, 300),
       nc=st.integers(2, 20), k=st.integers(2, 6),
       seed=st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_contraction_through_random_cmap_preserves_volume(n, pins, nc, k, seed):
    """Counterpart of test_hypergraph_property.py::test_contraction_through_random_cmap_preserves_volume."""
    ref_g, g = pair("random_hypergraph", n, pins, seed=seed)
    r = np.random.default_rng(seed + 1)
    cmap = r.integers(0, nc, n)
    coarse = contract_hypergraph(g.hyper, cmap, nc)
    assert_hyper_equal(coarse, ref_coarsen.contract_hypergraph(ref_g.hyper, cmap, nc))
    coarse.validate(check_dedup=True)
    for _ in range(3):
        part_c = r.integers(0, k, nc)
        assert comm_volume(coarse, part_c) == comm_volume(g.hyper, part_c[cmap])


@given(seed=st.integers(0, 1000), k=st.integers(2, 8))
@settings(max_examples=8, deadline=None)
def test_dedup_invariant_at_every_coarsening_level(seed, k):
    """Counterpart of test_hypergraph_property.py::test_dedup_invariant_at_every_coarsening_level."""
    ref_g, g = pair("random_hypergraph", 250, 1200, seed=seed)
    rng = np.random.default_rng(seed)
    levels = coarsen(g, rng, coarsen_to=24, impl="vec")
    assert_levels_equal(levels, ref_coarsen.coarsen(
        ref_g, np.random.default_rng(seed), coarsen_to=24, impl="vec"))
    part = rng.integers(0, k, levels[-1].num_vertices)
    vols = []
    for coarse in reversed(levels):
        coarse.hyper.validate(check_dedup=True)
        assert dedup_hyperedges(coarse.hyper).num_hyperedges == \
            coarse.hyper.num_hyperedges
        vols.append(comm_volume(coarse.hyper, part))
        if coarse.cmap is not None:
            part = part[coarse.cmap]
    assert len(set(vols)) == 1


def test_layered_coarsening_dedups_heavily():
    """Counterpart of test_hypergraph_property.py::test_layered_coarsening_dedups_heavily."""
    ref_g, g = pair("layered_snn_graph", (128, 128, 128, 128), seed=0)
    rng = np.random.default_rng(0)
    levels = coarsen(g, rng, coarsen_to=24, impl="vec")
    assert_levels_equal(levels, ref_coarsen.coarsen(
        ref_g, np.random.default_rng(0), coarsen_to=24, impl="vec"))
    assert len(levels) > 2
    fine_e = levels[0].hyper.num_hyperedges
    coarse_e = levels[-1].hyper.num_hyperedges
    assert coarse_e < fine_e // 2, (fine_e, coarse_e)
    part = rng.integers(0, 4, levels[-1].num_vertices)
    vols = []
    for coarse in reversed(levels):
        vols.append(comm_volume(coarse.hyper, part))
        if coarse.cmap is not None:
            part = part[coarse.cmap]
    assert len(set(vols)) == 1
