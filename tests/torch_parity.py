"""What the port's parity suites (``tests/test_torch_<suite>.py``, one a
reference suite) share.

`pair` builds an input twice from one seed: with the builder of
``tests/conftest.py`` (the reference's types) and with its twin in
``tests/torch_builders.py`` (the port's), and holds the two bitwise equal
before a test feeds one to each package.  `mismatched` lists the fields of
two results (``NoCStats``, ``MappingResult``, ``PartitionResult``, ...)
that differ, bitwise for arrays.
"""
import dataclasses

import numpy as np

import conftest
import torch_builders

GRAPH_FIELDS = ("xadj", "adjncy", "adjwgt", "vwgt")
HYPER_FIELDS = ("hxadj", "hpins", "hwgt", "hsrc", "hfire")


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def assert_bitwise(got, want) -> None:
    """Two arrays (or scalars) equal in dtype and every value."""
    assert _same(np.asarray(got), np.asarray(want))


def assert_hyper_equal(port, ref) -> None:
    """The port's hypergraph is the reference's, field by field, bitwise."""
    assert port.num_vertices == ref.num_vertices
    for f in HYPER_FIELDS:
        assert _same(getattr(port, f), getattr(ref, f)), f


def assert_graph_equal(port, ref) -> None:
    """The port's graph (its ``cmap`` and ``hyper`` too) is the
    reference's, bitwise."""
    for f in GRAPH_FIELDS:
        assert _same(getattr(port, f), getattr(ref, f)), f
    assert (port.cmap is None) == (ref.cmap is None)
    if ref.cmap is not None:
        assert _same(port.cmap, ref.cmap), "cmap"
    assert (port.hyper is None) == (ref.hyper is None)
    if ref.hyper is not None:
        assert_hyper_equal(port.hyper, ref.hyper)


def pair(builder: str, *args, **kw):
    """(reference input, port input) from the builder named ``builder``,
    held bitwise equal."""
    ref = getattr(conftest, builder)(*args, **kw)
    port = getattr(torch_builders, builder)(*args, **kw)
    if isinstance(ref, tuple):
        assert len(ref) == len(port)
        for a, b in zip(port, ref):
            assert _same(a, b)
    else:
        assert_graph_equal(port, ref)
    return ref, port


def mismatched(got, want, skip=("seconds",)) -> list[str]:
    """Names of the dataclass fields of ``got`` and ``want`` that differ
    (bitwise for arrays), leaving out the wall-clock ones in ``skip``."""
    return [f.name for f in dataclasses.fields(want)
            if f.name not in skip
            and not _same(getattr(got, f.name), getattr(want, f.name))]


def simulate(*args, ref_kw: dict | None = None, **kw):
    """The port's `simulate_noc` on the CPU, every NoCStats field bitwise
    the reference's on the same inputs (run with ``ref_kw`` where given,
    else with ``kw``).  Returns the port's stats."""
    from repro.nocsim import simulate_noc as ref_simulate_noc

    from repro_torch.nocsim import simulate_noc

    got = simulate_noc(*args, device="cpu", **kw)
    want = ref_simulate_noc(*args, **(kw if ref_kw is None else ref_kw))
    assert mismatched(got, want, skip=()) == []
    return got


def assert_mapping_equal(got, want) -> None:
    """Two MappingResults: placement, costs, evaluations, objective and the
    history's cost samples bitwise (its time axis is the host's clock)."""
    assert mismatched(got, want, skip=("seconds", "history")) == []
    assert [c for _, c in got.history] == [c for _, c in want.history]


def assert_toolchain_equal(got, want) -> None:
    """Two ToolchainResults: partition, mapping and NoCStats bitwise, and
    the same method, objective, cast and placement objective."""
    assert mismatched(got.partition, want.partition) == []
    assert_mapping_equal(got.mapping, want.mapping)
    assert mismatched(got.noc, want.noc, skip=()) == []
    for f in ("method", "snn", "objective", "cast", "place_objective",
              "degradation"):
        assert getattr(got, f) == getattr(want, f), f


def profiles(name: str, num_steps: int, seed: int = 0):
    """(reference profile, port profile) of paper SNN ``name``: the port's
    own `profile_snn` on the CPU, held bitwise to the reference's."""
    from repro.snn import make_snn as ref_make_snn
    from repro.snn import profile_snn as ref_profile_snn

    from repro_torch.snn import make_snn, profile_snn

    ref = ref_profile_snn(ref_make_snn(name), num_steps=num_steps, seed=seed)
    got = profile_snn(make_snn(name), num_steps=num_steps, seed=seed,
                      device="cpu")
    assert mismatched(got, ref, skip=("seconds", "graph")) == []
    assert_graph_equal(got.graph, ref.graph)
    return ref, got


def toolchain(ref_prof, prof, **kw):
    """`run_toolchain` of both packages on one profile (the port on the
    CPU), held equal by `assert_toolchain_equal`.  Returns the port's."""
    from repro.core import run_toolchain as ref_run_toolchain

    from repro_torch.core import run_toolchain

    got = run_toolchain(prof, device="cpu", **kw)
    assert_toolchain_equal(got, ref_run_toolchain(ref_prof, **kw))
    return got


def assert_levels_equal(port_levels, ref_levels) -> None:
    """Two coarsening hierarchies level by level, bitwise."""
    assert len(port_levels) == len(ref_levels)
    for p, r in zip(port_levels, ref_levels):
        assert_graph_equal(p, r)
