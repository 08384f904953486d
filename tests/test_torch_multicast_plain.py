"""The port's multicast path held against the benchmark's plain reference on
the CPU: ``bench/reference/multicast.py`` (written from the multicast rules
the toolchain documents, importing nothing of the port) and the comparison
that decides a benchmark run's ``correct`` (``bench/reference/check.py``).

On seeded traces in which every firing transmits on each synapse of its
source (as a profile does), an 8 x 8 mesh and a few hundred neurons: the
firings' packets, the communication volume, the XY trees, the multicast
traffic matrix and every NoCStats field of the tree-fork replay, exactly;
the replay on the link-load screen on the card (marked ``cuda``); and a
whole volume job of the toolchain on the benchmark's multicast deployment
(``bench/configs/edge_5120-16x16-mc.json``, ``bench/mixes/volume.json``),
cut to that size, judged under the limits of its cell file with every
number at 0.  This file imports neither the JAX package nor JAX."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import comm_volume
from repro_torch.core.graph import build_hypergraph
from repro_torch.core.hopcost import traffic_matrix
from repro_torch.nocsim import simulate_noc
from repro_torch.nocsim.xy import link_count, multicast_tree_links
from repro_torch.trace import dedupe_firings

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import harness  # noqa: E402
from reference import check, multicast  # noqa: E402

W = H = 8
N, SYNAPSES, STEPS, K = 320, 2400, 24, 40
ENERGY = (0.98 + 0.34, 0.10)  # pJ a link traversal, pJ a local delivery
SEEDS = [0, 1, 2]
CELL = (BENCH / "configs" / "edge_5120-16x16-mc.json",
        BENCH / "mixes" / "volume.json",
        BENCH / "cells" / "edge_5120-16x16-mc.volume.json")


def _case(seed: int) -> dict:
    """Synapses, fire counts, the trace they make (each firing on every
    synapse of its source, in time order), a partition into K parts and an
    injective placement of the parts on the mesh."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, SYNAPSES)
    dst = rng.integers(0, N, SYNAPSES)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    fires = rng.random((STEPS, N)) < 0.3
    fire = fires.sum(axis=0)
    order = np.argsort(src, kind="stable")
    s_sorted, d_sorted = src[order], dst[order]
    start = np.searchsorted(s_sorted, np.arange(N))
    count = np.bincount(s_sorted, minlength=N)
    ft, fs = np.nonzero(fires)  # firings, in (t, neuron) order
    reps = count[fs]
    first = np.repeat(start[fs], reps)
    within = np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps)
    return {"src": src, "dst": dst, "fire": fire,
            "t": np.repeat(ft, reps).astype(np.int64),
            "tsrc": s_sorted[first + within], "tdst": d_sorted[first + within],
            "part": rng.integers(0, K, N),
            "placement": rng.permutation(W * H)[:K]}


def _remote_packets(c: dict):
    """The port's (t, source neuron, destination core, firing) packets of
    the trace's NoC-bound records."""
    core = c["placement"][c["part"]]
    remote = core[c["tsrc"]] != core[c["tdst"]]
    return dedupe_firings(c["t"][remote], c["tsrc"][remote],
                          core[c["tdst"]][remote], N, W * H)


def _reference_replay(c: dict, link_capacity: int, inject_capacity: int):
    return multicast.replay(c["t"], c["tsrc"], c["tdst"],
                            c["placement"][c["part"]], W, H, link_capacity,
                            inject_capacity, ENERGY, torch.device("cpu"))


@pytest.mark.parametrize("seed", SEEDS)
def test_packets_are_the_references(seed):
    c = _case(seed)
    _, psrc, pdst, firing = _remote_packets(c)
    assert psrc.shape[0] == _reference_replay(c, 10_000, 256)["num_noc_spikes"]
    # With the parts as destinations: one packet a (firing, foreign part).
    _, fsrc, fpart, _ = dedupe_firings(c["t"], c["tsrc"],
                                       c["part"][c["tdst"]], N, K)
    foreign = fpart != c["part"][fsrc]
    want = multicast.traffic(c["part"], K, c["src"], c["dst"], c["fire"])
    assert int(foreign.sum()) == int(want.sum() - np.trace(want))
    assert (np.diff(firing) >= 0).all()  # packets in ascending firing id


@pytest.mark.parametrize("seed", SEEDS)
def test_comm_volume_is_the_references(seed):
    c = _case(seed)
    hyper = build_hypergraph(N, c["src"], c["dst"], c["fire"])
    assert comm_volume(hyper, c["part"]) == multicast.comm_volume(
        c["part"], c["src"], c["dst"], c["fire"])


@pytest.mark.parametrize("seed", SEEDS)
def test_tree_links_are_the_references(seed):
    c = _case(seed)
    _, psrc, pdst, firing = _remote_packets(c)
    score = c["placement"][c["part"]][psrc]
    tids, tgrp = multicast_tree_links(score, pdst, firing, W, H)
    grp, link, _, _ = multicast._tree(
        torch.as_tensor(firing), torch.as_tensor(score),
        torch.as_tensor(pdst), W, H, link_count(W, H))
    np.testing.assert_array_equal(tgrp, grp.numpy())
    np.testing.assert_array_equal(tids, link.numpy())
    assert tids.shape[0] == multicast.tree_links(
        c["part"], c["placement"], c["src"], c["dst"], c["fire"], W, H)


@pytest.mark.parametrize("seed", SEEDS)
def test_traffic_matrix_is_the_references(seed):
    c = _case(seed)
    got = traffic_matrix(c["part"], c["tsrc"], c["tdst"], K, trace_t=c["t"],
                         cast="multicast")
    np.testing.assert_array_equal(
        got, multicast.traffic(c["part"], K, c["src"], c["dst"], c["fire"]))


def _tree_replay(c, link_capacity, inject_capacity, screen, device):
    got = simulate_noc(c["t"], c["tsrc"], c["tdst"], c["part"],
                       c["placement"], W, H, link_capacity=link_capacity,
                       inject_capacity=inject_capacity, mode="queued",
                       cast="multicast", screen=screen, device=device)
    want = _reference_replay(c, link_capacity, inject_capacity)
    for f in check.NOC_FIELDS:
        assert getattr(got, f) == want[f], f
    assert check.noc_gap({f: getattr(got, f) for f in check.NOC_FIELDS},
                         want) == 0
    return got


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("link_capacity,inject_capacity",
                         [(1, 256), (2, 3), (10_000, 256)])
def test_tree_replay_stats_are_the_references(seed, link_capacity,
                                              inject_capacity):
    got = _tree_replay(_case(seed), link_capacity, inject_capacity, "numpy",
                       "cpu")
    if link_capacity == 1:
        assert got.congestion_count > 0  # the stepper ran


@pytest.fixture
def cuda():
    """The card, or a skip where CUDA (and so nvcc's kernels) is absent."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the link-load screen's kernel "
                    "runs only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_tree_replay_on_the_link_load_screen_is_the_references(cuda, seed):
    _tree_replay(_case(seed), 1, 256, "linkload", cuda)


def _small_cell() -> "harness.Spec":
    """The benchmark's multicast deployment at a size the CPU runs in
    seconds: 352 neurons on an 8 x 8 mesh at 8 a core, 80 steps, link
    capacity 1 so that the replay congests; the volume mix and the limits
    of its cell file as they are."""
    spec = harness.spec_from_files(*CELL)
    cfg = json.loads(json.dumps(spec.config))
    cfg["snn"]["layers"] = [144, 144, 64]
    cfg["snn"]["target_spikes"] = 20_000
    cfg["num_steps"] = 80
    cfg["platform"].update(mesh_w=W, mesh_h=H, capacity=8, link_capacity=1)
    spec.config = cfg
    spec.cell = {**spec.cell, "quality_jobs": 1}
    return spec


@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_volume_job_is_judged_correct(seed):
    spec = _small_cell()
    assert spec.config["platform"]["cast"] == "multicast"
    assert spec.mix["toolchain"]["objective"] == "volume"
    cell = harness.Cell(spec, seed, "cpu")
    rec = cell.job(len(cell.quality_seeds) + 1)  # one of the run's own jobs
    (a,) = rec["answers"]
    assert (a["objective"], a["cast"]) == ("volume", "multicast")
    assert a["noc"]["congestion_count"] > 0
    numbers, failed = harness.judge(cell, [rec], "cpu")
    assert set(numbers) == set(spec.cell["limits"])
    assert numbers == {name: 0 for name in numbers}
    assert failed == 0
