"""The plain reference against the port on the CPU at tiny sizes, and its
recounts against hand counts."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import harness
import snngen
from reference import check, lif, mapping, noc


def _port_profile(spec, seed):
    cell = harness.Cell(spec, seed, "cpu")
    return cell, cell._profile()


def _random_edges(spec):
    """The cell with random connections in place of receptive fields."""
    spec.config["snn"]["connections"] = [{"kind": "random", "p": 0.08},
                                         {"kind": "random", "p": 0.08}]
    return spec


@pytest.mark.parametrize("edges", ["local", "random"])
def test_reference_profile_equals_the_port(tiny, edges):
    spec = tiny("edge_5120-16x16.replay")
    if edges == "random":
        spec = _random_edges(spec)
    cell, prof = _port_profile(spec, 2**31 + 99)
    want = harness.reference_profile(cell)
    got = harness.profile_arrays(prof)
    assert check.profile_numbers(want, got, cell.network.num_neurons,
                                 "cpu") == {"trace_diff": 0, "fire_diff": 0}
    assert want.num_steps == prof.num_steps
    assert prof.num_spikes >= cell.network.target_spikes  # cut, not short


def test_bf16_profile_differs(tiny):
    cell, _ = _port_profile(tiny("edge_5120-16x16.replay"), 7)
    want = harness.reference_profile(cell)
    low = harness.reference_profile(cell, torch.bfloat16)
    nums = check.profile_numbers(want, harness.profile_arrays(low),
                                 cell.network.num_neurons, "cpu")
    assert nums["trace_diff"] > 0


def test_trace_cut_at_target():
    net = snngen.build("t", {"layers": [16, 8], "connections": [
        {"kind": "random", "p": 0.5}], "gain": 1.0, "input_rate": 0.5,
        "input_amp": 1.5, "target_spikes": 50,
        "lif": {"decay": 0.9, "threshold": 1.0, "v_reset": 0.0,
                "refractory": 1}}, seed=3)
    prof = lif.simulate(net, snngen.drive(net, 40, 4))
    per_step = np.bincount(prof.trace_t)
    assert per_step[:-1].sum() < 50 <= per_step.sum()
    out_deg = np.bincount(net.syn_src, minlength=net.num_neurons)
    assert (prof.fire_counts * out_deg).sum() == prof.trace_t.shape[0]


def _random_trace(rng, n, cores, steps):
    t = np.sort(rng.integers(0, steps, n))
    return t, rng.integers(0, cores, n), rng.integers(0, cores, n)


def test_replay_equals_the_port_on_a_congested_mesh():
    from repro_torch.nocsim import simulate_noc

    rng = np.random.default_rng(0)
    w = h = 3
    t, s, d = _random_trace(rng, 3000, w * h, 6)
    ident = np.arange(w * h)
    for cap, inject in ((1, 256), (2, 3)):
        for engine in ("batched", "ref"):
            got = simulate_noc(t, s, d, ident, ident, w, h, link_capacity=cap,
                               inject_capacity=inject, engine=engine,
                               device="cpu")
            ref = noc.replay(t, s, d, w, h, cap, inject, (0.98 + 0.34, 0.10),
                             "cpu")
            assert ref["congestion_count"] > 0
            assert check.noc_gap({f: getattr(got, f) for f in check.NOC_FIELDS},
                                 ref) == 0.0


def _cost(sym, dist, perm):
    return (sym * dist[np.ix_(perm, perm)]).sum() / 2.0


def test_swap_gain_against_every_swap():
    rng = np.random.default_rng(1)
    k, cores, w = 6, 9, 3
    traffic = rng.integers(0, 50, (k, k)).astype(float)
    placement = rng.permutation(cores)[:k]
    ids = np.arange(cores)
    dist = (np.abs(ids[:, None] % w - ids[None, :] % w)
            + np.abs(ids[:, None] // w - ids[None, :] // w)).astype(float)
    sym = np.zeros((cores, cores))
    sym[:k, :k] = traffic + traffic.T
    np.fill_diagonal(sym, 0)
    perm = np.concatenate([placement, np.setdiff1d(ids, placement)])
    base = _cost(sym, dist, perm)
    best = 0.0
    for a, b in itertools.combinations(range(cores), 2):
        p2 = perm.copy()
        p2[[a, b]] = p2[[b, a]]
        best = max(best, base - _cost(sym, dist, p2))
    got = mapping.best_swap_gain(traffic, placement, cores, w)
    assert np.isclose(got, best / base, rtol=1e-12, atol=0)
    assert best > 0


def test_partition_and_placement_recounts():
    src = np.array([0, 0, 1, 2])
    dst = np.array([1, 2, 3, 3])
    spikes = np.array([5, 7, 2, 1])
    part = np.array([0, 0, 1, 1])
    pc = mapping.partition_checks(part, 2, 7 + 2, 2, 4, src, dst, spikes)
    assert pc == {"cap_over": 0, "cut_gap": 0}
    assert mapping.partition_checks(part, 2, 0, 1, 4, src, dst,
                                    spikes)["cap_over"] == 2
    pl = mapping.placement_checks(part, 2, np.array([0, 3]), 9 * 2 / 15, 4, 2,
                                  src, dst, spikes)
    assert pl["place_bad"] == 0 and pl["hop_gap"] < 1e-15
    assert mapping.placement_checks(part, 2, np.array([1, 1]), 1.0, 4, 2, src,
                                    dst, spikes)["place_bad"] == 1

