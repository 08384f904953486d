"""The plain reference against the port on the CPU at tiny sizes, and its
recounts and multicast replay against hand counts."""
from __future__ import annotations

import itertools
import time

import numpy as np
import pytest
import torch

import harness
import snngen
from reference import check, lif, mapping, multicast, noc


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



# The multicast reference on a 3 x 3 mesh (24 directed links), counted by
# hand: core c sits at (c % 3, c // 3).
MESH3 = dict(w=3, h=3, inject_capacity=256, energy=(0.98 + 0.34, 0.10),
             device="cpu")


def _var24(loads: dict) -> float:
    per_link = np.zeros(24)
    for link, n in loads.items():
        per_link[link] = n
    return float(np.var(per_link))


def _mc_replay(t, s, d, core_of, link_capacity):
    return multicast.replay(np.array(t), np.array(s), np.array(d),
                            np.array(core_of), link_capacity=link_capacity,
                            **MESH3)


def test_multicast_fork_over_a_shared_link_by_hand():
    # Neuron 0 on core 0 fires once to neurons 1 and 2 on core 2 and to
    # neuron 3 on core 4: one packet a destination core, one flit, whose
    # tree is east (0,0)->(1,0), then east (1,0)->(2,0) and south
    # (1,0)->(1,1), granted at cycles 0, 1 and 1.
    got = _mc_replay([0, 0, 0], [0, 0, 0], [1, 2, 3], [0, 2, 2, 4], 4)
    assert got == {
        "avg_latency": 2.0, "max_latency": 2, "avg_hop": 2.0,
        "total_hops": 4, "congestion_count": 0,
        "edge_variance": _var24({0: 1, 1: 1, 12 + 1 * 2 + 0: 1}),
        "dynamic_energy_pj": 3 * 1.32, "num_noc_spikes": 2,
        "num_local_spikes": 0, "cycles_simulated": 2}


def test_multicast_contention_and_a_local_delivery_by_hand():
    # Step 0: neuron 0 (core 0) fires to neuron 2 (core 1) and to neuron 1
    # on its own core; neuron 1 (core 0) fires to neuron 3 (core 2).  Both
    # flits ask for east (0,0)->(1,0) at cycle 0; at one a cycle the lower
    # firing id goes first, the other waits a cycle (congestion 1), then
    # takes east (1,0)->(2,0) at cycle 2.  Step 1: neuron 1 fires alone.
    got = _mc_replay([0, 0, 0, 1], [0, 0, 1, 1], [2, 1, 3, 3],
                     [0, 0, 1, 2], 1)
    assert got == {
        "avg_latency": (1 + 3 + 2) / 3, "max_latency": 3, "avg_hop": 5 / 3,
        "total_hops": 5, "congestion_count": 1,
        "edge_variance": _var24({0: 3, 1: 2}),
        "dynamic_energy_pj": 5 * 1.32 + 0.10, "num_noc_spikes": 3,
        "num_local_spikes": 1, "cycles_simulated": 3 + 2}


def test_multicast_recounts_by_hand():
    # Neuron 0 (partition 0) fires 5 times to partitions 1, 1 and 2;
    # neuron 1 (partition 1) 7 times to partition 2 and to neuron 2 of its
    # own partition.  Partitions sit on cores 0, 2 and 4.
    part = np.array([0, 1, 1, 2])
    src, dst = np.array([0, 0, 0, 1, 1]), np.array([1, 2, 3, 3, 2])
    fire = np.array([5, 7, 0, 0])
    placement = np.array([0, 2, 4])
    c = multicast.traffic(part, 3, src, dst, fire)
    assert c.tolist() == [[0, 5, 5], [0, 7, 7], [0, 0, 0]]
    assert multicast.comm_volume(part, src, dst, fire) == 5 * 2 + 7
    # Trees: core 0 to cores 2 and 4 takes 3 links, core 2 to core 4 two.
    assert multicast.tree_links(part, placement, src, dst, fire, 3, 3) \
        == 5 * 3 + 7 * 2
    spikes = fire[src]
    pl = mapping.placement_checks(part, 3, placement, (2 * 5 + 2 * 5 + 2 * 7)
                                  / 24, 9, 3, src, dst, spikes, c)
    assert pl["place_bad"] == 0 and pl["hop_gap"] < 1e-15


@pytest.mark.parametrize("screen", ["numpy", "linkload"])
def test_multicast_replay_equals_the_port_on_a_congested_mesh(screen):
    from repro_torch.nocsim import simulate_noc

    rng = np.random.default_rng(3)
    w = h = 3
    n, k = 60, 9
    t = np.sort(rng.integers(0, 5, 4000))
    s, d = rng.integers(0, n, 4000), rng.integers(0, n, 4000)
    part = rng.integers(0, k, n)
    placement = rng.permutation(w * h)
    for cap, inject in ((1, 256), (2, 3)):
        got = simulate_noc(t, s, d, part, placement, w, h, link_capacity=cap,
                           inject_capacity=inject, cast="multicast",
                           screen=screen, device="cpu")
        ref = multicast.replay(t, s, d, placement[part], w, h, cap, inject,
                               (0.98 + 0.34, 0.10), "cpu")
        assert ref["congestion_count"] > 0
        assert ref["num_noc_spikes"] < int((placement[part][s]
                                            != placement[part][d]).sum())
        assert check.noc_gap({f: getattr(got, f) for f in check.NOC_FIELDS},
                             ref) == 0.0


def test_multicast_run_is_judged_to_the_tree_replay(volume):
    spec = volume()
    out = harness.run(spec, 2**31 + 61, 0.0, False, "cpu", time.perf_counter(),
                      log=lambda msg: None)
    assert out["correct"] is True
    assert {k: c["value"] for k, c in out["checks"].items()} == {
        k: 0 for k in spec.cell["limits"]}
    assert {"noc_gap", "vol_gap", "tree_gap"} <= set(out["checks"])


def test_per_synapse_hop_gap_fails_a_sound_multicast_answer(volume):
    """The unicast recount, which the judge used for every answer before
    it followed the stated cast, reads a sound multicast answer wrong."""
    spec = volume("edge_5120-16x16.map")
    cell = harness.Cell(spec, 2**31 + 62, "cpu")
    a = cell.job(1)["answers"][0]
    assert a["platform"]["cast"] == "multicast"
    want = harness.reference_profile(cell)
    src = cell.network.syn_src.astype(np.int64)
    dst = cell.network.syn_dst.astype(np.int64)
    p = a["platform"]
    args = (np.asarray(a["part"]), a["k"], a["placement"], a["avg_hop"],
            p["mesh_w"] * p["mesh_h"], p["mesh_w"], src, dst,
            want.fire_counts[src])
    assert mapping.placement_checks(*args)["hop_gap"] > 0
    c = multicast.traffic(args[0], a["k"], src, dst, want.fire_counts)
    assert mapping.placement_checks(*args, c)["hop_gap"] == 0
