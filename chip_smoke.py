#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the eight CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
   one process per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the slice runs give it (bitwise for lif_step — 60 fused steps of
   edge_5120 from rest, raster, v and refr, and the step alone on a given
   current — exact for part_degrees, connectivity_degrees, swap_deltas and
   link_loads over 256 windows x 8,000 packet records; rtol 1e-6 and
   bitwise repeatable for hop_cost), and times the kernel, the plain
   version and, where one exists, one PyTorch call that computes the same
   function (for lif_step the product ``spikes @ weights`` alone).
   swap_deltas also runs at K = 1024 (a 32 x 32 mesh), connectivity_degrees
   also on a 64-row subset, and hop_cost also at K = 4096.
3. Runs the cut slice run — ``profile_snn`` of the paper's edge_5120 SNN
   (1200 steps) and ``run_toolchain`` on a 16x16 mesh at capacity 40 with
   the vec partitioner, the batched SA on the kernel scorer and the
   link-load screen — then the volume slice run on the same profile: the
   communication-volume objective (vec partitioner on the connectivity
   kernel), the tree placement objective and the multicast replay.  Each
   run ends with the total hop cost of its placement on the hop_cost
   kernel, which must give the run's avg_hop.  Every kernel's launch count
   is set to 0 just before each run and read just after; each kernel of a
   run's path must have launched, the cut run exactly one lif_step launch
   a profiled step and one replay_screen launch (the unicast replay's
   screens) and no link_loads launch, the volume run exactly one
   link_loads launch (the multicast replay's loads) and no replay_screen
   launch (counted by the wrappers and seen by the profiler).  Each run
   prints the device time per launch of the redesigned kernels and the
   count and device time of its host-to-device copies.  The cut run's
   replay screen is then held against its plain version on the card on
   the same packets (flags, so the stepped set, and per-link totals
   bitwise) and timed there.  The volume run must launch volume_select
   once for each of its refiner's device selection calls; the kernel is
   then held against its plain version on the card on the inputs of two
   of those calls, Φ as each call saw it: the one with the most
   candidates (a plateau escape) and the one nearest 40 candidates —
   result bytes equal, and the chosen set the refiner's
   movers — and timed there.
4. Runs the device slice run on the same profile: the cut run's
   configuration with the device searches and stepper — ``mapper="sa_jax"``
   (population SA, then the greedy polish on swap_deltas) and
   ``stepper="jax"`` (the torch joint stepper on the card).  It must keep
   the cut run's partition, place within 1.15x of the cut run's avg_hop,
   end the polish at a swap-local optimum under the card's own deltas, and
   give, bitwise, the numpy stepper's NoC stats on its placement; it
   prints the evaluate seconds of both steppers, the stepper's packets and
   cycles and the polish's swap_deltas launches.
5. Runs the baselines on the same profile and platform: SpiNeMap
   (greedy-KL partition + PSO) and SCO (sequential packing and
   placement) with the cut run's replay, held to the reference's numbers
   and the paper's orderings (cut: sneap <= spinemap <= sco; avg_hop:
   sneap < sco), printing each run's phase seconds beside SNEAP's.
6. Runs the cut run's configuration under four fault schedules (numpy
   screen and stepper, which a replay under faults requires): none (every
   NoCStats field must equal the fault-free run's), a core failure of the
   live placement's first four cores at the trace's middle re-mapped
   incrementally and from scratch, and eight random link failures
   (re-routed, never re-mapped); held to the reference's numbers, no
   re-map may leave a real partition on a dead core, and the scratch
   re-map must launch part_degrees.
7. Runs a sweep of seeds {0, 1} x mappers {sa_jax, sa} (`run_sweep`):
   two partition runs for four configs, the sa row of seed 0 equal to
   the cut run, and each sa_jax row's placement bitwise a single
   `sa_search_jax` call's; times the batched search of the two sa_jax
   configs against the two single calls.  Each of runs 5-7 ends with
   hop_cost over its final placement and has its launches counted.
8. Runs the partition phase of the cut and volume configurations with
   the sharded engine (``partition_kwargs={"shards": 4}``, the cut one
   also with ``stream_levels``): each must equal the reference's CPU
   partition (``EXPECT``) and, bitwise, a ``shards=1`` partition on the
   card (whose levels take the degree kernels; a sharded level takes
   none, so the sharded runs launch no part_degrees or
   connectivity_degrees), within 5% of the unsharded run's cut or
   volume (``shards=None`` keeps the single-host matching, a different
   partition); prints the shard plan's notes.
9. Runs the island SA (``mapper="island"``: 4 islands x 4 chains, 4
   rounds x 4,000 steps, graphed epochs and an on-device exchange) with
   the torch stepper on the cut run's partition: an injective placement
   within 1.3x the cut run's avg_hop, repeated bitwise by the same seed.
10. Runs the SNEAP device-layout search (``sneap_device_layout``) of a
   16 x 16 logical mesh with all-to-all model-axis traffic, and of a
   14 x 18 mesh on a torus with four dead chips: both equal the
   reference's CPU run (``EXPECT``), and the all-to-all layout is 5%
   below the row-major one.  Then the engines phase (``engines_phase``):
   the engine cases of the reference's test suites that the slice runs
   do not reach — congested unicast replays at link capacity 1 and 2 and
   a multicast-tree replay on a 3 x 3 mesh (link-load screen, torch
   stepper), the vec SA scored by swap_deltas at K = 15 on a 5 x 5 mesh,
   and the vec refiner on the kernel path on a fan-out hypergraph in cut
   and volume mode — each held bitwise against the port's CPU run of the
   same inputs, in at most 30 s.  Runs 8-10 are traced like the others.
11. Checks the results by the toolchain's own means: a valid partition
   whose cut (and volume) match a recount, the known numbers of the cut
   and volume runs (``EXPECT``), packet conservation in the NoC stats, identical
   stats from the numpy screen, and an identical partition from a CPU
   re-run.  Then reruns the 1,200-step profile loop on the card and holds
   its raster bitwise against the CPU path's (``lif_run(...,
   device="cpu")``), printing the loop's own seconds.
12. The ranks phase: four processes on the card joined over gloo
   (``run_ranks``).  qwen3-moe-30b-a3b at its published width with 2
   layers in f32 on (1, 4) and (1, 2) rank meshes, each rank's model
   holding the planner's blocks (experts, heads, vocabulary), held to
   the unsharded model (tokens equal, logits within 1e-5 of max|logit|);
   the (1, 4) mesh's experts moved to the (1, 2) mesh (``remesh_params``),
   bitwise that mesh's own; 4 layers in bf16 timed on (1, 2); the island
   SA with one island a rank, bitwise the batched islands.  Then the
   tensor-parallel part: llama3-8b at its published width, 2 layers in
   f32 on (1, 4) and (1, 2) against the unsharded model (tokens equal,
   logits within 1e-5 of max|logit|, each rank's leaves the unsharded
   model's blocks by fingerprint, a decode step's 2L + 2 collectives by
   the mesh's tally) and 16 of its 32 layers in bf16 on (1, 2), timed
   beside the unsharded model (the prefill's last logits within 5e-2 of
   max|logit|, 2L + 2 = 34 collectives a decode step, each rank's peak
   memory at most 0.65 of the unsharded run's).  Then training on ranks
   (``train_ranks_part``): llama3-8b at its published width, 2 layers
   in f32 on (1, 2) and on (2, 2) with ZeRO-1, and qwen3-moe-30b-a3b, 1
   layer in f32 on (1, 2), two steps against the unsharded run from the
   same seed (loss, gradient norm, each leaf's parameters and moments by
   an estimated relative L2 error; step 2 against the floor the
   unsharded step reaches with its batch in two micro-batches; the
   step-1 sign flips of m counted; qwen3-moe's routing recorded and its
   rerouted tokens' experts named; every block two ranks hold the same
   on both), then llama3-8b with 8 layers in bf16
   on (1, 2) beside the unsharded run under both remat policies (step,
   optimizer and peak; finite, falling losses; each rank's tally equal to
   a counting mesh's; its profiled matmul FLOPs within 1% of the count).
   Then the families part (``tp_families_part``): the MLA, Mamba-2,
   hybrid, VLM and audio families at their published widths, depth cut,
   f32 on (1, 4) and (1, 2) against the unsharded run.  Last the
   checkpoint and head-dim parts (``ckpt_hd_part``), hymba-1.5b at its
   published width with one SWA and one global layer in f32:
   ``train_loop`` on (1, 2), 4 steps with a checkpoint every 2 (the
   ranks gather the whole tree, one writes), a run stopped at 2 and
   resumed (the straight run's losses bitwise), that step restored on
   (1, 4), (2, 2) and one card (every rank's parameter and moment blocks
   the checkpoint's, by fingerprint); and served with
   ``shard_head_dim_fallback=True`` on (1, 4) and (1, 2) (tokens equal,
   logits within 1e-5 of max|logit| or 4x the same-run floor, the
   attention leaves the planner's head-dim blocks, the parameter bytes
   its blocks under the flag, the tallies a counting mesh's).
   The ranks launch no TPU kernel; the parent one hop_cost (the islands'
   avg_hop).
13. Serves the LLM model zoo on the card (``repro_torch.launch.serve_batch``,
   greedy, no TPU kernel on the path: every launch count must stay 0):
   llama3-8b at its full published width and depth in bf16 (8.03 B
   parameters from a torch.Generator seeded 0 on the card; 4 prompts of 32
   tokens, 32 new), twice (the same tokens bitwise), holding the prefill's
   and the first 4 decode steps' logits to a ``mode="train"`` forward over
   prompt + generated tokens within 2e-2 of max|logit| (the serving
   invariant of tests/test_models_smoke.py), and printing init seconds,
   prefill ms, decode ms a token against the decode step's memory bound
   (the weights but the embedding table, plus the caches, over 3.35 TB/s),
   tokens/s, peak memory and, from one more traced call, the card's busy
   share; llama3-8b at full width with 2 layers in f32, the same weights
   on the CPU and the card (2 prompts of 16 tokens, 8 new: logits within
   1e-4 of max|logit| at every step, tokens equal where the top-2 margin
   exceeds 1e-3 of it); mamba2-780m at full width in bf16 as llama3-8b;
   and every other architecture reduced (f32), card against CPU within
   1e-4 and the serving invariant on the card.  Each line carries the
   card's name and power limit.
14. Trains on the card (``repro_torch.launch.train_loop``: eager train
   step, ``loss.backward()``, the port's AdamW; no TPU kernel on the
   path, every launch count must stay 0): llama3-8b at its published
   width cut to 8 of 32 layers in bf16 (2.796 B parameters, 33.5 GB of
   state; the whole model's 96 GB does not fit one card), remat on, 8 x
   512 tokens of the repeat task (seed 0), 20 steps at lr 3e-4 with the
   trainer's warmup of 5 (every loss and grad norm finite and the last 5
   losses' mean below the first 5's), and mamba2-780m at full size for
   10 steps (every loss and grad norm finite; its loss does not fall
   that soon at this rate); each run is
   repeated from the same seed and must give the same losses bitwise;
   prints step ms (median of steps 3 on), the optimizer's ms
   alone, tokens/s, the step's matmul FLOPs as the op counter counts them
   on the meta device over the step time against 989.4 dense bf16, peak memory
   against the state and a traced step's busy share.  Then the tiny
   llama and MoE configs of tests/test_train_integration.py in f32, 10
   steps on the CPU and the card from the same weights (losses within
   1e-4 relative), a run stopped at 5 and resumed from its checkpoint
   on the card (bitwise the straight run), and a reduced llama3-8b in
   bf16 whose model and optimizer state save and restore bitwise.
15. The roofline phase (no TPU kernel on the path; every launch count
   must stay 0): llama3-8b at its published width in bf16, the train step
   (8 x 512 tokens, remat), prefill (4 x 32) and the decode step (batch 4
   against a 64-slot cache), each counted op by op on the meta device
   (`repro_torch.launch.roofline.measure_cell`, exactly linear in depth)
   and run on the card (median of 5 synchronised calls) at 2 and 4
   layers, both extrapolated to 32.  At each depth the profiler's matmul
   FLOPs must equal the counted ones within 1% (both with remat's early
   stop off: the profiler also records the ops it aborts), the counted peak live
   bytes `max_memory_allocated` within ROOF_PEAK_TOL, and no time may
   fall under 0.95 of its compute term or of its least traffic (weights,
   optimizer state, inputs and caches read once at 3.35 TB/s).  Prints
   the counts, compute_s, memory_s, bound_s, the measured seconds,
   roofline_fraction and mfu (model FLOPs over 989.4 TFLOP/s over the
   measured time) with the card's name and power limit; then dry-runs
   llama3-8b's three applicable shapes and qwen3-moe-30b-a3b's decode_32k
   at full size on meta (`repro_torch.launch.dryrun.run_cell`).

Prints one line per kernel, the run's summary, the kernels JSON line, the
card's name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when CUDA is unavailable, when run outside a checkout of the repository,
or when any check fails.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The H100 SXM data sheet's peaks (HBM3 B/s; f32 CUDA-core, TF32 and bf16
# tensor-core FLOP/s), bound by `main` from `repro_torch.launch.roofline`.
H100_BYTES_PER_S = H100_F32_FLOPS = H100_TF32_FLOPS = H100_BF16_FLOPS = None
EXACT_F32 = 2 ** 24  # integers below this add exactly in f32

SLICE = dict(snn="edge_5120", num_steps=1200, mesh_w=16, mesh_h=16,
             capacity=40, seed=0)
# The results the runs must reproduce: the reference's CPU run for the
# cut, baseline and fault runs, the port's CPU path for the volume run.
EXPECT = {"cut": dict(k=141, edge_cut=3_061_718, avg_hop=1.9496085318157585),
          "volume": dict(k=141, comm_volume=655_422,
                         avg_hop=1.1402133717910659),
          "spinemap": dict(k=141, edge_cut=4_511_401,
                           avg_hop=8.341370478273282,
                           avg_latency=32.56972922602092,
                           energy_pj=50419150.00000001,
                           congestion=108_743_667),
          "sco": dict(k=128, edge_cut=4_578_533, avg_hop=7.67443676828364,
                      avg_latency=73.37911051421929, energy_pj=46381713.84,
                      congestion=300_789_945),
          "fault_zero": dict(spikes_dropped=0, detour_hops=0,
                             neurons_migrated=0, remap_events=0, final_k=141,
                             avg_latency=11.159744627036194),
          "fault_incremental": dict(spikes_dropped=20_503, detour_hops=143_702,
                                    neurons_migrated=120, remap_events=1,
                                    final_k=141,
                                    avg_latency=11.165912783183066),
          "fault_scratch": dict(spikes_dropped=9_175, detour_hops=203_203,
                                neurons_migrated=5_097, remap_events=1,
                                final_k=141, avg_latency=11.880215646159172),
          "fault_link": dict(spikes_dropped=16_115, detour_hops=167_907,
                             neurons_migrated=0, remap_events=0, final_k=141,
                             avg_latency=11.038407829254174),
          # The reference's CPU run; "part" and "order" are `digest`s.
          "sharded_cut": dict(k=141, edge_cut=2_930_559, comm_volume=887_205,
                              part="ec3af148b1d99b3f"),
          "sharded_stream": dict(k=141, edge_cut=2_930_559,
                                 comm_volume=887_205, part="ec3af148b1d99b3f"),
          "sharded_volume": dict(k=141, edge_cut=3_317_397,
                                 comm_volume=661_465, part="cdbc13eb6cf7cf4f"),
          "layout_alltoall": dict(order="a693ae5b2fb882a5",
                                  base=3.722222222222222,
                                  optimized=3.2009548611111107),
          "layout_dead": dict(order="ed7a2444347d545e",
                              base=1.3578643578643579,
                              optimized=1.3578643578643579)}
# The fault runs' core failure: the first cores of the live placement at
# the middle of the trace (as benchmarks/bench_faults.py picks them).
FAULT_VICTIMS = 4
# Population SA + polish may place worse than the batched SA by this much.
DEVICE_HOP_BOUND = 1.15
# The island SA's bound over the serial SA (tests/test_island_sa.py).
ISLAND_HOP_BOUND = 1.3
SHARDS = 4
# A sharded partition's cut (volume) may differ from the single-host one
# by this share (tests/test_sharded_partition.py's bound).
SHARDED_DRIFT = 0.05
# The device-layout runs: (mesh shape, bytes per axis, keyword arguments).
LAYOUTS = {
    "layout_alltoall": ({"data": 16, "model": 16}, {"data": 5e8, "model": 5e9},
                        dict(phys_w=16, iters=120_000, seed=0,
                             patterns={"model": "alltoall"})),
    "layout_dead": ({"data": 14, "model": 18}, {"data": 5e8, "model": 5e9},
                    dict(phys_w=16, iters=120_000, seed=0,
                         dead_chips=[17, 90, 91, 200])),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3, repeats: int = 5) -> float:
    """Milliseconds per call of ``fn`` on the card: CUDA events around
    ``iters`` back-to-back calls, median of ``repeats`` such loops.  For a
    small kernel this is the launch rate the host sustains, which is what
    the main path pays per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[repeats // 2]


def device_ms(fn, iters: int) -> float | None:
    """Milliseconds of device time per call of ``fn``: the summed duration
    of every kernel, copy and fill the profiler sees on the card, over
    ``iters`` calls.  None where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / iters / 1e3 if total_us > 0 else None


def bound(nbytes: float, ops: float,
          rate: float | None = None) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over ``rate`` (f32 unless given)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / (rate or H100_F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def digest(a) -> str:
    """A short hash of an integer array's values (as little-endian int64)."""
    import hashlib

    import numpy as np

    return hashlib.sha256(
        np.ascontiguousarray(a, dtype="<i8").tobytes()).hexdigest()[:16]


# --------------------------------------------------------- kernel checks


def lif_inputs(steps: int):
    """edge_5120's weights (host numpy) and the (steps, N) drive
    ``profile_snn`` feeds it from the slice's seed."""
    import numpy as np

    from repro_torch.snn import make_snn, profile_drive

    topo = make_snn(SLICE["snn"])
    return (np.ascontiguousarray(topo.weights, dtype=np.float32),
            profile_drive(topo, steps, SLICE["seed"]))


def check_lif_step(dev, rng) -> dict:
    import torch

    from repro_torch.kernels.lif_step import synapses_from_dense
    from repro_torch.kernels.lif_step.kernel import lif_step_cuda, lif_steps_cuda
    from repro_torch.kernels.lif_step.ref import lif_step_ref, lif_steps_ref

    # The profile's loop: edge_5120's synapse list and drive, T steps from
    # rest, one fused launch a step; raster, v and refr must be bitwise.
    steps = 60
    kw = dict(decay=0.9, threshold=1.0, v_reset=0.0, refractory=1)
    weights, drive_np = lif_inputs(steps)
    syn = synapses_from_dense(torch.from_numpy(weights)).to(dev)
    drive = torch.from_numpy(drive_np).to(dev)
    args = (syn.src, syn.w, syn.deg, drive)
    got = lif_steps_cuda(*args, **kw)
    want = lif_steps_ref(*args, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("raster", "v", "refr"), got, want):
        if not torch.equal(a, b):
            fail(f"fused lif_step {name} differs from the plain version "
                 f"({int((a != b).sum())} entries)")
    # The step alone on a given current (lif_step on CUDA tensors).
    n = weights.shape[0]
    v = torch.tensor(rng.uniform(-0.5, 1.2, n).astype("float32"), device=dev)
    refr = torch.tensor(rng.integers(0, 3, n).astype("int32"), device=dev)
    cur = torch.tensor(rng.uniform(0.0, 0.6, n).astype("float32"), device=dev)
    for name, a, b in zip(("v", "refr", "fired"), lif_step_cuda(v, refr, cur, **kw),
                          lif_step_ref(v, refr, cur, **kw)):
        if not torch.equal(a, b):
            fail(f"lif_step {name} differs from the plain version")
    nnz = int(syn.deg.sum())
    # Bytes once a step: the synapses (source and weight), their counts,
    # the previous raster row, the drive row, v and refr read and written,
    # the raster row written.  One add a synapse at most.
    step_bytes = 8 * nnz + 4 * n + n + 4 * n + 16 * n + n
    t_bound, by = bound(step_bytes, nnz)
    dense = torch.from_numpy(weights).to(dev)  # the library's yardstick only
    spikes = got[0][steps // 2].to(torch.float32)
    return dict(
        name="lif_step", source="src/repro_torch/csrc/lif_step.cu",
        replaces="src/repro/kernels/lif_step/kernel.py:38",
        max_abs_err=float((got[1] - want[1]).abs().max()),
        kernel=lambda: lif_steps_cuda(*args, **kw),
        plain=lambda: lif_steps_ref(*args, **kw),
        library=lambda: spikes @ dense, iters=10, per_call={"kernel": steps,
                                                            "plain": steps},
        bound_ms=t_bound, bound_by=by,
        shape=f"N={n} nnz={nnz} width={syn.src.shape[0]}, a step of {steps}; "
              f"library = spikes @ weights, the product alone")


def check_part_degrees(dev, rng) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.gain_eval.kernel import part_degrees_cuda
    from repro_torch.kernels.gain_eval.ref import part_degrees_ref, part_onehot

    n, k, deg = 3072, 141, 32  # a coarse level of the slice run
    src = np.repeat(np.arange(n), deg // 2)
    dst = rng.integers(0, n, src.shape[0])
    w = rng.integers(1, 100, src.shape[0]).astype(np.float32)
    a = np.zeros((n, n), dtype=np.float32)
    np.add.at(a, (src, dst), w)
    np.add.at(a, (dst, src), w)
    np.fill_diagonal(a, 0.0)
    if a.sum() >= 2 ** 24:
        fail("part_degrees test graph exceeds the exact-f32 gate")
    adj = torch.tensor(a, device=dev)
    part = torch.tensor(rng.integers(0, k, n).astype(np.int32), device=dev)
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    got = part_degrees_cuda(adj, part, k, rows)
    want = part_degrees_ref(adj, part, k, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("part_degrees differs from the plain version")
    onehot = part_onehot(part, k)
    nnz = int((adj != 0).sum())
    t_bound, by = bound(nbytes(adj, part, rows, got), nnz)
    return dict(
        name="part_degrees", source="src/repro_torch/csrc/part_degrees.cu",
        replaces="src/repro/kernels/gain_eval/kernel.py:49",
        max_abs_err=float((got - want).abs().max()),
        kernel=lambda: part_degrees_cuda(adj, part, k, rows),
        plain=lambda: part_degrees_ref(adj, part, k, rows),
        library=lambda: torch.matmul(adj, onehot), iters=50,
        bound_ms=t_bound, bound_by=by,
        shape=f"n={n} k={k} nnz={nnz}")


def tf32_splits(sym) -> int:
    """How many of the parts S = hi + mid + lo (top 11 significant bits,
    next 11, last 2) the swap_deltas kernel multiplies for this traffic:
    the parts that are not all zero."""
    import torch

    def top11(v):
        return (v.view(torch.int32) & -8192).view(torch.float32)

    rest = sym - top11(sym)
    lo = rest - top11(rest)
    return 1 + int(bool(top11(rest).any())) + int(bool(lo.any()))


def check_swap_deltas(dev, rng) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.swap_delta.kernel import swap_deltas_cuda
    from repro_torch.kernels.swap_delta.ref import distance_matrix, swap_deltas_ref

    rows = {}
    # The slice: 141 partitions padded to 256 cores of the 16 x 16 mesh; and
    # 900 partitions on the 32 x 32 mesh (K = 1024).  Integer traffic whose
    # sums stay below 2^24, so the kernel must equal the plain version.
    for kc, k, mesh_w, top in ((256, 141, 16, 600), (1024, 900, 32, 60)):
        c = np.zeros((kc, kc), dtype=np.float32)
        c[:k, :k] = rng.integers(0, top, (k, k))
        np.fill_diagonal(c, 0.0)
        sym = torch.tensor(c + c.T, device=dev)
        perm = rng.permutation(kc)
        x = torch.tensor((perm % mesh_w).astype(np.float32), device=dev)
        y = torch.tensor((perm // mesh_w).astype(np.float32), device=dev)
        d = distance_matrix(x, y)
        if 2 * float(sym.sum(1).max()) * float(d.max()) >= EXACT_F32:
            fail(f"swap_deltas test traffic at K={kc} exceeds the exact-f32 gate")
        got = swap_deltas_cuda(sym, x, y)
        want = swap_deltas_ref(sym, x, y)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"swap_deltas at K={kc} differs from the plain version on "
                 f"integer traffic (max abs err "
                 f"{float((got - want).abs().max())})")
        if not torch.equal(got, got.T) or float(torch.diagonal(got).abs().max()):
            fail(f"swap_deltas at K={kc} is not symmetric with a zero diagonal")
        # Split TF32 on the tensor cores: 2 K^3 flops with the symmetry for
        # each split this traffic needs.  The dense f32 form's bound (two
        # K^3 products, 4 K^3 flops at 67 TFLOP/s) is printed beside it.
        t_bound, by = bound(nbytes(sym, x, y, got),
                            2.0 * tf32_splits(sym) * kc ** 3, H100_TF32_FLOPS)
        rows[kc] = dict(
            name="swap_deltas", source="src/repro_torch/csrc/swap_deltas.cu",
            replaces="src/repro/kernels/swap_delta/kernel.py:68",
            max_abs_err=float((got - want).abs().max()),
            kernel=lambda sym=sym, x=x, y=y: swap_deltas_cuda(sym, x, y),
            plain=lambda sym=sym, x=x, y=y: swap_deltas_ref(sym, x, y),
            library=lambda sym=sym, d=d: (sym @ d, d @ sym),
            iters=200 if kc < 1024 else 50, bound_ms=t_bound, bound_by=by,
            shape=f"K={kc}", dense_bound_ms=bound(nbytes(sym, x, y, got),
                                                4.0 * kc ** 3)[0])
    print_row(timed(rows[1024]), "K=1024")  # beside the JSON row's K=256
    return rows[256]


def check_link_loads(dev, rng) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.link_load.kernel import link_loads_records_cuda
    from repro_torch.kernels.link_load.ref import link_loads_records_ref, pack_routes

    # 256 windows of 8,000 packets on the slice's 16 x 16 mesh, as the
    # replay hands them over: window-sorted 4-byte route records.
    b, w, h, per_window = 256, 16, 16, 8000
    k = w * h
    n = b * per_window
    woff = torch.arange(0, n + 1, per_window, dtype=torch.int32, device=dev)
    s = rng.integers(0, k, n)
    t = rng.integers(0, k, n)
    rec = pack_routes(torch.tensor(s, device=dev), torch.tensor(t, device=dev))
    cores = torch.arange(k, dtype=torch.int32, device=dev)
    x, y = cores % w, cores // w
    got = link_loads_records_cuda(woff, rec, None, x, y, w, h)
    want = link_loads_records_ref(woff, rec, None, x, y, w, h)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("link_loads differs from the plain version")
    hops = (np.abs(s % w - t % w) + np.abs(s // w - t // w)).sum()
    t_bound, by = bound(nbytes(woff, rec, x, y, got), float(hops))
    return dict(
        name="link_loads", source="src/repro_torch/csrc/link_loads.cu",
        replaces="src/repro/kernels/link_load/kernel.py:99",
        max_abs_err=float((got - want).abs().max()),
        kernel=lambda: link_loads_records_cuda(woff, rec, None, x, y, w, h),
        plain=lambda: link_loads_records_ref(woff, rec, None, x, y, w, h),
        library=None, iters=20, bound_ms=t_bound, bound_by=by,
        shape=f"{b} windows x {per_window} packet records, K={k}")


class ScreenSpy:
    """Keeps the arguments of the replay's screen calls
    (``record_replay_screen``) made while it is open, in ``calls``."""

    def __init__(self):
        from repro_torch.kernels import link_load

        self.link_load, self.calls = link_load, []
        self.real = link_load.record_replay_screen

    def __enter__(self):
        def spy(*args, **kwargs):
            self.calls.append(args)
            return self.real(*args, **kwargs)

        self.link_load.record_replay_screen = spy
        return self

    def __exit__(self, *exc):
        self.link_load.record_replay_screen = self.real
        return False


def check_replay_screen(dev, packets) -> dict:
    """The replay screen's kernel against its plain version on the card, on
    the packets a replay handed it (``ScreenSpy``): flags (so the stepped
    set) and per-link totals and counts bitwise."""
    import numpy as np
    import torch

    from repro_torch.kernels.link_load import STEPPED
    from repro_torch.kernels.link_load.kernel import replay_screen_cuda
    from repro_torch.kernels.link_load.ref import pack_routes, replay_screen_ref

    win, src, dst, inject, n_win, w, h, cap = packets[:8]
    woff = torch.tensor(np.searchsorted(win, np.arange(n_win + 1)),
                        dtype=torch.int32, device=dev)
    rec = pack_routes(torch.tensor(src, device=dev), torch.tensor(dst, device=dev))
    inj = torch.tensor(inject, dtype=torch.int32, device=dev)
    got = replay_screen_cuda(woff, rec, inj, w, h, cap)
    want = replay_screen_ref(woff, rec, inj, w, h, cap)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        fail("replay_screen differs from the plain version")
    nl = got[1].shape[0] - 3
    hot, past, bad = got[1][nl:].tolist()
    stepped = int(((got[0] & STEPPED) != 0).sum())
    print(f"replay_screen on the cut run's packets: {rec.shape[0]} packets in "
          f"{n_win} windows; {hot} hot pairs, {past} past the load screen, "
          f"{bad} windows oversubscribed, {stepped} stepped, as the plain "
          "version")
    hops = (np.abs(src % w - dst % w) + np.abs(src // w - dst // w)).sum()
    t_bound, by = bound(nbytes(woff, rec, inj, *got), float(hops))
    return dict(
        name="replay_screen", source="src/repro_torch/csrc/replay_screen.cu",
        replaces="none (the host's route expansion behind the replay's screens)",
        max_abs_err=float((got[1] - want[1]).abs().max()),
        kernel=lambda: replay_screen_cuda(woff, rec, inj, w, h, cap),
        plain=lambda: replay_screen_ref(woff, rec, inj, w, h, cap),
        library=None, iters=20, bound_ms=t_bound, bound_by=by,
        shape=f"the cut run's {rec.shape[0]} packets in {n_win} windows, "
              f"K={w * h}, link capacity {cap}")


class SelectSpy:
    """Counts the volume refiner's device selection calls
    (``refine_vec._volume_select_via_kernel``) made while it is open, and
    keeps in ``calls`` the inputs and movers of two of them, Φ copied as
    the call saw it: ``largest``, the call with the most candidates (a
    plateau escape at the edge_5120 slice), and ``near_40``, the call
    nearest 40 candidates."""

    def __init__(self):
        from repro_torch.core import refine_vec

        self.refine_vec, self.real = refine_vec, refine_vec._volume_select_via_kernel
        self.calls, self.count = {}, 0

    def reset(self):
        self.calls, self.count = {}, 0

    def keep(self, kstate, part, target, cand_idx, pri, movers):
        n = cand_idx.shape[0]
        slots = [name for name, held, better in (
            ("largest", self.calls.get("largest"),
             lambda c: n > c["cand"].shape[0]),
            ("near_40", self.calls.get("near_40"),
             lambda c: abs(n - 40) < abs(c["cand"].shape[0] - 40)))
            if held is None or better(held)]
        if not slots:
            return
        call = dict(vxadj=kstate.vxadj, vedges=kstate.vedges,
                    phi=kstate.phi.clone(), cand=cand_idx.copy(),
                    own=part[cand_idx].copy(), target=target[cand_idx].copy(),
                    pri=pri.copy(), movers=movers.copy())
        for name in slots:
            self.calls[name] = call

    def __enter__(self):
        def spy(kstate, part, target, cand_idx, pri):
            got = self.real(kstate, part, target, cand_idx, pri)
            self.count += 1
            self.keep(kstate, part, target, cand_idx, pri, got[0])
            return got

        self.refine_vec._volume_select_via_kernel = spy
        return self

    def __exit__(self, *exc):
        self.refine_vec._volume_select_via_kernel = self.real
        return False


def check_volume_select(dev, calls: dict) -> dict:
    """The volume mover selection's kernel against its plain version on the
    card, on the inputs of the volume run's own calls (``SelectSpy``):
    result bytes equal (chosen flags, contended keys, rounds run), and the
    chosen set the movers the refiner took.  Returns the largest call's
    row; prints the row of the call nearest 40 candidates beside it."""
    import numpy as np
    import torch

    from repro_torch.core.refine_vec import _LUBY_ROUNDS
    from repro_torch.kernels.gain_eval import SelectSlots
    from repro_torch.kernels.gain_eval.kernel import volume_select_cuda
    from repro_torch.kernels.gain_eval.ref import volume_select_ref

    if set(calls) != {"largest", "near_40"}:
        fail("volume_select: the volume run made no device selection call")
    rows = {}
    for name, c in calls.items():
        ins = [torch.tensor(c[x].astype(np.int32), device=dev)
               for x in ("cand", "own", "target", "pri")]
        args = (c["vxadj"], c["vedges"], c["phi"], *ins, _LUBY_ROUNDS)
        slots = SelectSlots(c["phi"].numel(), dev)
        got = volume_select_cuda(*args, slots)
        want = volume_select_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"volume_select on the {name} call differs from the plain version")
        host = got.cpu().numpy()
        if not np.array_equal(np.sort(c["cand"][host[8:] != 0]),
                              np.sort(c["movers"])):
            fail(f"volume_select on the {name} call: the chosen set is not "
                 "the refiner's movers")
        contended, ran = (int(x) for x in host[:8].view(np.int32))
        vx = c["vxadj"].cpu().numpy().astype(np.int64)
        nc = c["cand"].shape[0]
        pairs = int((vx[c["cand"] + 1] - vx[c["cand"]]).sum())
        e, k = c["phi"].shape
        # Bytes once: a candidate's four inputs, CSR offsets and result
        # byte (25 B); a pair's hyperedge id (4 B); for each of a pair's
        # two slots Φ, the packed counts and the used stamp (16 B); for a
        # contended key its priority maximum and stamp (12 B).
        moved = 25 * nc + 4 * pairs + 2 * 16 * pairs + 12 * contended
        t_bound, by = bound(moved, 0.0)
        print(f"volume_select on the volume run's {name} call: {nc} "
              f"candidates, {pairs} pairs, {contended} contended keys, "
              f"{ran} rounds, {int(host[8:].sum())} chosen, as the plain "
              "version and the refiner")
        rows[name] = dict(
            name="volume_select", source="src/repro_torch/csrc/volume_select.cu",
            replaces="none (the volume refiner's numpy mover selection)",
            max_abs_err=float((got.to(torch.int32)
                               - want.to(torch.int32)).abs().max()),
            kernel=lambda args=args, slots=slots: volume_select_cuda(*args, slots),
            plain=lambda args=args: volume_select_ref(*args),
            library=None, iters=20, bound_ms=t_bound, bound_by=by,
            shape=f"the volume run's {name} call: C={nc} pairs={pairs} "
                  f"contended={contended} rounds={ran} E={e} k={k}")
    near = timed(rows["near_40"])
    print_row(near, near.pop("shape"))
    return rows["largest"]


def check_connectivity_degrees(dev, rng) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.gain_eval.kernel import volume_degree_rows_cuda
    from repro_torch.kernels.gain_eval.ref import volume_degree_rows_ref

    # The finest level of the volume run that passes the kernel's gates:
    # n = 3072 vertices, E = 4096 hyperedges, 32 incidences a row, k = 141,
    # as the vertex -> hyperedge CSR with hfire-like weights, and Φ in 0..3
    # so that both presence halves and the own-column rule matter.
    n, ne, k, per_row = 3072, 4096, 141, 32
    vedges_np = np.stack([rng.choice(ne, per_row, replace=False)
                          for _ in range(n)]).reshape(-1).astype(np.int32)
    w_np = rng.integers(1, 60, vedges_np.shape[0]).astype(np.float32)
    if 2 * w_np.sum() >= EXACT_F32:
        fail("connectivity_degrees test incidence exceeds the exact-f32 gate")
    vxadj = torch.arange(0, n * per_row + 1, per_row, dtype=torch.int32, device=dev)
    vedges = torch.tensor(vedges_np, device=dev)
    w = torch.tensor(w_np, device=dev)
    phi = torch.tensor(rng.integers(0, 4, (ne, k)).astype(np.int32), device=dev)
    own_all = torch.tensor(rng.integers(0, k, n), device=dev)
    # The library yardstick: the dense product without the own-column
    # overwrite, as the TPU kernel states it.
    inc = torch.zeros((n, ne), dtype=torch.float32, device=dev)
    inc[torch.arange(n, device=dev).repeat_interleave(per_row), vedges.long()] = w
    pres = torch.cat([phi > 0, phi > 1], dim=1).to(torch.float32)
    rows = {}
    for r in (n, 64):  # every row of the level; a path-sized row subset
        ids = torch.tensor(rng.permutation(n)[:r], device=dev)
        own = own_all[ids].contiguous()
        got = volume_degree_rows_cuda(vxadj, vedges, w, phi, ids, own)
        want = volume_degree_rows_ref(vxadj, vedges, w, phi, ids, own)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"connectivity_degrees at R={r} differs from the plain version")
        # Bytes once: the rows' (e, w) lists, the Φ rows they touch, the
        # rows' CSR offsets, row and own ids, and the (R, k) output.
        touched = vedges.view(n, per_row)[ids].unique().numel()
        moved = (8 * r * per_row + 4 * k * touched + 8 * r
                 + nbytes(ids, own, got))
        t_bound, by = bound(moved, 2.0 * r * per_row * k)
        dense_bound = bound(nbytes(inc, pres, ids) + 8 * r * k,
                            2.0 * r * per_row * 2 * k)[0]
        rows[r] = dict(
            name="connectivity_degrees",
            source="src/repro_torch/csrc/connectivity_degrees.cu",
            replaces="src/repro/kernels/gain_eval/kernel.py:100",
            max_abs_err=float((got - want).abs().max()),
            kernel=lambda ids=ids, own=own: volume_degree_rows_cuda(
                vxadj, vedges, w, phi, ids, own),
            plain=lambda ids=ids, own=own: volume_degree_rows_ref(
                vxadj, vedges, w, phi, ids, own),
            library=lambda ids=ids: torch.matmul(inc[ids], pres), iters=50,
            bound_ms=t_bound, bound_by=by, dense_bound_ms=dense_bound,
            shape=f"R={r} n={n} E={ne} k={k} nnz={r * per_row}")
    print_row(timed(rows[64]), "R=64")  # beside the JSON row's R=n
    return rows[n]


def _hop_inputs(dev, rng, kk: int, mesh_w: int):
    import numpy as np
    import torch

    c = torch.tensor(rng.integers(0, 600, (kk, kk)).astype(np.float32), device=dev)
    place = rng.permutation(max(kk, mesh_w * mesh_w))[:kk]
    x = torch.tensor((place % mesh_w).astype(np.float32), device=dev)
    y = torch.tensor((place // mesh_w).astype(np.float32), device=dev)
    return c, x, y


def check_hop_cost(dev, rng) -> dict:
    import torch

    from repro_torch.kernels.hop_eval.kernel import hop_cost_cuda
    from repro_torch.kernels.hop_eval.ref import hop_cost_ref

    rows = {}
    for kk, mesh_w in ((141, 16), (4096, 64)):  # the slice's k; a large K
        c, x, y = _hop_inputs(dev, rng, kk, mesh_w)
        got = hop_cost_cuda(c, x, y)
        want = hop_cost_ref(c, x, y)
        again = [hop_cost_cuda(c, x, y) for _ in range(3)]
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=1e-6, atol=0.0):
            fail(f"hop_cost at K={kk} differs from the plain version beyond "
                 f"rtol 1e-6 ({float(got)} vs {float(want)})")
        if not all(torch.equal(a, got) for a in again):
            fail(f"hop_cost at K={kk} is not bitwise repeatable")
        # Per entry: two subtractions, one addition, a product, a sum.
        t_bound, by = bound(nbytes(c, x, y, got), 5.0 * kk * kk)
        rows[kk] = dict(
            name="hop_cost", source="src/repro_torch/csrc/hop_cost.cu",
            replaces="src/repro/kernels/hop_eval/kernel.py:43",
            max_abs_err=float((got - want).abs()),
            kernel=lambda c=c, x=x, y=y: hop_cost_cuda(c, x, y),
            plain=lambda c=c, x=x, y=y: hop_cost_ref(c, x, y),
            library=None, iters=200 if kk < 1024 else 50,
            bound_ms=t_bound, bound_by=by, shape=f"K={kk}")
    print_row(timed(rows[4096]), "K=4096")  # beside the JSON row's K=141
    return rows[141]


# ------------------------------------------------------------- slice run


def fmt(x):
    return "n/a" if x is None else f"{x:.5f}"


def print_row(r: dict, shape: str) -> None:
    old = (f" (dense f32 form bound {r['dense_bound_ms']:.5f})"
           if "dense_bound_ms" in r else "")
    print(f"kernel {r['name']} [{shape}]: max_abs_err={r['max_abs_err']} "
          f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}){old}; per call "
          f"ms={fmt(r['ms'])} plain_ms={fmt(r['plain_ms'])} "
          f"library_ms={fmt(r['library_ms'])}; device time per call "
          f"ms={fmt(r['device_ms'])} plain_ms={fmt(r['device_plain_ms'])} "
          f"library_ms={fmt(r['device_library_ms'])}")


def timed(row: dict) -> dict:
    """Time a kernel check's three callables: ``ms``/``plain_ms``/
    ``library_ms`` per call (CUDA events) and the device time per call of
    each (profiler), the library call only where one exists.  A callable
    that runs several kernel calls (``per_call``: the fused LIF run's T
    steps) is divided down to one."""
    out = {k: v for k, v in row.items()
           if k not in ("kernel", "plain", "library", "iters", "per_call")}
    per = row.get("per_call", {})
    for key, part in (("ms", "kernel"), ("plain_ms", "plain"),
                      ("library_ms", "library")):
        fn, calls = row[part], per.get(part, 1)
        out[key] = None if fn is None else cuda_ms(fn, row["iters"]) / calls
        dev_ms = None if fn is None else device_ms(fn, row["iters"])
        out["device_" + key] = None if dev_ms is None else dev_ms / calls
    return out


def launch_counters():
    """Each kernel's name -> (module, attribute) of its launch count."""
    from repro_torch.kernels.gain_eval import kernel as gain_eval
    from repro_torch.kernels.hop_eval import kernel as hop_eval
    from repro_torch.kernels.lif_step import kernel as lif_step
    from repro_torch.kernels.link_load import kernel as link_load
    from repro_torch.kernels.swap_delta import kernel as swap_delta

    return {"lif_step": (lif_step, "launches"),
            "part_degrees": (gain_eval, "launches"),
            "connectivity_degrees": (gain_eval, "connectivity_launches"),
            "swap_deltas": (swap_delta, "launches"),
            "link_loads": (link_load, "launches"),
            "replay_screen": (link_load, "screen_launches"),
            "volume_select": (gain_eval, "select_launches"),
            "hop_cost": (hop_eval, "launches")}


# The kernels each run's path goes through.
PATHS = {
    "cut": ("lif_step", "part_degrees", "swap_deltas", "replay_screen",
            "hop_cost"),
    "volume": ("connectivity_degrees", "volume_select", "link_loads",
               "hop_cost"),
    "device": ("part_degrees", "swap_deltas", "replay_screen", "hop_cost"),
    # The baselines partition and place on the host; the replay's screens
    # and the final hop cost are on the card.
    "spinemap": ("replay_screen", "hop_cost"),
    "sco": ("replay_screen", "hop_cost"),
    # A replay under a live fault state is host-only (the reference's rule).
    "fault_zero": ("part_degrees", "swap_deltas", "hop_cost"),
    "fault_incremental": ("part_degrees", "swap_deltas", "hop_cost"),
    "fault_scratch": ("part_degrees", "swap_deltas", "hop_cost"),
    "fault_link": ("part_degrees", "swap_deltas", "hop_cost"),
    "sweep": ("part_degrees", "swap_deltas", "replay_screen", "hop_cost"),
    # A sharded level refines on the host: no degree kernel, no device
    # selection.
    "sharded_cut": (),
    "sharded_stream": (),
    "sharded_volume": (),
    # The island SA is torch ops (graphed epochs), with no polish.
    "island": ("part_degrees", "replay_screen", "hop_cost"),
    # The layout search is host numpy (torus distances).
    "layout": (),
    # The engine cases: the unicast and multicast replays' screens, the
    # SA's scorer and the vec refiner's two degree kernels.
    "engines": ("part_degrees", "connectivity_degrees", "swap_deltas",
                "link_loads", "replay_screen"),
    # The LLM serving and training paths are torch ops (matmuls, the
    # chunked softmax, autograd, AdamW); no TPU kernel lies on them.
    "serve": (),
    "train": (),
    # The ranks' serving and island runs are torch ops and collectives;
    # the parent recomputes the islands' hop cost on the card.
    "ranks": ("hop_cost",),
}
SHARDED_RUNS = ("sharded_cut", "sharded_stream", "sharded_volume")
FAULT_RUNS = ("fault_zero", "fault_incremental", "fault_scratch", "fault_link")


def slice_config(run: str, device: str, screen: str, stepper: str = "jax"):
    """The ToolchainConfig of slice run ``run``: "cut", "volume",
    "device" (``stepper`` is its stepper), a baseline ("spinemap", "sco":
    the cut run's platform and replay, each method's own searches) or a
    fault run (the cut run's configuration on the numpy screen and
    stepper, which a replay under faults requires)."""
    from repro_torch.core import ToolchainConfig

    objective = "volume" if run == "volume" else "cut"
    noc_kwargs = {"screen": screen}
    mapper, mapper_kwargs = "sa", {"impl": "vec"}
    if run == "cut" or run in FAULT_RUNS:
        # The tree placement objective (volume's default) has no device
        # scorer: score_backend="auto" is the pairwise objective's.
        mapper_kwargs["score_backend"] = "auto"
    if run == "device":
        mapper, mapper_kwargs = "sa_jax", {}
        noc_kwargs["stepper"] = stepper
    if run == "island":
        mapper, mapper_kwargs = "island", {}  # the reference's defaults
        noc_kwargs["stepper"] = "jax"
    if run in ("spinemap", "sco"):
        mapper_kwargs = {}  # PSO's own defaults; SCO runs no search
    if run in FAULT_RUNS:
        noc_kwargs = {"screen": "numpy", "stepper": "numpy"}
    return ToolchainConfig(
        method=run if run in ("spinemap", "sco") else "sneap",
        mesh_w=SLICE["mesh_w"], mesh_h=SLICE["mesh_h"],
        capacity=SLICE["capacity"], seed=SLICE["seed"],
        partition_impl="vec", objective=objective, mapper=mapper,
        mapper_kwargs=mapper_kwargs, noc_mode="queued",
        noc_kwargs=noc_kwargs, device=device)


def slice_traffic(prof, res, run: str, device: str = "cuda"):
    """The run's (k, k) traffic matrix (host numpy)."""
    from repro_torch.core.pipeline import build_traffic

    cfg = slice_config(run, device, "linkload").resolve(prof.graph.hyper)
    return build_traffic(prof, res.partition, cfg)


def hop_cost_of(prof, part, k: int, placement, cast: str = "unicast",
                device: str = "cuda") -> float:
    """avg_hop of a mapping recomputed on the hop_cost kernel: the total
    hop cost of its traffic at the placed coordinates over its packet
    count."""
    import numpy as np
    import torch

    from repro_torch.core import traffic_matrix
    from repro_torch.kernels.hop_eval import hop_cost

    traffic = traffic_matrix(part, prof.trace_src, prof.trace_dst, k,
                             trace_t=prof.trace_t, cast=cast)
    place = np.asarray(placement, dtype=np.int64)[:k]
    x = torch.tensor(place % SLICE["mesh_w"], dtype=torch.float32, device=device)
    y = torch.tensor(place // SLICE["mesh_w"], dtype=torch.float32, device=device)
    total = hop_cost(torch.tensor(traffic, dtype=torch.float32, device=device),
                     x, y)
    return float(total) / max(int(traffic.sum()), 1)


def placement_hop_cost(prof, res, device: str = "cuda") -> float:
    """avg_hop of a finished run recomputed on the hop_cost kernel."""
    return hop_cost_of(prof, res.partition.part, res.partition.k,
                       res.mapping.placement, res.cast, device)


def run_slice(run: str, prof=None, device: str = "cuda", remaps=None,
              **toolchain_kw):
    """One slice run of the main path, through the entry points a user
    calls: the profile (unless given), the toolchain, and the final
    placement's total hop cost on the hop_cost kernel — a fault run's last
    re-map's (``remaps``, filled by a `RemapSpy`) where it re-mapped."""
    from repro_torch.core import run_toolchain
    from repro_torch.snn import make_snn, profile_snn

    profile_s = 0.0
    if prof is None:
        t0 = time.perf_counter()
        prof = profile_snn(make_snn(SLICE["snn"]), num_steps=SLICE["num_steps"],
                           seed=SLICE["seed"], device=device)
        profile_s = time.perf_counter() - t0
    res = run_toolchain(prof, config=slice_config(run, device, "linkload"),
                        **toolchain_kw)
    if remaps:
        last = remaps[-1]
        hop = hop_cost_of(prof, last.part, last.k, last.placement, res.cast,
                          device)
    else:
        hop = placement_hop_cost(prof, res, device)
    return prof, res, profile_s, hop


def check_result(prof, res, objective: str, hop: float,
                 device: str = "cuda") -> None:
    import numpy as np

    from repro_torch.core import (comm_volume, edge_cut, evaluate_phase,
                                  partition_phase)
    from repro_torch.core.graph import validate_partition
    from repro_torch.core.pipeline import build_traffic

    pres = res.partition
    for key, want in EXPECT[objective].items():
        got = res.summary()[key]
        if got != want:
            fail(f"{objective}: {key} = {got!r}, expected {want!r}")
    validate_partition(prof.graph, pres.part, pres.k, SLICE["capacity"])
    if edge_cut(prof.graph, pres.part) != pres.edge_cut:
        fail(f"{objective}: edge_cut does not match a recount of the partition")
    if (objective == "volume"
            and comm_volume(prof.graph.hyper, pres.part) != pres.comm_volume):
        fail("volume: comm_volume does not match a recount of the partition")
    if not np.isfinite(res.mapping.avg_hop) or res.mapping.avg_hop <= 0:
        fail(f"{objective}: avg_hop is not a positive finite number: "
             f"{res.mapping.avg_hop}")
    if not np.isclose(hop, res.mapping.avg_hop, rtol=1e-6, atol=0.0):
        fail(f"{objective}: hop_cost / trace_len = {hop!r} differs from "
             f"avg_hop = {res.mapping.avg_hop!r} beyond rtol 1e-6")
    placement = np.asarray(res.mapping.placement)
    if np.unique(placement).shape[0] != pres.k:
        fail(f"{objective}: placement is not one distinct core per partition")
    # Every packet of the run's traffic model is delivered once: over the
    # NoC or locally (one per transmission under unicast, one per
    # (firing, destination partition) under multicast).
    cfg = slice_config(objective, device, "numpy")
    packets = int(build_traffic(prof, pres, cfg.resolve(prof.graph.hyper)).sum())
    noc = res.noc
    if noc.num_noc_spikes + noc.num_local_spikes != packets:
        fail(f"{objective}: NoC stats lose packets: noc + local != {packets}")
    if objective == "cut" and packets != prof.num_spikes:
        fail("cut: unicast packets != trace length")
    if not np.isfinite(noc.avg_latency) or noc.avg_latency < noc.avg_hop:
        fail(f"{objective}: average latency is below the average hop count")
    # The screen never changes results (the reference's promise).
    numpy_screen = evaluate_phase(prof, pres, res.mapping, cfg)
    for f in dataclasses.fields(noc):
        a, b = getattr(noc, f.name), getattr(numpy_screen, f.name)
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        if not same:
            fail(f"{objective}: NoCStats.{f.name} differs between the "
                 f"linkload and numpy screens")
    # The device never changes the partition.
    cpu = partition_phase(prof, slice_config(objective, "cpu", "numpy"))
    if (not np.array_equal(cpu.part, pres.part) or cpu.edge_cut != pres.edge_cut
            or cpu.comm_volume != pres.comm_volume):
        fail(f"{objective}: the CPU re-partition differs from the card's")


# Device-side names of the redesigned kernels, for per-launch times on
# the slice runs.
DEVICE_SYMBOLS = {"lif_step": "lif_step_kernel",
                  "swap_deltas": "swap_deltas_kernel",
                  "connectivity_degrees": "volume_degree_rows_kernel",
                  "link_loads": "link_loads_kernel",
                  "replay_screen": "replay_screen_kernel",
                  "volume_select": "volume_select_kernel",
                  "hop_cost": "hop_cost_kernel"}
# Launches each slice run must make exactly: one fused LIF launch a
# profiled step; for a replay on the link-load screen one replay_screen
# launch (unicast: both screens) or one link_loads launch (multicast: the
# loads), and none under faults (the numpy screen); one hop_cost launch
# for the final placement's total; the sweep's four rows one each.
UNICAST = {"link_loads": 0, "replay_screen": 1}
EXACT_LAUNCHES = {"cut": {"lif_step": SLICE["num_steps"], **UNICAST,
                          "hop_cost": 1},
                  "volume": {"lif_step": 0, "link_loads": 1,
                             "replay_screen": 0, "hop_cost": 1},
                  "device": {"lif_step": 0, **UNICAST, "hop_cost": 1},
                  "spinemap": {"lif_step": 0, "part_degrees": 0, **UNICAST,
                               "hop_cost": 1},
                  "sco": {"lif_step": 0, "part_degrees": 0, **UNICAST,
                          "hop_cost": 1},
                  **{run: {"lif_step": 0, "link_loads": 0, "replay_screen": 0,
                           "hop_cost": 1}
                     for run in FAULT_RUNS},
                  "sweep": {"lif_step": 0, "link_loads": 0,
                            "replay_screen": 4, "hop_cost": 4},
                  **{run: {name: 0 for name in
                           ("lif_step", "part_degrees", "connectivity_degrees",
                            "volume_select", "swap_deltas", "link_loads",
                            "replay_screen", "hop_cost")}
                     for run in SHARDED_RUNS + ("layout", "serve", "train",
                                                "roofline")},
                  "island": {"lif_step": 0, "swap_deltas": 0, **UNICAST,
                             "hop_cost": 1},
                  "engines": {"lif_step": 0, "hop_cost": 0},
                  "ranks": {"lif_step": 0, "part_degrees": 0,
                            "connectivity_degrees": 0, "swap_deltas": 0,
                            "link_loads": 0, "replay_screen": 0,
                            "hop_cost": 1}}


# `torch.cuda._sleep`'s kernel, launched last in every traced run: a trace
# without it lost its tail.
END_MARKER = "spin_kernel"


def device_total(busy, key_part: str) -> tuple[float, int]:
    """Summed device microseconds and call count of the profiler entries
    whose name contains ``key_part``."""
    hits = [(us, count) for us, count, key in busy if key_part in key]
    return sum(h[0] for h in hits), sum(h[1] for h in hits)


TRACE_ATTEMPTS = 3


def traced(run: str, counters: dict, drive, report=None, reset=None):
    """Call ``drive()`` with every launch count set to 0 just before and
    read just after, under device-only tracing (kernels, copies, fills),
    which gives the card's busy time without timing any host op.  Prints
    the busy share and the kernels' device times, then ``report(out)``;
    fails where a kernel of the run's path did not launch or a count
    differs from ``EXACT_LAUNCHES``.  Where the profiler's counts differ
    from ``EXACT_LAUNCHES`` (the trace lost events), the run is driven
    again, up to ``TRACE_ATTEMPTS`` times in all, calling ``reset()``
    first where given, and the last attempt is held to both.  Returns
    drive's result and the launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_ATTEMPTS + 1):
        if reset is not None and attempt > 1:
            reset()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        with profile(activities=[ProfilerActivity.CUDA]) as trace:
            t0 = time.perf_counter()
            out = drive()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda._sleep(1)  # END_MARKER: the trace's last device event
            torch.cuda.synchronize()
        events = trace.key_averages()
        launches = {name: getattr(mod, attr)
                    for name, (mod, attr) in counters.items()}
        busy = sorted(((getattr(e, "self_device_time_total", 0.0), e.count, e.key)
                       for e in events if END_MARKER not in e.key), reverse=True)
        busy_s = sum(b[0] for b in busy) / 1e6
        seen = {name: device_total(busy, symbol)[1]
                for name, symbol in DEVICE_SYMBOLS.items()}
        differs = busy_s > 0 and any(
            name in seen and seen[name] != want
            for name, want in EXACT_LAUNCHES[run].items())
        if not differs:
            break
        # Seen on the H100: the trace lost every event after the run's
        # first seconds, its end marker too; and once it lost a run's
        # single hop_cost launch with the end marker kept.
        tail = ("kept" if any(END_MARKER in e.key for e in events)
                else "lost")
        lost = {name: seen[name] for name in EXACT_LAUNCHES[run]
                if name in seen and seen[name] != EXACT_LAUNCHES[run][name]}
        print(f"{run}: attempt {attempt}: the profiler's trace saw "
              f"{json.dumps(lost)} (end marker {tail}); "
              f"{'running again' if attempt < TRACE_ATTEMPTS else 'held as it is'}")
    print(f"{run} slice device: busy {busy_s:.4f} s of {wall:.3f} s "
          f"wall ({100 * busy_s / wall:.2f}% busy)")
    for us, count, key in busy[:8]:
        print(f"{run} slice device time {us / 1e3:.3f} ms over {count} "
              f"calls: {key[:90]}")
    for name, symbol in DEVICE_SYMBOLS.items():
        us, count = device_total(busy, symbol)
        per = f"{us / count:.3f} us a launch" if count else "no launch"
        print(f"{run} slice kernel {name}: {count} launches, "
              f"{us / 1e3:.3f} ms device, {per}")
    us, count = device_total(busy, "Memcpy HtoD")
    print(f"{run} slice host-to-device copies: {count} copies, "
          f"{us / 1e3:.3f} ms device")
    if report is not None:
        report(out)
    print(f"{run} slice launches:", json.dumps(launches))
    for name in PATHS[run]:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the {run} slice run")
    for name, want in EXACT_LAUNCHES[run].items():
        if launches[name] != want:
            fail(f"{run}: {name} launched {launches[name]} times, not {want}")
        if busy_s > 0 and name in seen and seen[name] != want:
            fail(f"{run}: the profiler saw {seen[name]} {name} launches, "
                 f"not {want}")
    return out, launches


def traced_run(run: str, counters: dict, prof=None, reset=None, **run_kw):
    """One slice run (`run_slice`) under `traced`, printing its summary."""

    def report(out):
        prof, res, profile_s, hop = out
        if profile_s:
            print(f"{run} slice: profile {profile_s:.2f} s, "
                  f"{prof.num_neurons} neurons, {prof.num_steps} steps kept, "
                  f"{prof.num_spikes} transmissions")
        print(f"{run} slice summary:", json.dumps(res.summary()))
        print(f"{run} slice phase_seconds:", json.dumps(res.phase_seconds))
        print(f"{run} slice hop_cost / trace_len: {hop!r} "
              f"(avg_hop {res.mapping.avg_hop!r})")

    (prof, res, _, hop), launches = traced(
        run, counters, lambda: run_slice(run, prof, **run_kw), report, reset)
    return prof, res, hop, launches


def stepper_spans(stepper: str = "jax") -> dict:
    """The calls, packets, cycles (the last arrival) and seconds of the
    replay's joint stepper (``stepper``: the torch one or the numpy one),
    read from its ``sneap.replay.stepper`` spans in the program's buffer
    (record them under ``repro_torch.spans.recording()``)."""
    from repro_torch import spans

    runs = [s for s in spans.spans() if s.name == "sneap.replay.stepper"
            and s.attrs["stepper"] == stepper]
    return {"calls": len(runs),
            "packets": sum(s.attrs["packets"] for s in runs),
            "cycles": max((s.attrs["cycles"] for s in runs), default=0),
            "seconds": sum(s.seconds for s in runs)}


def same_stats(a, b) -> list[str]:
    """Names of the NoCStats fields that differ between a and b."""
    import numpy as np

    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if not (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y):
            out.append(f.name)
    return out


def check_device_run(prof, cut, res, hop, launches, spy) -> None:
    """The device run (population SA + polish, torch stepper) against the
    cut run and the numpy stepper; prints both steppers' evaluate seconds."""
    import numpy as np
    import torch

    from repro_torch import spans
    from repro_torch.core import evaluate_phase
    from repro_torch.kernels.swap_delta import swap_deltas

    pres = res.partition
    if (pres.k, pres.edge_cut) != (EXPECT["cut"]["k"], EXPECT["cut"]["edge_cut"]) \
            or not np.array_equal(pres.part, cut.partition.part):
        fail("device: the partition differs from the cut run's")
    placement = np.asarray(res.mapping.placement, dtype=np.int64)
    if placement.shape[0] != pres.k or np.unique(placement).shape[0] != pres.k:
        fail("device: placement is not one distinct core per partition")
    bound = DEVICE_HOP_BOUND * cut.mapping.avg_hop
    if not res.mapping.avg_hop <= bound:
        fail(f"device: avg_hop {res.mapping.avg_hop!r} exceeds "
             f"{DEVICE_HOP_BOUND} x the cut run's ({bound!r})")
    if not np.isclose(hop, res.mapping.avg_hop, rtol=1e-6, atol=0.0):
        fail(f"device: hop_cost / trace_len = {hop!r} differs from avg_hop = "
             f"{res.mapping.avg_hop!r} beyond rtol 1e-6")
    # The polish's end: no swap of the padded 256-core permutation (the
    # placed cores, then the free ones) improves under the card's deltas.
    cores = SLICE["mesh_w"] * SLICE["mesh_h"]
    full = np.concatenate([placement, np.setdiff1d(np.arange(cores), placement)])
    traffic = np.zeros((cores, cores), dtype=np.float32)
    traffic[:pres.k, :pres.k] = slice_traffic(prof, res, "device")
    sym = torch.tensor(traffic + traffic.T, device="cuda")
    x = torch.tensor(full % SLICE["mesh_w"], dtype=torch.float32, device="cuda")
    y = torch.tensor(full // SLICE["mesh_w"], dtype=torch.float32, device="cuda")
    deltas = swap_deltas(sym, x, y)
    deltas.fill_diagonal_(float("inf"))
    best = float(deltas.min())
    if best < -1e-6:
        fail(f"device: the polish did not end at a swap-local optimum "
             f"(best swap delta {best})")
    print(f"device slice polish: {launches['swap_deltas']} swap_deltas "
          f"launches; best swap delta at its end {best}")
    # The torch stepper against the numpy stepper, same placement, untraced.
    steppers = {}
    for stepper in ("jax", "numpy"):
        cfg = slice_config("device", "cuda", "linkload", stepper=stepper)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spans.clear()
        with spans.recording():
            steppers[stepper] = evaluate_phase(prof, pres, res.mapping, cfg)
        torch.cuda.synchronize()
        timing = stepper_spans(stepper)
        print(f"device slice evaluate with stepper={stepper!r}: "
              f"{time.perf_counter() - t0:.3f} s, of which the stepper "
              f"{timing['seconds']:.3f} s ({timing['packets']} packets, "
              f"{timing['cycles']} cycles)")
    bad = same_stats(steppers["jax"], steppers["numpy"]) + same_stats(
        res.noc, steppers["numpy"])
    if bad:
        fail(f"device: NoCStats {sorted(set(bad))} differ between the torch "
             f"and the numpy stepper")
    if spy["calls"] < 1 or spy["packets"] <= 0:
        fail("device: the torch stepper stepped no packet")
    print(f"device slice stepper: {spy['packets']} packets stepped over "
          f"{spy['cycles']} cycles ({spy['calls']} calls); congestion "
          f"{res.noc.congestion_count}")


def check_expect(run: str, values: dict) -> None:
    for key, want in EXPECT[run].items():
        if values[key] != want:
            fail(f"{run}: {key} = {values[key]!r}, expected {want!r}")


def seconds_line(name: str, res) -> str:
    ph = res.phase_seconds
    return (f"{name}: partition {ph['partition']:.3f} s, mapping "
            f"{ph['mapping']:.3f} s, evaluate {ph['evaluate']:.3f} s, total "
            f"{res.total_seconds:.3f} s")


def baseline_runs(prof, cut, counters) -> dict:
    """SpiNeMap and SCO through `run_toolchain` on the cut run's profile,
    platform and replay, held to the reference's numbers and to the
    paper's orderings; prints each run's phase seconds beside SNEAP's."""
    import numpy as np

    from repro_torch.core.graph import validate_partition

    launches, runs = {}, {}
    for run in ("spinemap", "sco"):
        _, res, hop, launches[run] = traced_run(run, counters, prof)
        check_expect(run, res.summary())
        pres = res.partition
        validate_partition(prof.graph, pres.part, pres.k, SLICE["capacity"])
        placement = np.asarray(res.mapping.placement)
        if np.unique(placement).shape[0] != pres.k:
            fail(f"{run}: placement is not one distinct core per partition")
        if not np.isclose(hop, res.mapping.avg_hop, rtol=1e-6, atol=0.0):
            fail(f"{run}: hop_cost / trace_len = {hop!r} differs from "
                 f"avg_hop = {res.mapping.avg_hop!r} beyond rtol 1e-6")
        if res.noc.num_noc_spikes + res.noc.num_local_spikes != prof.num_spikes:
            fail(f"{run}: NoC stats lose packets")
        runs[run] = res
    cuts = [r.partition.edge_cut for r in (cut, runs["spinemap"], runs["sco"])]
    if not cuts[0] <= cuts[1] <= cuts[2]:
        fail(f"the cut ordering sneap <= spinemap <= sco fails: {cuts}")
    if not cut.mapping.avg_hop < runs["sco"].mapping.avg_hop:
        fail("sneap's avg_hop is not below sco's")
    print("toolchain seconds on the card, " + "; ".join(
        seconds_line(n, r) for n, r in
        (("sneap", cut), ("spinemap", runs["spinemap"]), ("sco", runs["sco"]))))
    return launches


class RemapSpy:
    """While installed, records each re-map's result, seconds and the
    part_degrees launches it made (the fault scenario driver calls the
    re-mappers through `repro_torch.core.pipeline`); changes nothing
    else."""

    NAMES = ("incremental_remap", "scratch_remap")

    def __init__(self):
        from repro_torch.core import pipeline
        from repro_torch.kernels.gain_eval import kernel as gain_eval

        self.pipeline, self.gain_eval = pipeline, gain_eval
        self.inner = {n: getattr(pipeline, n) for n in self.NAMES}
        self.results = []
        self.part_degrees = 0

    def reset(self):
        """Forget what was recorded (before the run is driven again)."""
        self.results.clear()
        self.part_degrees = 0

    def _wrap(self, fn):
        def remap(*args, **kwargs):
            before = self.gain_eval.launches
            res = fn(*args, **kwargs)
            self.part_degrees += self.gain_eval.launches - before
            self.results.append(res)
            return res
        return remap

    def __enter__(self):
        for name, fn in self.inner.items():
            setattr(self.pipeline, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.pipeline, name, fn)


def fault_runs(prof, cut, counters) -> dict:
    """The cut run's configuration under four fault schedules: none (must
    equal the fault-free run), a mid-trace core failure re-mapped both
    ways, and random link failures (re-routed, never re-mapped); held to
    the reference's numbers.  No re-map may leave a real partition on a
    dead core."""
    import numpy as np

    from repro_torch.core import partition_weights
    from repro_torch.runtime import FaultEvent, FaultSchedule

    t_end = prof.num_steps
    victims = tuple(int(c) for c in cut.mapping.placement[:FAULT_VICTIMS])
    core = FaultSchedule([FaultEvent(t_end // 2, "core", victims)])
    schedules = {
        "fault_zero": (FaultSchedule([]), "incremental"),
        "fault_incremental": (core, "incremental"),
        "fault_scratch": (core, "scratch"),
        "fault_link": (FaultSchedule.random(
            SLICE["mesh_w"], SLICE["mesh_h"], 0, t_end, n_link_faults=8,
            seed=2), "incremental"),
    }
    print(f"fault runs: core failure of {victims} at window {t_end // 2}; "
          f"link schedule {[(e.t, e.ids[0]) for e in schedules['fault_link'][0].events]}")
    launches = {}
    for run, (sched, strategy) in schedules.items():
        with RemapSpy() as spy:
            _, res, hop, launches[run] = traced_run(
                run, counters, prof, reset=spy.reset, remaps=spy.results,
                fault_schedule=sched, remap_strategy=strategy)
        deg = res.degradation
        check_expect(run, {**res.summary(), "final_k": deg["final_k"]})
        if len(spy.results) != deg["remap_events"]:
            fail(f"{run}: {len(spy.results)} re-maps seen, "
                 f"{deg['remap_events']} reported")
        noc = res.noc
        if (noc.num_noc_spikes + noc.num_local_spikes + noc.spikes_dropped
                != prof.num_spikes):
            fail(f"{run}: the segmented replay loses spikes")
        dead = sched.state_at(t_end, SLICE["mesh_w"], SLICE["mesh_h"]).dead_cores
        for r in spy.results:
            w = partition_weights(prof.graph, r.part, r.k)
            if dead[r.placement[:r.k][w > 0]].any():
                fail(f"{run}: a re-map left a real partition on a dead core")
        final = spy.results[-1].mapping if spy.results else res.mapping
        if not np.isclose(hop, final.avg_hop, rtol=1e-6, atol=0.0):
            fail(f"{run}: hop_cost / trace_len = {hop!r} differs from the "
                 f"final mapping's avg_hop = {final.avg_hop!r}")
        if run == "fault_zero":
            bad = same_stats(res.noc, cut.noc)
            if bad:
                fail(f"fault_zero: NoCStats {bad} differ from the fault-free run")
        if run == "fault_scratch" and spy.part_degrees <= 0:
            fail("fault_scratch: the scratch re-map launched no part_degrees")
        ph = res.phase_seconds
        print(f"{run}: remap_s {ph['remap']:.4f}, evaluate "
              f"{ph['evaluate']:.3f} s, scenario {ph['scenario']:.4f} s; "
              f"{deg['remap_events']} re-maps ({deg['remap_strategy']}), "
              f"part_degrees launches in the re-map {spy.part_degrees}; "
              f"degradation {json.dumps(deg)}")
    return launches


def sweep_run(prof, cut, counters) -> dict:
    """`run_sweep` over seeds {0, 1} x mappers {sa_jax, sa} on the cut
    run's platform with the torch stepper: partitions shared, the two
    sa_jax searches one batched device program.  The sa row of seed 0
    must equal the cut run; each sa_jax row's placement must equal a
    single `sa_search_jax` on the card, bitwise."""
    import numpy as np
    import torch

    from repro_torch.core import phase_seeds
    from repro_torch.core.mapping_device import sa_search_jax, sa_search_jax_batch
    from repro_torch.core.pipeline import build_traffic
    from repro_torch.launch import config_grid, run_sweep

    common = dict(seed=[0, 1], mesh=[(SLICE["mesh_w"], SLICE["mesh_h"])],
                  capacity=SLICE["capacity"], partition_impl="vec",
                  objective="cut", screen="linkload", stepper="jax",
                  device="cuda")
    # The cut run's SA settings are the batched SA's; sa_jax takes its own.
    grid = (config_grid(mapper="sa_jax", **common)
            + config_grid(mapper="sa", mapper_kwargs={"impl": "vec",
                                                      "score_backend": "auto"},
                          **common))
    msgs = []

    def drive():
        sweep = run_sweep(prof, grid, progress=msgs.append)
        return sweep, [placement_hop_cost(prof, r) for r in sweep.results]

    def report(out):
        sweep, _ = out
        for m in msgs:
            print(f"sweep: {m}")
        for row in sweep.rows:
            print("sweep row:", json.dumps(row))
        print(f"sweep: {sweep.seconds:.3f} s for {len(sweep.rows)} configs")

    (sweep, hops), launches = traced("sweep", counters, drive, report,
                                     msgs.clear)
    if f"{prof.name}: 2 partition runs for 4 configs" not in msgs:
        fail(f"sweep: partition dedup did not give 2 runs for 4 configs: {msgs}")
    for row, res, hop in zip(sweep.rows, sweep.results, hops):
        if not np.isclose(hop, row["avg_hop"], rtol=1e-6, atol=0.0):
            fail(f"sweep: hop_cost / trace_len = {hop!r} differs from the "
                 f"row's avg_hop = {row['avg_hop']!r}")
    sa0 = [r for r in sweep.rows if r["mapper"] == "sa" and r["seed"] == 0][0]
    for key, want in cut.summary().items():
        if not key.endswith("_s") and sa0[key] != want:
            fail(f"sweep: the sa row of seed 0 has {key} = {sa0[key]!r}, the "
                 f"cut run {want!r}")
    # The bucket again, alone, and the two single searches it replaces, on
    # the same traffic: the placements must be the sweep's, bitwise.
    jax_rows = [(cfg, res) for cfg, res in zip(grid, sweep.results)
                if cfg.mapper == "sa_jax"]
    traffics = [build_traffic(prof, res.partition, cfg.resolve(prof.graph.hyper))
                for cfg, res in jax_rows]
    seeds = [phase_seeds(cfg.seed)[1] for cfg, _ in jax_rows]
    lengths = [int(t.sum()) for t in traffics]
    cores = SLICE["mesh_w"] * SLICE["mesh_h"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = sa_search_jax_batch(traffics, cores, SLICE["mesh_w"], lengths,
                                seeds, device="cuda")
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    single_s = 0.0
    for (cfg, res), traffic, length, seed, b in zip(jax_rows, traffics, lengths,
                                                    seeds, batch):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single = sa_search_jax(traffic, cores, SLICE["mesh_w"], length,
                               seed=seed, device="cuda")
        torch.cuda.synchronize()
        single_s += time.perf_counter() - t0
        for name, got in (("sweep", res.mapping), ("batch", b)):
            if not np.array_equal(single.placement, got.placement):
                fail(f"sweep: the {name} sa_jax placement of seed {cfg.seed} "
                     f"differs from the single search's")
        if res.mapping.avg_hop > DEVICE_HOP_BOUND * cut.mapping.avg_hop:
            fail(f"sweep: sa_jax avg_hop {res.mapping.avg_hop!r} exceeds "
                 f"{DEVICE_HOP_BOUND} x the cut run's")
    in_sweep = sum(res.mapping.seconds for _, res in jax_rows)
    print(f"sweep: the sa_jax bucket of 2 configs {batch_s:.3f} s "
          f"({in_sweep:.3f} s inside the sweep) against {single_s:.3f} s for "
          f"two single sa_search_jax calls; placements bitwise equal")
    return launches


def sharded_runs(prof, cut, vol, counters) -> dict:
    """The partition phase of the cut and volume configurations on the
    sharded engine (the cut one also streaming its levels to disk), each
    traced: the reference's partition, bitwise a ``shards=1`` partition on
    the card (kernel path on its levels), and within ``SHARDED_DRIFT`` of
    the unsharded run."""
    import numpy as np

    from repro_torch.core import edge_cut, partition_phase
    from repro_torch.core.graph import validate_partition
    from repro_torch.sharding import plan_vertex_shards

    plan = plan_vertex_shards(prof.graph.num_vertices, SHARDS, device="cuda")
    print(f"sharded runs: {SHARDS} shards of {plan.n} vertices, bounds "
          f"{plan.bounds.tolist()}, devices {plan.devices}; notes {plan.notes}")
    launches, parts = {}, {}
    for run, base, kw in (
            ("sharded_cut", cut, {"shards": SHARDS}),
            ("sharded_stream", cut, {"shards": SHARDS, "stream_levels": True}),
            ("sharded_volume", vol, {"shards": SHARDS})):
        objective = base.partition.objective
        cfg = dataclasses.replace(slice_config(objective, "cuda", "linkload"),
                                  partition_kwargs=kw)

        def report(pres, run=run, base=base):
            print(f"{run} slice partition: {pres.seconds:.3f} s (unsharded "
                  f"{base.phase_seconds['partition']:.3f} s), k {pres.k}, "
                  f"edge_cut {pres.edge_cut}, comm_volume {pres.comm_volume}, "
                  f"{pres.num_levels} levels")

        pres, launches[run] = traced(run, counters,
                                     lambda cfg=cfg: partition_phase(prof, cfg),
                                     report)
        check_expect(run, dict(k=pres.k, edge_cut=pres.edge_cut,
                               comm_volume=pres.comm_volume,
                               part=digest(pres.part)))
        validate_partition(prof.graph, pres.part, pres.k, SLICE["capacity"])
        if edge_cut(prof.graph, pres.part) != pres.edge_cut:
            fail(f"{run}: edge_cut does not match a recount of the partition")
        metric = "edge_cut" if objective == "cut" else "comm_volume"
        ref = getattr(base.partition, metric)
        drift = abs(getattr(pres, metric) - ref) / ref
        if drift > SHARDED_DRIFT:
            fail(f"{run}: {metric} drifts {drift:.2%} from the unsharded run's")
        parts[run] = pres
        print(f"{run}: {metric} {getattr(pres, metric)} against the unsharded "
              f"{ref} ({100 * drift:.2f}% apart)")
    if not np.array_equal(parts["sharded_cut"].part, parts["sharded_stream"].part):
        fail("sharded: the streamed levels' partition differs from in-memory")
    # One shard: the same matching, every level refined on the card's
    # kernel path where its gates hold.  Untraced, not counted.
    for run in ("sharded_cut", "sharded_volume"):
        objective = parts[run].objective
        cfg = dataclasses.replace(slice_config(objective, "cuda", "linkload"),
                                  partition_kwargs={"shards": 1})
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        one = partition_phase(prof, cfg)
        kernel = "part_degrees" if objective == "cut" else "connectivity_degrees"
        mod, attr = counters[kernel]
        if not np.array_equal(one.part, parts[run].part):
            fail(f"{run}: the sharded partition differs from shards=1's")
        if getattr(mod, attr) <= 0:
            fail(f"{run}: the shards=1 partition launched no {kernel}")
        print(f"{run}: bitwise the shards=1 partition on the card "
              f"({one.seconds:.3f} s, {getattr(mod, attr)} {kernel} launches)")
    return launches


def island_run(prof, cut, counters) -> tuple[dict, dict]:
    """``run_toolchain(mapper="island")`` with the reference's defaults and
    the torch stepper, traced: the cut run's partition, an injective
    placement within ``ISLAND_HOP_BOUND`` of the cut run's avg_hop, and
    the same placement from the same seed again.  Returns the launches
    and the search's traffic, seed and placement (for `ranks_phase`)."""
    import numpy as np
    import torch

    from repro_torch.core import phase_seeds
    from repro_torch.core.mapping import MAPPERS

    _, res, hop, launches = traced_run("island", counters, prof)
    pres = res.partition
    if not np.array_equal(pres.part, cut.partition.part):
        fail("island: the partition differs from the cut run's")
    placement = np.asarray(res.mapping.placement, dtype=np.int64)
    if placement.shape[0] != pres.k or np.unique(placement).shape[0] != pres.k:
        fail("island: placement is not one distinct core per partition")
    if not np.isclose(hop, res.mapping.avg_hop, rtol=1e-6, atol=0.0):
        fail(f"island: hop_cost / trace_len = {hop!r} differs from avg_hop = "
             f"{res.mapping.avg_hop!r} beyond rtol 1e-6")
    bound = ISLAND_HOP_BOUND * cut.mapping.avg_hop
    if not res.mapping.avg_hop <= bound:
        fail(f"island: avg_hop {res.mapping.avg_hop!r} exceeds "
             f"{ISLAND_HOP_BOUND} x the cut run's ({bound!r})")
    traffic = slice_traffic(prof, res, "island")
    seed = phase_seeds(SLICE["seed"])[1]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = MAPPERS["island"](traffic, SLICE["mesh_w"] * SLICE["mesh_h"],
                              SLICE["mesh_w"], int(traffic.sum()), seed=seed,
                              device="cuda")
    again_s = time.perf_counter() - t0
    if not np.array_equal(again.placement, placement):
        fail("island: the same seed gave another placement")
    print(f"island slice: avg_hop {res.mapping.avg_hop!r} (cut run "
          f"{cut.mapping.avg_hop!r}); {res.mapping.evaluations} evaluations, "
          f"search {res.mapping.seconds:.3f} s traced, {again_s:.3f} s "
          f"untraced with the same placement")
    return launches, {"traffic": traffic, "seed": seed, "placement": placement,
                      "seconds": again_s}


def layout_runs(counters) -> dict:
    """`sneap_device_layout` of ``LAYOUTS``, traced: the reference's
    results, each order a permutation of the live chips, and the
    all-to-all layout 5% below the row-major one."""
    from repro_torch.sharding import sneap_device_layout

    def drive():
        out = {}
        for name, (shape, axis_bytes, kw) in LAYOUTS.items():
            t0 = time.perf_counter()
            out[name] = (*sneap_device_layout(shape, axis_bytes, device="cuda",
                                               **kw),
                         time.perf_counter() - t0)
        return out

    def report(out):
        for name, (order, base, opt, secs) in out.items():
            print(f"{name}: {secs:.3f} s, row-major avg_hop {base!r}, "
                  f"optimized {opt!r} ({100 * (1 - opt / base):.2f}% lower)")

    out, launches = traced("layout", counters, drive, report)
    for name, (order, base, opt, _) in out.items():
        check_expect(name, dict(order=digest(order), base=base, optimized=opt))
        dead = LAYOUTS[name][2].get("dead_chips", [])
        alive = [c for c in range(order.shape[0] + len(dead)) if c not in dead]
        if sorted(order.tolist()) != alive:
            fail(f"{name}: the order is not a permutation of the live chips")
    base, opt = out["layout_alltoall"][1:3]
    if not opt < 0.95 * base:
        fail(f"layout_alltoall: optimized {opt!r} is not 5% below {base!r}")
    return {"layout": launches}


# The engine cases of the reference's suites that the slice runs do not
# reach (tests/test_torch_cuda_engines.py holds more of them under pytest).
ENGINE_TRACE = dict(n_spikes=1500, timesteps=8)  # test_nocsim_engines' trace
ENGINE_SA = dict(k=15, seed=3, iters=1500, batch=32)  # K = 15 on a 5x5 mesh
ENGINE_REFINE = dict(n=400, k=40, cap=12, seed=0)  # test_volume_engines' graph
ENGINE_BUDGET_S = 30.0


def engine_trace(seed: int, n_spikes: int, timesteps: int):
    """tests/conftest.py's ``random_spike_trace`` (30 neurons, 6 partitions
    placed on a 3x3 mesh): (t, src, dst, part, placement)."""
    import numpy as np

    r = np.random.default_rng(seed)
    part = r.integers(0, 6, 30)
    placement = r.permutation(9)[:6]
    t = np.sort(r.integers(0, timesteps, n_spikes))
    src = r.integers(0, 30, n_spikes)
    dst = r.integers(0, 30, n_spikes)
    return t, src, dst, part, placement


def engine_fanout(n: int, seed: int, fan: int = 10, max_fire: int = 20):
    """tests/conftest.py's ``fanout_snn_graph`` with the port's builders."""
    import numpy as np

    from repro_torch.core.graph import build_graph, build_hypergraph

    r = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), fan)
    dst = r.integers(0, n, n * fan)
    fire = r.integers(1, max_fire, n)
    g = build_graph(n, src, dst, fire[src])
    g.hyper = build_hypergraph(n, src, dst, fire)
    return g


def engines_phase(counters) -> dict:
    """The engine cases the slice runs do not reach, on the card, traced:
    congested unicast replays (link capacity 1 and 2) and a multicast-tree
    replay on the link-load screen with the torch stepper, the vec SA
    scored by swap_deltas at K = 15 on a 5x5 mesh, and ``refine_level_vec``
    on the kernel path on a fan-out hypergraph in cut and volume mode.
    Each is held against the port's CPU run of the same inputs (bitwise:
    every NoCStats field, placements, SA history costs, partitions and
    scores); the replays also against the scalar engine (the replica
    engine for multicast, whose latency the tree must beat)."""
    import numpy as np
    import torch

    from repro_torch.core.initpart import greedy_region_growing
    from repro_torch.core.mapping import sa_search
    from repro_torch.core.refine_vec import refine_level_vec
    from repro_torch.nocsim import simulate_noc

    trace = (*engine_trace(0, **ENGINE_TRACE), 3, 3)

    def replay(cap: int, cast: str):
        return lambda dev: simulate_noc(*trace, link_capacity=cap, cast=cast,
                                        screen="linkload", stepper="jax",
                                        device=dev)

    rng = np.random.default_rng(ENGINE_SA["seed"])
    traffic = rng.integers(0, 200, (ENGINE_SA["k"],) * 2).astype(np.float64)
    np.fill_diagonal(traffic, 0)

    def sa(dev):
        return sa_search(traffic, 25, 5, int(traffic.sum()), seed=0,
                         iters=ENGINE_SA["iters"], impl="vec",
                         batch=ENGINE_SA["batch"], score_backend="auto",
                         device=dev)

    rk = ENGINE_REFINE
    graph = engine_fanout(rk["n"], rk["seed"])
    start = greedy_region_growing(graph, rk["k"], rk["cap"],
                                  np.random.default_rng(rk["seed"]))

    def refine(objective: str):
        return lambda dev: refine_level_vec(
            graph, start.copy(), rk["k"], rk["cap"], objective=objective,
            use_kernel=True, device=dev)

    cases = {"replay_unicast_cap1": replay(1, "unicast"),
             "replay_unicast_cap2": replay(2, "unicast"),
             "replay_multicast_tree_cap1": replay(1, "multicast"),
             "sa_vec_k15": sa,
             "refine_fanout_cut": refine("cut"),
             "refine_fanout_volume": refine("volume")}

    def drive():
        out = {}
        for name, run in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = run("cuda")
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            host = run("cpu")
            out[name] = (card, host, card_s, time.perf_counter() - t0)
        return out

    def report(out):
        for name, (_, _, card_s, host_s) in out.items():
            print(f"engines {name}: {card_s:.3f} s on the card, {host_s:.3f} s "
                  "on the CPU")

    t0 = time.perf_counter()
    out, launches = traced("engines", counters, drive, report)
    phase_s = time.perf_counter() - t0
    for name in ("replay_unicast_cap1", "replay_unicast_cap2",
                 "replay_multicast_tree_cap1"):
        card, host, _, _ = out[name]
        if same_stats(card, host):
            fail(f"engines {name}: the card's NoCStats differ from the CPU's "
                 f"in {same_stats(card, host)}")
        cap = 1 if name.endswith("cap1") else 2
        cast = "multicast" if "multicast" in name else "unicast"
        ref = simulate_noc(*trace, link_capacity=cap, cast=cast, engine="ref",
                           device="cpu")
        if card.congestion_count <= 0 or not card.avg_latency > card.avg_hop:
            fail(f"engines {name}: the replay did not congest")
        if cast == "unicast" and same_stats(card, ref):
            fail(f"engines {name}: the batched replay differs from the scalar "
                 f"engine in {same_stats(card, ref)}")
        if cast == "multicast" and not (
                card.link_traversals < card.total_hops
                and card.avg_latency < ref.avg_latency
                and np.array_equal(card.per_link_hops, ref.per_link_hops)):
            fail(f"engines {name}: the tree replay is not tighter than the "
                 "replica engine on the same links")
    card, host, _, _ = out["sa_vec_k15"]
    if not (np.array_equal(card.placement, host.placement)
            and card.avg_hop == host.avg_hop
            and [c for _, c in card.history] == [c for _, c in host.history]):
        fail("engines sa_vec_k15: the card's search differs from the CPU's")
    if np.unique(card.placement).shape[0] != ENGINE_SA["k"]:
        fail("engines sa_vec_k15: placement is not injective")
    for name in ("refine_fanout_cut", "refine_fanout_volume"):
        (part, score), (want, want_score), _, _ = out[name]
        if not (np.array_equal(part, want) and score == want_score):
            fail(f"engines {name}: the card's partition or score "
                 f"{score} differs from the CPU's {want_score}")
    print(f"engines phase: {phase_s:.2f} s (budget {ENGINE_BUDGET_S:.0f} s), "
          f"{len(cases)} cases held against the CPU")
    if phase_s > ENGINE_BUDGET_S:
        fail(f"engines phase took {phase_s:.2f} s, over {ENGINE_BUDGET_S} s")
    return {"engines": launches}


def check_profile_raster(prof, dev) -> None:
    """The card's whole profile raster against the CPU path's, bitwise, on
    the inputs ``profile_snn`` builds; its first kept steps must give the
    traced profile's fire counts.  Prints the step loop's own seconds."""
    import numpy as np
    import torch

    from repro_torch.kernels.lif_step import lif_steps, synapses_from_dense
    from repro_torch.snn import LIFParams, lif_run

    steps = SLICE["num_steps"]
    weights, drive_np = lif_inputs(steps)
    params = LIFParams()
    kw = dict(decay=params.decay, threshold=params.threshold,
              v_reset=params.v_reset, refractory=params.refractory)
    syn = synapses_from_dense(torch.from_numpy(weights)).to(dev)
    drive = torch.from_numpy(drive_np).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raster, _, _ = lif_steps(syn, drive, **kw)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    card = raster.cpu().numpy()
    t0 = time.perf_counter()
    cpu = lif_run(torch.from_numpy(weights), torch.from_numpy(drive_np), params)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(card, cpu):
        t, i = np.argwhere(card != cpu)[0]
        fail(f"the card's profile raster differs from the CPU path's "
             f"({int((card != cpu).sum())} entries, first at step {t}, "
             f"neuron {i})")
    if not np.array_equal(card[:prof.num_steps].sum(axis=0), prof.fire_counts):
        fail("the profile's fire counts are not its raster's")
    print(f"profile raster: card == CPU bitwise over {steps} steps "
          f"({int(card.sum())} firings); step loop {loop_s:.4f} s on the card "
          f"({steps} launches), {cpu_s:.2f} s on the CPU path")


# ------------------------------------------------------------- ranks phase

# The rank runs serve qwen3-moe-30b-a3b at its published width (d_model
# 2048, 32 heads, kv 4, 128 experts top-8, moe_d_ff 768, vocab 151,936),
# its depth cut from 48 layers, from a torch.Generator seeded RANKS["seed"]
# on the card; every rank is a process on cuda:0, joined over gloo.
RANKS_ARCH = "qwen3-moe-30b-a3b"
RANKS = dict(batch=4, prompt_len=32, gen_len=8, seed=0)
RANKS_PARITY_LAYERS = 2  # f32, held to the unsharded run
RANKS_TIMING_LAYERS = 4  # bf16, timed on the (1, 2) mesh
RANKS_WORLD = 4
RANKS_TOL = 1e-5  # of max|logit|: only the shard sum's order differs
RANKS_TIMEOUT_S = 300.0  # a collective that waits longer fails the job
RANKS_COLLECTIVES = 50  # all_reduces timed alone


def ranks_config(layers: int, dtype: str):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(RANKS_ARCH), num_layers=layers,
                               param_dtype=dtype, activation_dtype=dtype)


def _expert_leaves(model) -> dict:
    """A model's expert leaves, stacked over its layers as the reference
    stacks them: (L, E_loc, D, F) and (L, E_loc, F, D)."""
    import torch

    return {k: torch.stack([getattr(b.moe, k) for b in model.layers])
            for k in ("w_gate", "w_up", "w_down")}


def _served(res: dict, mesh) -> dict:
    """A serve_batch result as a rank hands it back: its tokens and a hash
    of its logits, and the logits themselves from model coordinate 0."""
    import hashlib

    logits = res["logits"]
    out = {"tokens": res["tokens"], "prefill_s": res["prefill_s"],
           "decode_s_per_tok": res["decode_s_per_tok"],
           "finite": bool(logits.isfinite().all()),
           "logits_hash": hashlib.sha256(logits.numpy().tobytes()).hexdigest()}
    if mesh.coord["model"] == 0:
        out["logits"] = logits
    return out


def ranks_body(prompts, traffic, island_seed: int) -> dict:
    """What each of RANKS_WORLD ranks runs (`run_ranks`): the f32 model on
    the (1, 4) mesh, its expert leaves moved to the (1, 2) mesh (ranks 0
    and 1; `remesh_params`) and held bitwise to the experts of the f32
    model built for that mesh, which then serves; the bf16 model served
    twice on the (1, 2) mesh; the island SA with one island a rank.
    Returns the results and this process's kernel launch counts."""
    import torch

    from repro_torch.core.mapping_device import island_sa
    from repro_torch.launch import serve_batch
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import Model, build_model
    from repro_torch.runtime import Sharded, remesh_params
    from repro_torch.sharding import ParamShard, ShardingPlan, plan_params

    counters = launch_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    mesh4 = make_rank_mesh((1, 4), device="cuda")
    mesh2 = make_rank_mesh((1, 2), device="cuda", ranks=(0, 1))
    islands = make_rank_mesh((RANKS_WORLD,), ("data",), device="cuda")
    cfg = ranks_config(RANKS_PARITY_LAYERS, "float32")
    kw = dict(seed=RANKS["seed"], keep_logits=True, print_fn=lambda *_: None)

    def build(cfg, mesh):
        return build_model(cfg, mesh.device, seed=RANKS["seed"],
                           shard=ParamShard.of(mesh))

    shapes = Model(cfg, "meta").param_shapes()

    def expert_specs(mesh) -> dict:  # the planner's expert rule on ``mesh``
        moe = plan_params(ShardingPlan(mesh_shape=mesh.shape), shapes)["layers"]["moe"]
        return {"layers": {"moe": {k: moe[k] for k in ("w_gate", "w_up", "w_down")}}}

    out = {}
    model = build(cfg, mesh4)
    out["parity_1x4"] = _served(serve_batch(cfg, mesh4, prompts, RANKS["gen_len"],
                                            model=model, **kw), mesh4)
    # This rank's expert leaves as placed on the (1, 4) mesh.
    spec4 = expert_specs(mesh4)["layers"]["moe"]
    pos = tuple(mesh4.coord.values())
    placed = {"layers": {"moe": {
        k: Sharded({pos: leaf}, tuple(shapes["layers"]["moe"][k]), mesh4, spec4[k])
        for k, leaf in _expert_leaves(model).items()}}}
    del model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moved = remesh_params(placed, mesh2, expert_specs(mesh2))["layers"]["moe"]
    torch.cuda.synchronize()
    remesh_s = time.perf_counter() - t0
    del placed
    torch.cuda.empty_cache()
    if mesh2.is_member:
        model = build(cfg, mesh2)
        want = _expert_leaves(model)
        out["remesh"] = {
            "exact": all(torch.equal(moved[k].local, want[k]) for k in want),
            "bytes": sum(moved[k].local.numel() * moved[k].local.element_size()
                         for k in want), "seconds": remesh_s}
        del moved, want
        out["parity_1x2"] = _served(serve_batch(cfg, mesh2, prompts,
                                                RANKS["gen_len"], model=model,
                                                **kw), mesh2)
        del model
        torch.cuda.empty_cache()
        timing = ranks_config(RANKS_TIMING_LAYERS, "bfloat16")
        torch.cuda.reset_peak_memory_stats()
        model = build(timing, mesh2)
        first = serve_batch(timing, mesh2, prompts, RANKS["gen_len"], model=model,
                            **kw)
        again = serve_batch(timing, mesh2, prompts, RANKS["gen_len"], model=model,
                            **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        del model
        # One decode step's collective alone: the all_reduce of a MoE
        # layer's (B, 1, D) output over the model axis.
        step = torch.ones((RANKS["batch"], 1, timing.d_model),
                          dtype=torch.bfloat16, device=mesh2.device)
        mesh2.all_reduce(step, "model")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RANKS_COLLECTIVES):
            mesh2.all_reduce(step, "model")
        torch.cuda.synchronize()
        out["timing"] = dict(_served(again, mesh2),
                             first_tokens=first["tokens"],
                             first_prefill_s=first["prefill_s"],
                             first_decode_s_per_tok=first["decode_s_per_tok"],
                             peak_bytes=peak,
                             all_reduce_s=(time.perf_counter() - t0)
                             / RANKS_COLLECTIVES)
        torch.cuda.empty_cache()
    else:
        out["remesh"] = {"none": moved is None or all(
            v is None for v in moved.values())}
    res = island_sa(traffic, SLICE["mesh_w"] * SLICE["mesh_h"], SLICE["mesh_w"],
                    int(traffic.sum()), seed=island_seed, mesh=islands,
                    axis="data")
    out["island"] = {"placement": res.placement, "avg_hop": res.avg_hop,
                     "seconds": res.seconds, "evaluations": res.evaluations}
    out["launches"] = {name: getattr(mod, attr)
                       for name, (mod, attr) in counters.items()}
    return out


def _held_to(name: str, card: str, members: list, want: dict, tol: float) -> float:
    """Every rank's greedy tokens equal the unsharded run's, every rank's
    logits the same bits (their hashes), and model coordinate 0's logits
    within ``tol`` of max|logit| of the unsharded run's; returns the
    error."""
    import numpy as np

    if len({m["logits_hash"] for m in members}) != 1:
        fail(f"ranks {name}: the ranks' logits differ")
    for m in members:
        if not np.array_equal(m["tokens"], want["tokens"]):
            fail(f"ranks {name}: greedy tokens {m['tokens'].tolist()} differ "
                 f"from the unsharded run's {want['tokens'].tolist()}")
    logits = next(m["logits"] for m in members if "logits" in m)
    ref = want["logits"]
    err = float((logits - ref).abs().max() / ref.abs().max())
    if not err <= tol:
        fail(f"ranks {name}: logits {err!r} of max|logit| from the unsharded "
             f"run's, beyond {tol}")
    print(f"ranks {name} [{card}]: {len(members)} ranks; greedy tokens equal "
          f"the unsharded run's; logits {err:.3e} of max|logit| from it "
          f"(bound {tol})")
    return err


# The tensor-parallel part of the ranks phase serves llama3-8b at its
# published width (d_model 4096, 32 heads, 8 KV heads, d_ff 14,336, vocab
# 128,256) on gloo ranks of cuda:0, each rank's model holding the
# planner's blocks (`ParamShard.of(mesh)`), from a torch.Generator seeded
# RANKS["seed"]: f32 at 2 layers on (1, 4) and (1, 2) against the
# unsharded model, and bf16 at 16 of its 32 layers on (1, 2), timed.
TP_ARCH = "llama3-8b"
TP_MESHES = ((1, 4), (1, 2))
TP_PARITY_LAYERS = 2  # f32, held to the unsharded run
TP_TIMING_LAYERS = 16  # bf16, half the depth, timed on (1, 2)
# The prefill's last logits, of max|logit|, against the unsharded bf16
# run's.  32 random bf16 layers amplify any change of rounding to ~2e-2:
# the shipped f32 reduction of the row-parallel sums reads 1.9e-2 and
# XLA's bf16 one 2.3e-2, both correct; each rank attending with its KV
# heads rolled by one reads 1.6 (PERF.md §6).  The limit sits
# between them; 16 layers amplify less.
TP_BF16_TOL = 5e-2
# A rank's peak memory against the unsharded run's.  Both peaks hold the
# f32 draw of the whole embedding at init (1.96 GiB) beside the weights:
# at 32 layers a rank read 0.558 (7.48 + 1.96 GiB against 14.96 + 1.96),
# so at 16 it should read (4.23 + 1.96) / (8.46 + 1.96) = 0.594; a rank
# holding its layers whole reads 0.8 or more.
TP_PEAK_SHARE = 0.65


def tp_config(layers: int, dtype: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TP_ARCH), num_layers=layers,
                               param_dtype=dtype, activation_dtype=dtype)


def fingerprint(t) -> tuple[int, int]:
    """A digest of a tensor's bits, computed on its device: the sum of its
    words (int16 or int32, by its element size, summed as int64) and
    their sum weighted by a hash of each word's position.  A change of any
    one word moves the weighted sum (modulo 2**64)."""
    import torch

    words = t.detach().contiguous().view(-1).view(
        {2: torch.int16, 4: torch.int32}[t.element_size()])
    total = weighted = 0
    for start in range(0, words.numel(), 1 << 26):
        w = words[start:start + (1 << 26)].to(torch.int64)
        pos = torch.arange(start, start + w.numel(), dtype=torch.int64,
                           device=w.device)
        total += int(w.sum())
        weighted += int((w * (pos * 2654435761 % (1 << 31) + 1)).sum())
    return total, weighted


def _decode_bytes(model, batch: int, cache_len: int) -> tuple[int, int]:
    """(the weights a decode step reads: all but the embedding table, the
    bytes of the caches) of ``model``."""
    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters() if n != "embed")
    caches = model.init_caches(batch, cache_len)["layers"]
    return weights, nbytes(*caches.values())


def tp_body(prompts) -> dict:
    """What each of RANKS_WORLD ranks runs for the tensor-parallel part:
    the f32 model served on the (1, 4) and (1, 2) meshes (tokens, logits,
    the collectives' tally and a `fingerprint` of every leaf it holds),
    then the bf16 model at TP_TIMING_LAYERS served twice on (1, 2) (ranks 0 and
    1; timings, peak memory, tally).  Returns the results and this
    process's kernel launch counts."""
    import torch

    from repro_torch.launch import serve_batch
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import ParamShard

    counters = launch_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    meshes = {shape: make_rank_mesh(shape, device="cuda",
                                    ranks=range(shape[0] * shape[1]))
              for shape in TP_MESHES}
    kw = dict(seed=RANKS["seed"], keep_logits=True, print_fn=lambda *_: None)
    cfg = tp_config(TP_PARITY_LAYERS, "float32")
    out = {}
    for shape, mesh in meshes.items():
        if not mesh.is_member:
            continue
        model = build_model(cfg, mesh.device, seed=RANKS["seed"],
                            shard=ParamShard.of(mesh))
        res = serve_batch(cfg, mesh, prompts, RANKS["gen_len"], model=model, **kw)
        out[shape] = dict(_served(res, mesh), coord=mesh.coord["model"],
                          collectives=res["collectives"],
                          digests={n: fingerprint(p)
                                   for n, p in model.named_parameters()})
        del model, res
        torch.cuda.empty_cache()
    mesh = meshes[(1, 2)]
    if mesh.is_member:
        timing = tp_config(TP_TIMING_LAYERS, "bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = build_model(timing, mesh.device, seed=RANKS["seed"],
                            shard=ParamShard.of(mesh))
        first = serve_batch(timing, mesh, prompts, RANKS["gen_len"], model=model,
                            **kw)
        again = serve_batch(timing, mesh, prompts, RANKS["gen_len"], model=model,
                            **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        weights, caches = _decode_bytes(model, RANKS["batch"],
                                        RANKS["prompt_len"] + RANKS["gen_len"])
        del model
        torch.cuda.empty_cache()
        out["timing"] = dict(_served(again, mesh), first_tokens=first["tokens"],
                             first_prefill_s=first["prefill_s"],
                             first_decode_s_per_tok=first["decode_s_per_tok"],
                             peak_bytes=peak, collectives=again["collectives"],
                             weight_bytes=weights, cache_bytes=caches)
    out["launches"] = {name: getattr(mod, attr)
                       for name, (mod, attr) in counters.items()}
    return out


def _check_tally(name: str, tally: dict, layers: int) -> None:
    """A decode step's collectives: the embedding's all_reduce, one after
    each layer's attention and one after its MLP, and the head's
    all_gather."""
    want = {"all-reduce": 2 * layers + 1, "all-gather": 1, "_count": 2 * layers + 2}
    if tally["count"] != want:
        fail(f"ranks {name}: a decode step issued {tally['count']} "
             f"collectives, not {want}")


def _fmt_tally(tally: dict) -> str:
    return ", ".join(f"{op} {tally['count'].get(op, 0)} "
                     f"({tally['bytes'].get(op, 0)} B)"
                     for op in ("all-reduce", "all-gather"))


def tp_part(card: str) -> dict:
    """The tensor-parallel part of the ranks phase (`tp_body` on
    RANKS_WORLD processes on cuda:0 over gloo) against the unsharded model
    from the same seed: f32 at TP_PARITY_LAYERS on (1, 4) and (1, 2)
    (tokens equal, logits within RANKS_TOL of max|logit|, each rank's
    leaves the unsharded model's blocks by `fingerprint`, a decode step's
    2L + 2 collectives); bf16 at TP_TIMING_LAYERS on (1, 2) (the prefill's
    last logits within TP_BF16_TOL of max|logit|, a decode step's 2L + 2
    collectives, each rank's peak at most TP_PEAK_SHARE of the unsharded
    run's; the greedy tokens' agreement printed).  Returns the ranks'
    kernel launch counts."""
    import numpy as np
    import torch

    from repro_torch.launch import make_local_mesh, serve_batch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import build_model
    from repro_torch.models.model import reference_path
    from repro_torch.sharding import ParamShard

    cfg = tp_config(TP_PARITY_LAYERS, "float32")
    prompts, _ = serve_prompts(cfg, RANKS["batch"], RANKS["prompt_len"],
                               RANKS["seed"])
    one = make_local_mesh(device="cuda")
    kw = dict(keep_logits=True, print_fn=lambda *_: None)
    cache_len = RANKS["prompt_len"] + RANKS["gen_len"]
    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda", seed=RANKS["seed"])
    want = serve_batch(cfg, one, prompts, RANKS["gen_len"], model=model, **kw)
    digests = {}
    for shape in TP_MESHES:
        for i in range(shape[1]):
            shard = ParamShard({"data": shape[0], "model": shape[1]},
                               {"data": 0, "model": i})
            digests[shape, i] = {
                n: fingerprint(p[shard.block(reference_path(n)[0], p.shape)[1]])
                for n, p in model.named_parameters()}
    parity_bytes = nbytes(*model.parameters())
    del model
    timing = tp_config(TP_TIMING_LAYERS, "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(timing, "cuda", seed=RANKS["seed"])
    serve_batch(timing, one, prompts, RANKS["gen_len"], model=model, **kw)
    alone = serve_batch(timing, one, prompts, RANKS["gen_len"], model=model, **kw)
    torch.cuda.synchronize()
    alone_peak = torch.cuda.max_memory_allocated() - base
    alone_weights, alone_caches = _decode_bytes(model, RANKS["batch"], cache_len)
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    got = run_ranks(tp_body, RANKS_WORLD, ROOT / "build" / "tp_ranks", prompts,
                    device="cuda", timeout_s=RANKS_TIMEOUT_S)
    tp_s = time.perf_counter() - t0

    for shape in TP_MESHES:
        members = [r[shape] for r in got if shape in r]
        _held_to(f"tp f32 {shape}", card, members, want, RANKS_TOL)
        for m in members:
            if m["digests"] != digests[shape, m["coord"]]:
                bad = sorted(n for n, d in m["digests"].items()
                             if d != digests[shape, m["coord"]].get(n))
                fail(f"ranks tp f32 {shape}: model coordinate {m['coord']}'s "
                     f"leaves {bad[:4]} are not the unsharded model's blocks")
            _check_tally(f"tp f32 {shape}", m["collectives"]["decode"],
                         TP_PARITY_LAYERS)
        print(f"ranks tp f32 {shape} [{card}]: every rank's {len(members[0]['digests'])} "
              f"leaves are the unsharded model's blocks (fingerprints; "
              f"{parity_bytes / 1e9:.3f} GB whole); a decode step: "
              f"{_fmt_tally(members[0]['collectives']['decode'])}")
    bound = (alone_weights + alone_caches) / H100_BYTES_PER_S * 1e3
    print(f"ranks tp bf16 ({TP_TIMING_LAYERS} layers) unsharded [{card}]: prefill "
          f"{alone['prefill_s'] * 1e3:.3f} ms ({RANKS['batch']} x "
          f"{RANKS['prompt_len']} tokens); decode "
          f"{alone['decode_s_per_tok'] * 1e3:.3f} ms a token (bound "
          f"{bound:.3f} ms), {RANKS['batch'] / alone['decode_s_per_tok']:.1f} "
          f"tokens/s; peak memory {alone_peak / 2**30:.3f} GiB "
          f"(max_memory_allocated over the phase's start)")
    ref = alone["logits"][0]
    for rank, r in enumerate(got[:2]):
        t = r["timing"]
        if not t["finite"]:
            fail(f"ranks tp bf16: rank {rank}'s logits are not finite")
        if not np.array_equal(t["tokens"], t["first_tokens"]):
            fail(f"ranks tp bf16: rank {rank}'s second serve gave other tokens")
        if not np.array_equal(t["tokens"], got[0]["timing"]["tokens"]):
            fail("ranks tp bf16: the ranks' greedy tokens differ")
        if t["logits_hash"] != got[0]["timing"]["logits_hash"]:
            fail("ranks tp bf16: the ranks' logits differ")
        _check_tally("tp bf16", t["collectives"]["decode"], TP_TIMING_LAYERS)
        share = t["peak_bytes"] / alone_peak
        if not share <= TP_PEAK_SHARE:
            fail(f"ranks tp bf16: rank {rank}'s peak memory is {share:.3f} of "
                 f"the unsharded run's, above {TP_PEAK_SHARE}")
        rank_bound = (t["weight_bytes"] + t["cache_bytes"]) / H100_BYTES_PER_S * 1e3
        print(f"ranks tp bf16 ({TP_TIMING_LAYERS} layers) (1, 2) rank {rank} "
              f"[{card}]: prefill {t['prefill_s'] * 1e3:.3f} ms (first call "
              f"{t['first_prefill_s'] * 1e3:.3f}); decode "
              f"{t['decode_s_per_tok'] * 1e3:.3f} ms a token (first call "
              f"{t['first_decode_s_per_tok'] * 1e3:.3f}; bound "
              f"{rank_bound:.3f} ms), "
              f"{RANKS['batch'] / t['decode_s_per_tok']:.1f} tokens/s; peak "
              f"memory {t['peak_bytes'] / 2**30:.3f} GiB, {share:.3f} of the "
              f"unsharded run's; a decode step: "
              f"{_fmt_tally(t['collectives']['decode'])}; the prefill: "
              f"{_fmt_tally(t['collectives']['prefill'])}")
    t = got[0]["timing"]
    err = float((t["logits"][0] - ref).abs().max() / ref.abs().max())
    if not err <= TP_BF16_TOL:
        fail(f"ranks tp bf16: the prefill's last logits are {err!r} of "
             f"max|logit| from the unsharded run's, beyond {TP_BF16_TOL}")
    agree = float(np.mean(t["tokens"] == alone["tokens"]))
    print(f"ranks tp bf16 [{card}]: the prefill's last logits {err:.3e} of "
          f"max|logit| from the unsharded run's (bound {TP_BF16_TOL}); "
          f"{agree:.3f} of the greedy tokens agree with it (not gated); the "
          f"rank job {tp_s:.1f} s. One card over gloo shows the sharded "
          "program's correctness, memory and collectives, not what tensor "
          "parallelism gains across cards")
    return {name: sum(r["launches"][name] for r in got) for name in got[0]["launches"]}


# The training part of the ranks phase (`train_ranks_part`): llama3-8b at
# its published width trains on gloo ranks of cuda:0, each rank's model
# holding its position's blocks from a torch.Generator seeded
# TR["seed"]: f32 at 2 layers on (1, 2) and on (2, 2) with ZeRO-1, and
# qwen3-moe-30b-a3b f32 at 1 layer on (1, 2) (expert parallel), held to
# the unsharded run from the same seed on the same batches; then llama3-8b
# bf16 at 8 layers on (1, 2), timed beside the unsharded run, under the
# "full" and "save_collectives" remat policies.  (2, 1) is left out: each
# of its ranks would send the whole f32 gradient, ~6 GB a step, through
# gloo's host ring.
TR = dict(batch=4, seq=256, seed=0)
TR_PARITY_LAYERS, TR_MOE_LAYERS, TR_TIMING_LAYERS = 2, 1, 8
TR_PARITY_MESHES = (((1, 2), False), ((2, 2), True))  # (shape, zero1)
TR_PARITY_STEPS, TR_TIMING_STEPS, TR_SAVE_STEPS = 2, 4, 3
# Each leaf's parameters and moments are held to the unsharded run's by k
# sums of their elements times +-1 signs hashed from each element's index
# in the whole leaf: over the ranks' distinct blocks against the whole
# leaf, the sums' root-mean-square difference over the leaf's L2 norm
# estimates the relative L2 error (moving the whole tensors between the
# processes would carry ~30 GB).  Ranks that hold the same block must
# give the same sums (TR_SAME_REL of its L2 norm).
TR_PROJ_K = 4
TR_SAME_REL = 1e-12
# After step 1 the ranks differ from the unsharded run by the rounding
# of sums taken in another order: the moments within TR_TOL.  Adam's
# first update is lr times about the gradient's sign, so an element
# whose gradient lies nearer 0 than that rounding moves 2 lr the other
# way, and step 2 starts from parameters that differ there.  The step-1
# sign flips are counted on the card (`sign_chunks`: sums of signs of m
# over chunks of TR_SIGN_CHUNK elements), and what a correct program
# reaches after step 2 is measured in the same run: the unsharded step
# with its batch in TR_FLOOR_MICRO micro-batches (`_micro_step`: the sums
# a data axis takes in another order) against the unsharded step.  Each
# part's step-2 bound is TR_FLOOR_MULT times that floor, and never below
# TR_TOL.
TR_TOL = 1e-5
TR_METRIC_RTOL = 1e-5  # loss and gradient norm, relative
TR_SIGN_CHUNK = 4096
TR_FLOOR_MICRO, TR_FLOOR_MULT = 2, 4
# qwen3-moe's step 2 routes at its published capacity factor 1.25 from
# the flipped parameters: a token whose top-8 set or capacity slot
# changes moves whole rows of its experts' gradients.  Every rank and the
# unsharded run record each step's routing (`recording_routes`), and
# each expert's error is read alone (`_pieces`).  The rerouted tokens
# are held to TR_MOE_MAX_CHANGED of a step's tokens; after step 2 the
# experts that no rerouted token touches to llama's step-2 bound on
# their parameters and TR_MOE_EXPERTS on their moments (an expert's
# leaf is 1/128 of the stacked leaf, so its relative error reads
# coarser than a whole leaf's); every whole leaf (router, dense leaves,
# the stacked experts, the touched ones inside) to TR_MOE_STEP2, and the
# loss and gradient norm to TR_MOE_STEP2["metrics"] relative.  The card
# read one token rerouted at step 2, its two experts' moments 5.6e-2 and
# 1.1e-2, the untouched experts' 2.4e-4 at most, the router's 2.8e-3,
# the loss 6.0e-6 (PERF.md §6): each bound about 4x its reading.
TR_MOE_MAX_CHANGED = 0.02
TR_MOE_EXPERTS = 1e-3
TR_MOE_STEP2 = dict(p=4e-4, moments=1e-2, metrics=3e-5)
TR_EXPERT_LEAVES = ("moe/w_gate", "moe/w_up", "moe/w_down")
TR_FLOP_TOL = 0.01  # a rank's profiled matmul FLOPs against its count


def tr_config(arch: str, layers: int, dtype: str, policy: str = "full"):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), num_layers=layers,
                               param_dtype=dtype, activation_dtype=dtype,
                               remat_policy=policy)


def tr_opt(steps: int, timing: bool = False):
    """The parity runs' schedule (lr 1e-3 from the first step), or the
    timing run's: the train phase's (`TRAIN`), whose warm-up keeps a
    random bf16 model's first steps falling (at lr 1e-3 from the first
    step llama3-8b's loss rose at step 3 on the card)."""
    from repro_torch.optim import AdamWConfig

    if timing:
        return AdamWConfig(lr=TRAIN["lr"], warmup_steps=5, total_steps=TRAIN["steps"])
    return AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)


def tr_batches(cfg, steps: int) -> list:
    from repro_torch.data import DataConfig, SyntheticLMData

    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=TR["seq"],
                                      global_batch=TR["batch"], seed=TR["seed"]))
    return [data.batch(i)["tokens"] for i in range(steps)]


def _whole_indices(x, whole: tuple, block: tuple):
    """(``x``'s elements, their flat indices in the whole leaf of shape
    ``whole``), a bounded number of rows at a time; ``x`` is the
    ``block`` (slices in whole coordinates) of that leaf."""
    import numpy as np
    import torch

    lens = [len(range(n)[b]) for n, b in zip(whole, block)]
    strides = np.cumprod([1] + list(whole[::-1]))[::-1][1:].tolist()
    x = x.detach().reshape(lens if lens else [1])
    if not lens:
        lens, strides, block = [1], [1], (slice(0, 1),)
    dev = x.device
    rest = torch.zeros((), dtype=torch.int64, device=dev)
    for d in range(1, len(lens)):
        idx = torch.arange(block[d].start, block[d].start + lens[d],
                           dtype=torch.int64, device=dev) * strides[d]
        rest = rest[..., None] + idx
    rest = rest.reshape(-1)
    rows = max(1, (1 << 24) // max(rest.numel(), 1))
    for r0 in range(0, lens[0], rows):
        r1 = min(lens[0], r0 + rows)
        first = torch.arange(block[0].start + r0, block[0].start + r1,
                             dtype=torch.int64, device=dev) * strides[0]
        yield x[r0:r1].reshape(-1), (first[:, None] + rest[None, :]).reshape(-1)


_HASH_MIX = (-7046029254386353131, -4658895280553007687, -7723592293110705685)


def _hash(index, salt: int):
    """A 64-bit hash of each int64 ``index`` and ``salt``."""
    import torch

    mix = torch.tensor(_HASH_MIX, dtype=torch.int64, device=index.device)
    h = index * mix[0] + salt * mix[1]
    h = h ^ (h >> 31)
    return h * mix[2]


def leaf_projections(x, whole: tuple, block: tuple):
    """TR_PROJ_K f64 sums of ``x``'s elements, each times +-1 from a hash
    of (its flat index in the whole leaf of shape ``whole``, the sum's
    number), then the sum of their squares; ``x`` is the ``block``
    (slices in whole coordinates) of that leaf."""
    import torch

    out = torch.zeros(TR_PROJ_K + 1, dtype=torch.float64, device=x.device)
    for chunk, index in _whole_indices(x, whole, block):
        chunk = chunk.double()
        for j in range(TR_PROJ_K):
            sign = ((_hash(index, j + 1) >> 40) & 1).double() * 2 - 1
            out[j] += (chunk * sign).sum()
        out[TR_PROJ_K] += chunk.square().sum()
    return out.cpu().numpy()


def sign_chunks(x, whole: tuple, block: tuple):
    """int64 sums, one a TR_SIGN_CHUNK elements of the whole leaf in flat
    order, of each element's sign (-1, 0, 1) times a 20-bit weight hashed
    from its index: the blocks' sums add up to the whole leaf's exactly,
    and an element whose sign differs changes its chunk's sum."""
    import numpy as np
    import torch

    n = int(np.prod(whole)) if whole else 1
    out = torch.zeros(-(-n // TR_SIGN_CHUNK), dtype=torch.int64, device=x.device)
    for chunk, index in _whole_indices(x, whole, block):
        weight = ((_hash(index, 0) >> 40) & 0xFFFFF) + 1
        out.index_add_(0, index // TR_SIGN_CHUNK,
                       torch.sign(chunk).to(torch.int64) * weight)
    return out.cpu().numpy()


def _pieces(path: str, x, whole: tuple, block: tuple, expert_dim: int) -> list:
    """[(key, tensor, block)] of ``x`` (the ``block`` of a leaf): the
    block itself, or for an expert leaf one piece an expert, keyed
    ``<path>/e<expert>``, so that each expert's error reads alone."""
    if not path.endswith(TR_EXPERT_LEAVES):
        return [(path, x, block)]
    x = x.reshape([len(range(n)[b]) for n, b in zip(whole, block)])
    out = []
    for j, e in enumerate(range(*block[expert_dim].indices(whole[expert_dim]))):
        sub = list(block)
        sub[expert_dim] = slice(e, e + 1)
        out.append((f"{path}/e{e:03d}", x.narrow(expert_dim, j, 1), tuple(sub)))
    return out


def state_projections(model, state, mesh_info, zero1: bool, parts) -> dict:
    """{part: {key: [(block key, sums)]}} of ``parts``: "p" the model's
    parameters (a layer's block each), "m" and "v" its AdamW moments (the
    leaf's block), each `leaf_projections` in the whole stacked leaf and
    keyed by leaf path (an expert leaf's by expert, `_pieces`); "s" the
    `sign_chunks` of m by leaf path."""
    import numpy as np

    from repro_torch.optim.adamw import rank_leaves

    out = {part: {} for part in parts}
    params = dict(model.named_parameters())
    for leaf in rank_leaves(model, mesh_info, zero1):
        nl = len(leaf.lead)
        pieces = []
        if "p" in parts:
            for i, name in enumerate(leaf.names):
                index = np.unravel_index(i, leaf.lead) if leaf.lead else ()
                block = tuple(slice(j, j + 1) for j in index) + leaf.layer_block
                pieces += [("p", *piece) for piece in
                           _pieces(leaf.path, params[name], leaf.whole, block, nl)]
        for part in ("m", "v"):
            if part in parts:
                pieces += [(part, *piece) for piece in _pieces(
                    leaf.path, state[part][leaf.path], leaf.whole,
                    leaf.moment_block, nl)]
        for part, key, x, block in pieces:
            out[part].setdefault(key, []).append(
                (str(block), leaf_projections(x, leaf.whole, block)))
        if "s" in parts:
            out["s"].setdefault(leaf.path, []).append((str(leaf.moment_block), sign_chunks(
                state["m"][leaf.path], leaf.whole, leaf.moment_block)))
    return out


class recording_routes:
    """Within it, each call of `repro_torch.models.moe.router_topk` keeps
    its (T, K) expert ids, on the host, in ``calls``."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, orig = [], moe, moe.router_topk

        def record(logits, top_k):
            weights, experts, aux = orig(logits, top_k)
            self.calls.append(experts.detach().cpu().numpy())
            return weights, experts, aux

        self._orig, moe.router_topk = orig, record
        return self

    def __exit__(self, *exc):
        self._moe.router_topk = self._orig


def _micro_step(steps: int, micro: int):
    """The unsharded train step with the batch's rows in ``micro`` equal
    micro-batches: each one's loss over ``micro`` backward, the gradients
    summed in the parameters' ``.grad``, then `adamw_update` with the
    parity runs' schedule.  The same function as `make_train_step`'s for a
    dense model, its sums taken in the order a data axis of ``micro``
    positions takes them."""
    import torch

    from repro_torch.optim import adamw_update

    opt = tr_opt(steps)

    def step(model, state, batch):
        tokens = batch["tokens"]
        rows = tokens.shape[0] // micro
        model.requires_grad_(True)
        losses = []
        for i in range(micro):
            loss, _ = model.loss({"tokens": tokens[i * rows:(i + 1) * rows]})
            (loss / micro).backward()
            losses.append(loss.detach())
        grads = {n: p.grad for n, p in model.named_parameters()}
        stats = adamw_update(model, grads, state, opt)
        model.zero_grad(set_to_none=True)
        return state, {"loss": torch.stack(losses).mean(), **stats}

    return step


def _tr_steps(cfg, model, mesh, zero1: bool, batches: list, remat: bool,
              track: bool, micro: int = 1) -> dict:
    """`make_train_step` over ``batches`` on ``mesh`` (a rank mesh, or a
    one-card mesh; with ``micro`` > 1 `_micro_step` on one card): each
    step's metrics, host seconds (synchronised) and tally, and with
    ``track`` the projections of the moments and the signs of m after
    step 1, of the parameters and moments after the last step, and a MoE
    layer's routing each step."""
    import torch

    minfo = (mesh, tuple(a for a in mesh.axis_names if a != "model")) \
        if mesh.ranks is not None else None
    bundle = make_train_step_for(cfg, mesh, zero1, remat, len(batches),
                                 timing=not track)
    state, step = bundle.init_opt(model), bundle.jit_for(None)
    if micro > 1:
        step = _micro_step(len(batches), micro)
    out = {"metrics": [], "seconds": [], "tallies": [], "proj": [], "routes": []}
    with recording_routes() as routes:
        for i, tokens in enumerate(batches):
            batch = {"tokens": torch.from_numpy(tokens).to(model.device)}
            mark, calls = mesh.copy_tally(), len(routes.calls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(model, state, batch)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            out["seconds"].append(time.perf_counter() - t0)
            out["tallies"].append(mesh.tally_since(mark))
            if track:
                out["routes"].append(routes.calls[calls:])
                parts = ("m", "v", "s") if i < len(batches) - 1 else ("p", "m", "v")
                out["proj"].append(state_projections(model, state, minfo, zero1,
                                                     parts))
    out["state"] = state
    return out


def make_train_step_for(cfg, mesh, zero1: bool, remat: bool, steps: int,
                        timing: bool = False):
    from repro_torch.launch import make_train_step

    return make_train_step(cfg, mesh, opt=tr_opt(steps, timing), remat=remat,
                           zero1=zero1)


def train_ranks_body(parity: list, moe: list, timing: list) -> dict:
    """What each of RANKS_WORLD ranks runs for the training part: the f32
    llama3-8b steps on each of TR_PARITY_MESHES and the f32 qwen3-moe
    steps on (1, 2), tracked (`_tr_steps`); then on (1, 2) the bf16
    llama3-8b steps under "full" (timed, peak memory, the optimizer alone,
    one step profiled for its matmul FLOPs with early stop off) and under
    "save_collectives".  Returns the results and this process's kernel
    launch counts."""
    import torch
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_update
    from repro_torch.sharding import ParamShard

    counters = launch_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    meshes = {shape: make_rank_mesh(shape, device="cuda",
                                    ranks=range(shape[0] * shape[1]))
              for shape in ((1, 2), (2, 2))}

    def build(cfg, mesh):
        return build_model(cfg, mesh.device, seed=TR["seed"],
                           shard=ParamShard.of(mesh))

    out = {}
    runs = [("llama", shape, zero1, tr_config(TP_ARCH, TR_PARITY_LAYERS, "float32"),
             parity) for shape, zero1 in TR_PARITY_MESHES]
    runs.append(("moe", (1, 2), False,
                 tr_config(RANKS_ARCH, TR_MOE_LAYERS, "float32"), moe))
    for name, shape, zero1, cfg, batches in runs:
        mesh = meshes[shape]
        if mesh.is_member:
            model = build(cfg, mesh)
            res = _tr_steps(cfg, model, mesh, zero1, batches, remat=False,
                            track=True)
            del res["state"], model
            out[name, shape] = dict(res, coord=mesh.coord)
        torch.cuda.empty_cache()
    mesh = meshes[(1, 2)]
    if mesh.is_member:
        cfg = tr_config(TP_ARCH, TR_TIMING_LAYERS, "bfloat16")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = build(cfg, mesh)
        res = _tr_steps(cfg, model, mesh, False, timing, remat=True, track=False)
        torch.cuda.synchronize()
        res["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        state = res.pop("state")
        batch = {"tokens": torch.from_numpy(timing[0]).to(mesh.device)}
        minfo = (mesh, ("data",))
        model.requires_grad_(True)
        model.loss({"tokens": batch["tokens"]}, mesh_info=minfo, remat=True)[0].backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        opt = tr_opt(len(timing), timing=True)
        res["opt_ms"] = cuda_ms(lambda: adamw_update(model, grads, state, opt,
                                                     mesh_info=minfo),
                                iters=1, warmup=1, repeats=3)
        model.zero_grad(set_to_none=True)
        del grads
        step = make_train_step_for(cfg, mesh, False, True, len(timing),
                                   timing=True).jit_for(None)
        with set_checkpoint_early_stop(False):
            res["prof_flops"] = profiler_matmul_flops(
                lambda: step(model, state, batch))
        del model, state
        torch.cuda.empty_cache()
        out["timing_full"] = dict(res, coord=mesh.coord)
        save_cfg = tr_config(TP_ARCH, TR_TIMING_LAYERS, "bfloat16", "save_collectives")
        model = build(save_cfg, mesh)
        res = _tr_steps(save_cfg, model, mesh, False, timing[:TR_SAVE_STEPS],
                        remat=True, track=False)
        del res["state"], model
        torch.cuda.empty_cache()
        out["timing_save"] = dict(res, coord=mesh.coord)
    out["launches"] = {name: getattr(mod, attr)
                       for name, (mod, attr) in counters.items()}
    return out


def _sum_blocks(ranks_proj: list, where: list, what: str) -> dict:
    """{part: {key: sums over the distinct blocks the ranks hold}}; ranks
    that hold the same block (a replicated leaf, a data replica's) must
    give the same sums: integer sums equal, float sums within TR_SAME_REL
    of the block's L2 norm.  ``where`` names each rank in a failure."""
    import numpy as np

    out = {}
    for proj, rank in zip(ranks_proj, where):
        for part, paths in proj.items():
            for path, blocks in paths.items():
                seen = out.setdefault(part, {}).setdefault(path, {})
                for key, sums in blocks:
                    sums = np.asarray(sums)
                    if key not in seen:
                        seen[key] = (sums, rank)
                        continue
                    first, other = seen[key]
                    same = (np.array_equal(first, sums) if sums.dtype.kind == "i"
                            else float(np.max(np.abs(first - sums)))
                            <= TR_SAME_REL * float(np.sqrt(first[-1])))
                    if not same:
                        fail(f"{what}: {other} and {rank} hold the block {key} of "
                             f"{part} {path} with other values")
    return {part: {path: sum(s for s, _ in d.values()) for path, d in paths.items()}
            for part, paths in out.items()}


def _key_errors(got: dict, want: dict, what: str) -> dict:
    """{part: {key: estimated relative L2 error}} of the summed projections
    ``got`` against ``want`` (`_sum_blocks`'s), part "s" left out: the
    root-mean-square difference of the signed sums over the whole key's
    L2 norm (a key that is all zeros: 0 where the ranks' is too, else
    infinite)."""
    import numpy as np

    def error(g, w):
        diff = float(np.sqrt(np.mean((g[:TR_PROJ_K] - w[:TR_PROJ_K]) ** 2)))
        if w[TR_PROJ_K] > 0:
            return diff / float(np.sqrt(w[TR_PROJ_K]))
        return 0.0 if g[TR_PROJ_K] == 0 else float("inf")

    out = {}
    for part, paths in want.items():
        if part == "s":
            continue
        if sorted(got[part]) != sorted(paths):
            fail(f"{what}: the ranks hold {sorted(got[part])} of {part}, not "
                 f"{sorted(paths)}")
        out[part] = {p: error(got[part][p], w) for p, w in paths.items()}
    return out


def _flips(got: dict, want: dict) -> dict:
    """{leaf path: chunks of TR_SIGN_CHUNK elements whose sign sums
    differ}: at least the elements of m whose sign differs, and as many
    where each flip lies in a chunk of its own."""
    import numpy as np

    return {p: int(np.count_nonzero(got["s"][p] != w)) for p, w in want["s"].items()}


def _merged(summed: dict) -> dict:
    """`_sum_blocks`'s sums with each expert's piece added back into its
    leaf (the pieces' signed sums add up to the leaf's)."""
    out = {}
    for part, keys in summed.items():
        merged = out[part] = {}
        for key, sums in keys.items():
            leaf = key.rpartition("/")[0] if _expert_of(key) is not None else key
            merged[leaf] = merged[leaf] + sums if leaf in merged else sums
    return out


def _worst(errs: dict, keys=None) -> tuple:
    """(the largest error, its key) over ``keys`` (default: all)."""
    keys = list(errs) if keys is None else list(keys)
    return max(((errs[k], k) for k in keys), default=(0.0, "none"))


def _assignment(experts, capacity: int, n_experts: int):
    """(routed, kept): (T, E) booleans of each token's top-k experts and
    of those whose capacity slot it gets, as `moe._dispatch_combine`
    ranks a (token, k) pair within its expert: by token order, then k."""
    import numpy as np

    t, k = experts.shape
    flat = experts.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_experts)
    starts = np.cumsum(counts) - counts
    rank = np.empty_like(flat)
    rank[order] = np.arange(flat.size) - starts[flat[order]]
    routed = np.zeros((t, n_experts), bool)
    kept = np.zeros((t, n_experts), bool)
    rows = np.repeat(np.arange(t), k)
    routed[rows, flat] = True
    keep = rank < capacity
    kept[rows[keep], flat[keep]] = True
    return routed, kept


def _route_changes(got: list, want: list, cfg) -> list:
    """Per step, over its MoE layers: (tokens whose routed or kept
    experts differ from the unsharded run's, the experts whose tokens
    differ), from the recorded (T, K) expert ids."""
    import numpy as np

    out = []
    for g_step, w_step in zip(got, want):
        tokens, experts = 0, set()
        for g, w in zip(g_step, w_step):
            t, k = w.shape
            capacity = max(int(cfg.capacity_factor * t * k / cfg.num_experts), 2 * k)
            gr, gk = _assignment(g, capacity, cfg.num_experts)
            wr, wk = _assignment(w, capacity, cfg.num_experts)
            diff = (gr != wr) | (gk != wk)
            tokens += int(diff.any(1).sum())
            experts |= set(np.flatnonzero(diff.any(0)).tolist())
        out.append((tokens, sorted(experts)))
    return out


def _unsharded_tracked(cfg, batches: list, micro: int = 1) -> dict:
    """The unsharded f32 run on the card (`_tr_steps`, tracked), with its
    batch in ``micro`` micro-batches where ``micro`` > 1."""
    import torch

    from repro_torch.launch import make_local_mesh
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda", seed=TR["seed"])
    res = _tr_steps(cfg, model, make_local_mesh(device="cuda"), False, batches,
                    remat=False, track=True, micro=micro)
    del model, res["state"]
    torch.cuda.empty_cache()
    return res


def _expert_of(key: str):
    """The expert of a key `_pieces` made for one, else None."""
    path, _, last = key.rpartition("/")
    return int(last[1:]) if path.endswith(TR_EXPERT_LEAVES) else None


def _fmt_worst(errs: dict) -> str:
    """Each part's largest error and its key."""
    return ", ".join(f"{part} {_worst(e)[0]:.2e} ({_worst(e)[1]})"
                     for part, e in errs.items())


def _fmt_flips(flips: dict) -> str:
    """The step-1 sign flips of m: their total and the leaves with most."""
    top = sorted(((n, p) for p, n in flips.items() if n), reverse=True)[:3]
    return (f"{sum(flips.values())} chunks of m's signs differ"
            + (f" ({', '.join(f'{p} {n}' for n, p in top)})" if top else ""))


def train_ranks_part(card: str) -> dict:
    """The training part of the ranks phase (`train_ranks_body` on
    RANKS_WORLD processes on cuda:0 over gloo) against the unsharded runs
    from the same seed on the same batches: f32 parity (every rank's loss
    and gradient norm within TR_METRIC_RTOL; each leaf's moments after
    step 1 within TR_TOL and its parameters and moments after step 2
    within TR_FLOOR_MULT times the floor the unsharded program reaches
    against itself, relative L2 estimated by `leaf_projections`; every
    block two ranks hold the same on both; the step-1 sign flips counted;
    qwen3-moe's routing held to the unsharded run's, its experts that no
    rerouted token touches to llama's bounds);
    the bf16 (1, 2) run's step, optimizer and peak beside the unsharded
    run's, its losses finite and falling, the same first loss under both
    remat policies; each rank's tally of a train step equal op by op to
    the count of that position on a counting mesh, under both policies;
    a rank's profiled matmul FLOPs within TR_FLOP_TOL of its count.
    Returns the ranks' kernel launch counts."""
    import numpy as np
    import torch
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.dryrun import count_cell
    from repro_torch.launch.mesh import make_counting_mesh, run_ranks
    from repro_torch.launch.op_analysis import collective_bytes
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_update

    t_part = time.perf_counter()
    llama = tr_config(TP_ARCH, TR_PARITY_LAYERS, "float32")
    moe = tr_config(RANKS_ARCH, TR_MOE_LAYERS, "float32")
    timing = tr_config(TP_ARCH, TR_TIMING_LAYERS, "bfloat16")
    batches = {"llama": tr_batches(llama, TR_PARITY_STEPS),
               "moe": tr_batches(moe, TR_PARITY_STEPS),
               "timing": tr_batches(timing, TR_TIMING_STEPS)}
    want = {"llama": _unsharded_tracked(llama, batches["llama"]),
            "moe": _unsharded_tracked(moe, batches["moe"]),
            "floor": _unsharded_tracked(llama, batches["llama"], micro=TR_FLOOR_MICRO)}

    # The unsharded bf16 run, timed as the ranks' is.
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    model = build_model(timing, "cuda", seed=TR["seed"])
    one = make_local_mesh(device="cuda")
    alone = _tr_steps(timing, model, one, False, batches["timing"], remat=True,
                      track=False)
    torch.cuda.synchronize()
    alone_peak = torch.cuda.max_memory_allocated() - base
    state = alone.pop("state")
    batch = {"tokens": torch.from_numpy(batches["timing"][0]).cuda()}
    model.requires_grad_(True)
    model.loss(batch, remat=True)[0].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    opt = tr_opt(TR_TIMING_STEPS, timing=True)
    alone_opt_ms = cuda_ms(lambda: adamw_update(model, grads, state, opt), iters=1,
                           warmup=1, repeats=3)
    del model, state, grads
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    got = run_ranks(train_ranks_body, RANKS_WORLD, ROOT / "build" / "train_ranks",
                    batches["llama"], batches["moe"], batches["timing"],
                    device="cuda", timeout_s=RANKS_TIMEOUT_S)
    job_s = time.perf_counter() - t0

    sp = ShapeSpec("train_ranks", TR["seq"], TR["batch"], "train")
    whole = {name: [_sum_blocks([p], ["the unsharded run"], f"ranks train {name}")
                    for p in res["proj"]] for name, res in want.items()}
    # The floor: the unsharded program against itself, its sums in
    # another order.
    floor_metrics = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(
        want["floor"]["metrics"], want["llama"]["metrics"]) for k in ("loss", "grad_norm"))
    floor1 = _key_errors(whole["floor"][0], whole["llama"][0], "ranks train floor")
    floor2 = _key_errors(whole["floor"][-1], whole["llama"][-1], "ranks train floor")
    floor_flips = _flips(whole["floor"][0], whole["llama"][0])
    step2_bound = {part: max(TR_TOL, TR_FLOOR_MULT * _worst(errs)[0])
                   for part, errs in floor2.items()}
    print(f"ranks train floor [{card}]: the unsharded llama3-8b f32 step with its "
          f"batch in {TR_FLOOR_MICRO} micro-batches against the unsharded step: "
          f"loss and grad norm {floor_metrics:.2e} relative; after step 1 "
          f"{_fmt_worst(floor1)}, {_fmt_flips(floor_flips)}; after step "
          f"{TR_PARITY_STEPS} {_fmt_worst(floor2)}; so the ranks' step-"
          f"{TR_PARITY_STEPS} bounds are " + ", ".join(
              f"{k} {v:.3e}" for k, v in step2_bound.items())
          + f" ({TR_FLOOR_MULT} x the floor, at least {TR_TOL})")
    problems = [f"the floor's {part} after step 1 is {_worst(errs)[0]!r} from the "
                f"unsharded run's" for part, errs in floor1.items()
                if not _worst(errs)[0] <= TR_TOL]
    for name, shape, zero1 in [("llama", s, z) for s, z in TR_PARITY_MESHES] + [
            ("moe", (1, 2), False)]:
        members = [r[name, shape] for r in got if (name, shape) in r]
        if len(members) != shape[0] * shape[1]:
            fail(f"ranks train {name} {shape}: {len(members)} ranks answered")
        what = f"ranks train {name} {shape}"
        ref = want[name]
        where = [f"rank {tuple(m['coord'].values())}" for m in members]
        metric_err = [0.0] * TR_PARITY_STEPS
        for m in members:
            for i, (g, w) in enumerate(zip(m["metrics"], ref["metrics"])):
                tol = TR_MOE_STEP2["metrics"] if name == "moe" and i else TR_METRIC_RTOL
                for k in ("loss", "grad_norm"):
                    err = abs(g[k] - w[k]) / abs(w[k])
                    metric_err[i] = max(metric_err[i], err)
                    if not err <= tol:
                        problems.append(f"{what}: step {i + 1}'s {k} {g[k]!r} "
                                        f"against the unsharded {w[k]!r}")
        got_steps = [_sum_blocks([m["proj"][i] for m in members], where, what)
                     for i in range(TR_PARITY_STEPS)]
        step1 = _key_errors(_merged(got_steps[0]), _merged(whole[name][0]), what)
        last = _key_errors(got_steps[-1], whole[name][-1], what)
        last_leaves = _key_errors(_merged(got_steps[-1]), _merged(whole[name][-1]), what)
        flips = _flips(got_steps[0], whole[name][0])
        for part, errs in step1.items():
            err, key = _worst(errs)
            if not err <= TR_TOL:
                problems.append(f"{what}: the moments {part} of {key} after step 1 "
                                f"are {err!r} (relative L2) from the unsharded run's")
        gates = []  # (label, part, keys, bound, errors) after the last step
        route = ""
        if name == "moe":
            routes = [m["routes"] for m in members]
            if any(not all(np.array_equal(a, b) for a, b in zip(
                    sum(r, []), sum(routes[0], []))) for r in routes[1:]):
                problems.append(f"{what}: the ranks routed the same tokens differently")
            changes = _route_changes(routes[0], ref["routes"], moe)
            touched = set().union(*(set(e) for _, e in changes))
            for i, (n, _) in enumerate(changes):
                if not n <= TR_MOE_MAX_CHANGED * TR["batch"] * TR["seq"]:
                    problems.append(f"{what}: step {i + 1} routes {n} tokens otherwise "
                                    "than the unsharded run")
            for part, errs in last.items():
                clean = [k for k in errs if _expert_of(k) not in (None, *touched)]
                gates.append(("untouched experts", part, clean,
                              step2_bound[part] if part == "p" else TR_MOE_EXPERTS, errs))
                gates.append(("whole leaves", part, list(last_leaves[part]),
                              TR_MOE_STEP2["p" if part == "p" else "moments"],
                              last_leaves[part]))
            hit = [k for k in last["m"] if _expert_of(k) in touched]
            dense = [k for k in last_leaves["m"] if not k.endswith(TR_EXPERT_LEAVES)]
            route = (f"; tokens routed otherwise than unsharded at each step "
                     f"{[n for n, _ in changes]} of {TR['batch'] * TR['seq']}, "
                     f"touching experts {sorted(touched)}; after step {TR_PARITY_STEPS}: "
                     + "; ".join(f"{label} " + ", ".join(
                         f"{part} {_worst(errs, keys)[0]:.2e}"
                         for lab, part, keys, _, errs in gates if lab == label)
                         for label in dict.fromkeys(g[0] for g in gates))
                     + f"; the rerouted tokens' experts m {_worst(last['m'], hit)[0]:.2e} "
                     f"({_worst(last['m'], hit)[1]}); the router p "
                     f"{last_leaves['p']['layers/moe/router']:.2e}, m "
                     f"{last_leaves['m']['layers/moe/router']:.2e}, v "
                     f"{last_leaves['v']['layers/moe/router']:.2e}; the dense leaves m "
                     f"{_worst(last_leaves['m'], dense)[0]:.2e} "
                     f"({_worst(last_leaves['m'], dense)[1]})")
        else:
            gates = [("every leaf", part, list(errs), step2_bound[part], errs)
                     for part, errs in last.items()]
        for label, part, keys, bound, errs in gates:
            err, key = _worst(errs, keys)
            if not err <= bound:
                problems.append(f"{what}: {part} of {key} ({label}) after step "
                                f"{TR_PARITY_STEPS} is {err!r} (relative L2) from the "
                                f"unsharded run's, beyond {bound:.3e}")
        cfg = llama if name == "llama" else moe
        for m in members:
            mesh = make_counting_mesh(shape, position=tuple(m["coord"].values()))
            counted = count_cell(cfg, sp, remat=False, mesh=mesh, zero1=zero1)
            for tally in m["tallies"]:
                if tally["count"] != counted["collective_counts"] or \
                        collective_bytes(tally) != counted["collectives"]:
                    fail(f"{what}: a rank's tally "
                         f"{tally['count']} / {collective_bytes(tally)} is not the "
                         f"counting mesh's {counted['collective_counts']} / "
                         f"{counted['collectives']}")
        tally = members[0]["tallies"][0]
        print(f"ranks train {name} f32 {shape}{' ZeRO-1' if zero1 else ''} [{card}]: "
              f"{len(members)} ranks, {TR_PARITY_STEPS} steps of {TR['batch']} x "
              f"{TR['seq']} tokens; losses "
              f"{[round(x['loss'], 6) for x in members[0]['metrics']]} (unsharded "
              f"{[round(x['loss'], 6) for x in ref['metrics']]}), loss and grad norm "
              f"{', '.join(f'{e:.2e}' for e in metric_err)} relative by step; after "
              f"step 1 {_fmt_worst(step1)} (bound {TR_TOL}), {_fmt_flips(flips)}; "
              f"after step {TR_PARITY_STEPS} {_fmt_worst(last)}{route}; every block "
              f"held by two ranks the same on both; a step's collectives "
              f"{_fmt_tally(tally)}, reduce-scatter "
              f"{tally['count'].get('reduce-scatter', 0)} "
              f"({tally['bytes'].get('reduce-scatter', 0)} B); equal to the "
              "counting mesh's")
    if problems:
        fail("; ".join(problems))

    full = [r["timing_full"] for r in got[:2]]
    save = [r["timing_save"] for r in got[:2]]
    alone_s = float(np.median(alone["seconds"][1:]))
    alone_losses = [m["loss"] for m in alone["metrics"]]
    half = TR_TIMING_STEPS // 2
    for rank, (f, s) in enumerate(zip(full, save)):
        # Falling as the train phase holds it: the last half's mean below
        # the first half's (each step sees another batch).
        losses = [m["loss"] for m in f["metrics"]]
        if not (np.isfinite(losses).all()
                and np.mean(losses[half:]) < np.mean(losses[:half])):
            fail(f"ranks train bf16: rank {rank}'s losses {losses} are not finite "
                 "and falling")
        if s["metrics"][0]["loss"] != f["metrics"][0]["loss"]:
            fail(f"ranks train bf16: rank {rank}'s first loss under "
                 "save_collectives differs from full's")
        for policy, res in (("full", f), ("save_collectives", s)):
            cfg = tr_config(TP_ARCH, TR_TIMING_LAYERS, "bfloat16", policy)
            mesh = make_counting_mesh((1, 2), position=tuple(res["coord"].values()))
            counted = count_cell(cfg, sp, remat=True, mesh=mesh, zero1=False)
            for tally in res["tallies"]:
                if tally["count"] != counted["collective_counts"] or \
                        collective_bytes(tally) != counted["collectives"]:
                    fail(f"ranks train bf16 {policy}: rank {rank}'s tally "
                         f"{tally['count']} is not the counting mesh's "
                         f"{counted['collective_counts']}")
        with set_checkpoint_early_stop(False):
            counted = count_cell(timing, sp, remat=True, zero1=False, mesh=make_counting_mesh(
                (1, 2), position=tuple(f["coord"].values())))["flops_matmul"]
        ferr = abs(f["prof_flops"] - counted) / counted
        if not ferr <= TR_FLOP_TOL:
            fail(f"ranks train bf16: rank {rank}'s profiler matmul FLOPs "
                 f"{f['prof_flops']} are {ferr:.3e} from its count {counted}")
        step_s = float(np.median(f["seconds"][1:]))
        print(f"ranks train bf16 ({TR_TIMING_LAYERS} layers) (1, 2) rank {rank} "
              f"[{card}]: full remat: step {step_s * 1e3:.3f} ms (median of steps "
              f"2-{TR_TIMING_STEPS}; unsharded {alone_s * 1e3:.3f} ms), optimizer "
              f"{f['opt_ms']:.3f} ms alone (unsharded {alone_opt_ms:.3f} ms), peak "
              f"{f['peak_bytes'] / 2**30:.3f} GiB ({f['peak_bytes'] / alone_peak:.3f} "
              f"of the unsharded {alone_peak / 2**30:.3f} GiB); losses "
              f"{[round(m['loss'], 4) for m in f['metrics']]} (unsharded "
              f"{[round(x, 4) for x in alone_losses]}); a step's "
              f"collectives {_fmt_tally(f['tallies'][0])}; save_collectives: step "
              f"{float(np.median(s['seconds'][1:])) * 1e3:.3f} ms (median of steps "
              f"2-{TR_SAVE_STEPS}), collectives "
              f"{_fmt_tally(s['tallies'][0])}; profiler matmul FLOPs "
              f"{f['prof_flops']:.6e}, counted {counted:.6e} ({ferr:.2e} apart, "
              f"bound {TR_FLOP_TOL})")
    drop = full[0]["tallies"][0]["count"]["_count"] - save[0]["tallies"][0]["count"]["_count"]
    if not drop > 0:
        fail("ranks train bf16: save_collectives issued no fewer collectives "
             "than full")
    print(f"ranks train [{card}]: save_collectives issues {drop} collectives a "
          f"step fewer than full ({full[0]['tallies'][0]['count']['_count']} -> "
          f"{save[0]['tallies'][0]['count']['_count']}); the rank job "
          f"{job_s:.1f} s, the part {time.perf_counter() - t_part:.1f} s. One card "
          "over gloo shows the sharded training's correctness, memory and "
          "collectives, not what it gains across cards")
    return {name: sum(r["launches"][name] for r in got) for name in got[0]["launches"]}


# The families part of the ranks phase (`tp_families_part`): the MLA,
# Mamba-2, hybrid, VLM and audio families at their published widths, each
# with its depth cut (deepseek-v2-lite: its dense layer and one MoE
# layer; mamba2-780m: 2 of 48 layers; hymba-1.5b: one SWA and one global
# layer; llama-3.2-vision-11b: one self and one cross layer;
# whisper-medium: 2 encoder and 2 decoder layers), f32, from a
# torch.Generator seeded FAM["seed"], served on gloo ranks of cuda:0 on
# (1, 4) and (1, 2): every leaf and every cache leaf the planner's block
# (the KV caches of a 40-slot cache split by sequence where the KV heads
# do not divide the model axis: hymba's 5, the VLM's 8 on 4 ranks; the
# MLA latents always), against the unsharded model from the same seed;
# then one f32 train step of deepseek-v2-lite and mamba2-780m on (1, 2).
FAM_ARCHS = {
    "deepseek-v2-lite-16b": dict(num_layers=2, first_dense_layers=1),
    "mamba2-780m": dict(num_layers=2),
    "hymba-1.5b": dict(num_layers=2, global_attn_layers=(1,)),
    "llama-3.2-vision-11b": dict(num_layers=2, cross_attn_every=1),
    "whisper-medium": dict(num_layers=2, encoder_layers=2),
}
FAM_MESHES = ((1, 4), (1, 2))
FAM_TRAIN = ("deepseek-v2-lite-16b", "mamba2-780m")  # one step on (1, 2)
FAM = dict(batch=4, prompt_len=32, gen_len=8, train_seq=128, seed=0)
FAM_TOL = 1e-5  # of max|logit|, as RANKS_TOL
FAM_TRAIN_RTOL = 1e-5  # loss and gradient norm, relative
# Where the unsharded model's own floor is higher, the bounds are this
# many times it: the unsharded run against itself with its weights moved
# by one rounding (`_perturb`), measured in the same run.  A random
# Mamba-2 stack is that sensitive from 4 layers on: its f32 gradient norm
# moves by ~6e-6 under one rounding of one weight, as much as the ranks'
# other order of sums moves it (`tools/probe_tp_conditioning.py`); at 2
# layers, 100x less.
FAM_FLOOR_MULT = 4


def fam_config(arch: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), param_dtype="float32",
                               activation_dtype="float32", **FAM_ARCHS[arch])


def _fam_inputs(cfg) -> dict:
    """A family's serve prompts (and frontend) and its train batch."""
    import numpy as np

    prompts, frontend = serve_prompts(cfg, FAM["batch"], FAM["prompt_len"],
                                      FAM["seed"])
    rng = np.random.default_rng(FAM["seed"] + 1)
    train = {"tokens": rng.integers(0, cfg.vocab_size, (FAM["batch"], FAM["train_seq"]))
             .astype(np.int32)}
    if frontend is not None:
        train["frontend"] = rng.standard_normal(frontend.shape).astype(np.float32)
    return dict(prompts=prompts, frontend=frontend, train=train)


def _fam_train(cfg, model, mesh, train: dict) -> dict:
    """One f32 train step's loss and gradient norm."""
    import torch

    from repro_torch.launch.steps import make_train_step

    bundle = make_train_step(cfg, mesh, opt=tr_opt(1), remat=False, zero1=False)
    batch = {k: torch.as_tensor(v, device=model.device) for k, v in train.items()}
    _, m = bundle.jit_for(None)(model, bundle.init_opt(model), batch)
    return {k: float(m[k]) for k in ("loss", "grad_norm")}


def tp_families_body(inputs: dict) -> dict:
    """What each of RANKS_WORLD ranks runs for the families part: each
    family's model served on each of FAM_MESHES that holds the rank
    (`_served`, the collectives' tally, the rank's peak memory and the
    bytes of its parameters and caches), then one train step of each of
    FAM_TRAIN on (1, 2).  Returns the results and this process's kernel
    launch counts."""
    import gc

    import torch

    from repro_torch.launch import serve_batch
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.models import build_model
    from repro_torch.sharding import ParamShard

    counters = launch_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    meshes = {shape: make_rank_mesh(shape, device="cuda",
                                    ranks=range(shape[0] * shape[1]))
              for shape in FAM_MESHES}
    kw = dict(keep_logits=True, print_fn=lambda *_: None)
    cache_len = FAM["prompt_len"] + FAM["gen_len"]
    out = {}
    for arch in FAM_ARCHS:
        cfg, inp = fam_config(arch), inputs[arch]
        for shape, mesh in meshes.items():
            if not mesh.is_member:
                continue
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model = build_model(cfg, mesh.device, seed=FAM["seed"],
                                shard=ParamShard.of(mesh))
            res = serve_batch(cfg, mesh, inp["prompts"], FAM["gen_len"],
                              frontend=inp["frontend"], model=model, **kw)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            caches = model.init_caches(FAM["batch"], cache_len)
            out[arch, shape] = dict(
                _served(res, mesh), coord=mesh.coord, collectives=res["collectives"],
                peak_bytes=peak, param_bytes=nbytes(*model.parameters()),
                cache_bytes=nbytes(*_tree_leaves(caches)))
            del model, res, caches
            torch.cuda.empty_cache()
        mesh = meshes[(1, 2)]
        if arch in FAM_TRAIN and mesh.is_member:
            model = build_model(cfg, mesh.device, seed=FAM["seed"],
                                shard=ParamShard.of(mesh))
            out[arch, "train"] = _fam_train(cfg, model, mesh, inp["train"])
            del model
            torch.cuda.empty_cache()
    out["launches"] = {name: getattr(mod, attr)
                       for name, (mod, attr) in counters.items()}
    return out


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def _planned_bytes(cfg, shape, coord: dict,
                   head_dim_fallback: bool = False) -> tuple[int, int]:
    """The bytes of the planner's blocks at ``coord`` of a (data, model)
    mesh of ``shape``: of every parameter leaf (``plan_params``, under
    ``head_dim_fallback``) and of every cache leaf of the serve's caches
    (``plan_caches``), each block cut by `shard_slices`."""
    import math

    from repro_torch.models import Model
    from repro_torch.sharding import (ShardingPlan, plan_caches, plan_params,
                                      shard_slices)

    mesh_shape = {"data": shape[0], "model": shape[1]}
    meta = Model(cfg, "meta")

    def total(specs, leaves) -> int:
        if isinstance(leaves, dict):
            return sum(total(specs[k], leaves[k]) for k in leaves)
        block = shard_slices(specs, leaves.shape, mesh_shape, coord)
        return math.prod(len(range(n)[b]) for n, b in
                         zip(leaves.shape, block)) * leaves.element_size()

    import torch

    params: dict = {}
    for keys, (whole, items) in meta.reference_leaves().items():
        node = params
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(whole, dtype=items[0][1].dtype, device="meta")
    plan = ShardingPlan(mesh_shape=mesh_shape,
                        shard_head_dim_fallback=head_dim_fallback)
    caches = meta.init_caches(FAM["batch"], FAM["prompt_len"] + FAM["gen_len"])
    return (total(plan_params(plan, params), params),
            total(plan_caches(ShardingPlan(mesh_shape=mesh_shape), caches), caches))


def _perturb(model) -> None:
    """Move each weight of ``model`` by about one f32 rounding: times 1 +
    2^-24 x a standard normal drawn from a generator seeded FAM["seed"]
    (about a third of the elements move by one unit in the last place)."""
    import torch

    gen = torch.Generator(device=model.device).manual_seed(FAM["seed"])
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + 2.0 ** -24 * torch.randn(p.shape, generator=gen,
                                                 device=p.device))


def _fam_counted(cfg, inp: dict, shape, coord: dict,
                 head_dim_fallback: bool = False) -> dict:
    """The tally of the serve's prefill and of a decode step at ``coord``
    on a counting mesh (the meta device), the model and the serve step
    under ``head_dim_fallback``."""
    import torch

    from repro_torch.launch.mesh import make_counting_mesh
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Model
    from repro_torch.sharding import ParamShard

    mesh = make_counting_mesh(shape, position=(coord["data"], coord["model"]))
    model = Model(cfg, "meta", ParamShard.of(mesh, head_dim_fallback))
    batch = {"tokens": torch.empty(inp["prompts"].shape, dtype=torch.int32,
                                   device="meta")}
    if inp["frontend"] is not None:
        batch["frontend"] = torch.empty(inp["frontend"].shape, device="meta")
    cache_len = FAM["prompt_len"] + FAM["gen_len"]
    mark = mesh.copy_tally()
    _, caches = make_prefill_step(cfg, mesh, cache_len).jit_for(None)(model, batch)
    prefill = mesh.tally_since(mark)
    tok = torch.empty((FAM["batch"], 1), dtype=torch.int32, device="meta")
    mark = mesh.copy_tally()
    make_serve_step(cfg, mesh, cache_len, shard_head_dim_fallback=head_dim_fallback
                    ).jit_for(None)(model, caches, tok, tok)
    return {"prefill": prefill, "decode": mesh.tally_since(mark)}


def tp_families_part(card: str) -> dict:
    """The families part of the ranks phase (`tp_families_body` on
    RANKS_WORLD processes on cuda:0 over gloo) against the unsharded model
    of each family from the same seed: on each of FAM_MESHES, tokens
    equal and logits within FAM_TOL of max|logit| (or FAM_FLOOR_MULT
    times the unsharded model's floor, where that is higher); each rank's parameter
    and cache bytes the sum of the planner's blocks at its position
    (`_planned_bytes`); each rank's tally of the prefill and of a decode
    step equal op by op to a counting mesh's at its position; prefill,
    decode and peak memory printed beside the unsharded run's.  One
    train step of each of FAM_TRAIN on (1, 2): loss and gradient norm
    within FAM_TRAIN_RTOL of the unsharded step's (or FAM_FLOOR_MULT
    times its floor).  Returns the ranks' kernel launch counts."""
    import torch

    from repro_torch.launch import make_local_mesh, serve_batch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import build_model

    t_part = time.perf_counter()
    one = make_local_mesh(device="cuda")
    kw = dict(keep_logits=True, print_fn=lambda *_: None)
    inputs, want = {}, {}
    for arch in FAM_ARCHS:
        cfg = fam_config(arch)
        inputs[arch] = inp = _fam_inputs(cfg)
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model = build_model(cfg, "cuda", seed=FAM["seed"])
        res = serve_batch(cfg, one, inp["prompts"], FAM["gen_len"],
                          frontend=inp["frontend"], model=model, **kw)
        torch.cuda.synchronize()
        want[arch] = w = dict(res, peak_bytes=torch.cuda.max_memory_allocated() - base,
                              param_bytes=nbytes(*model.parameters()))
        if arch in FAM_TRAIN:
            w["train"] = _fam_train(cfg, model, one, inp["train"])
        del model
        # The floor: the same runs with the weights moved by one rounding.
        model = build_model(cfg, "cuda", seed=FAM["seed"])
        _perturb(model)
        moved = serve_batch(cfg, one, inp["prompts"], FAM["gen_len"],
                            frontend=inp["frontend"], model=model, **kw)["logits"]
        w["floor"] = float((moved - res["logits"]).abs().max()
                           / res["logits"].abs().max())
        w["tol"] = max(FAM_TOL, FAM_FLOOR_MULT * w["floor"])
        if arch in FAM_TRAIN:
            step = _fam_train(cfg, model, one, inp["train"])
            w["train_floor"] = max(abs(step[k] - w["train"][k]) / abs(w["train"][k])
                                   for k in ("loss", "grad_norm"))
            w["train_tol"] = max(FAM_TRAIN_RTOL, FAM_FLOOR_MULT * w["train_floor"])
        del model, res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    got = run_ranks(tp_families_body, RANKS_WORLD, ROOT / "build" / "fam_ranks",
                    inputs, device="cuda", timeout_s=RANKS_TIMEOUT_S)
    job_s = time.perf_counter() - t0

    for arch in FAM_ARCHS:
        cfg, w = fam_config(arch), want[arch]
        print(f"ranks families {arch} ({cfg.num_layers} layers, f32) unsharded "
              f"[{card}]: prefill {w['prefill_s'] * 1e3:.3f} ms ({FAM['batch']} x "
              f"{FAM['prompt_len']} tokens); decode {w['decode_s_per_tok'] * 1e3:.3f} "
              f"ms a token; peak memory {w['peak_bytes'] / 2**30:.3f} GiB; "
              f"parameters {w['param_bytes'] / 2**30:.3f} GiB; its floor (the "
              f"weights moved by one rounding) {w['floor']:.3e} of max|logit|, "
              f"so the bound {w['tol']:.3e}")
        for shape in FAM_MESHES:
            members = [r[arch, shape] for r in got if (arch, shape) in r]
            if len(members) != shape[0] * shape[1]:
                fail(f"ranks families {arch} {shape}: {len(members)} ranks answered")
            _held_to(f"families {arch} {shape}", card, members, w, w["tol"])
            for m in members:
                params, caches = _planned_bytes(cfg, shape, m["coord"])
                if (m["param_bytes"], m["cache_bytes"]) != (params, caches):
                    fail(f"ranks families {arch} {shape} {m['coord']}: holds "
                         f"{m['param_bytes']} B of parameters and "
                         f"{m['cache_bytes']} B of caches, the planner's blocks "
                         f"{params} and {caches}")
                counted = _fam_counted(cfg, inputs[arch], shape, m["coord"])
                if m["collectives"] != counted:
                    fail(f"ranks families {arch} {shape} {m['coord']}: the tally "
                         f"{m['collectives']} is not the counting mesh's {counted}")
            m = members[0]
            print(f"ranks families {arch} {shape} rank 0 [{card}]: prefill "
                  f"{m['prefill_s'] * 1e3:.3f} ms; decode "
                  f"{m['decode_s_per_tok'] * 1e3:.3f} ms a token; peak memory "
                  f"{m['peak_bytes'] / 2**30:.3f} GiB "
                  f"({m['peak_bytes'] / w['peak_bytes']:.3f} of unsharded); "
                  f"parameters {m['param_bytes'] / 2**30:.3f} GiB, caches "
                  f"{m['cache_bytes'] / 2**20:.3f} MiB, the planner's blocks; "
                  f"tallies equal the counting mesh's; a decode step: "
                  f"{_fmt_tally(m['collectives']['decode'])}; the prefill: "
                  f"{_fmt_tally(m['collectives']['prefill'])}")
        if arch in FAM_TRAIN:
            ref = w["train"]
            for r in got[:2]:
                step = r[arch, "train"]
                for k in ("loss", "grad_norm"):
                    rel = abs(step[k] - ref[k]) / abs(ref[k])
                    if not rel <= w["train_tol"]:
                        fail(f"ranks families {arch} train (1, 2): {k} "
                             f"{step[k]!r} is {rel:.3e} from the unsharded "
                             f"{ref[k]!r}, beyond {w['train_tol']:.3e}")
            step = got[0][arch, "train"]
            rel = max(abs(step[k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm"))
            print(f"ranks families {arch} train (1, 2) [{card}]: loss "
                  f"{step['loss']!r} (unsharded {ref['loss']!r}), gradient norm "
                  f"{step['grad_norm']!r} (unsharded {ref['grad_norm']!r}): "
                  f"{rel:.3e} relative; the floor (the weights moved by one "
                  f"rounding) {w['train_floor']:.3e}, so the bound "
                  f"{w['train_tol']:.3e}")
    print(f"ranks families [{card}]: the rank job {job_s:.1f} s, the part "
          f"{time.perf_counter() - t_part:.1f} s")
    return {name: sum(r["launches"][name] for r in got) for name in got[0]["launches"]}


# The checkpoint and head-dim parts of the ranks phase (`ckpt_hd_part`,
# one job of RANKS_WORLD ranks on cuda:0 over gloo): hymba-1.5b at its
# published width (d_model 1,600, 25 heads, 5 KV heads, head_dim 64, d_ff
# 5,504, vocab 32,001), one SWA and one global layer (FAM_ARCHS), f32.
# The checkpoint part trains it with `train_loop` on (1, 2), CK["steps"]
# steps of CK["batch"] x CK["seq"] tokens with a checkpoint every
# CK["every"] (the ranks gather the whole tree, the all-zero position
# writes), a run stopped at CK["every"] and resumed on (1, 2) against the
# straight run, and that step restored on CK_RESTORE_MESHES and on one
# card.  The head-dim part serves it with shard_head_dim_fallback=True on
# FAM_MESHES (its 25 and 5 heads divide neither axis, its head_dim of 64
# both), as the families part serves it without the flag.
CK = dict(batch=4, seq=128, steps=4, every=2, lr=3e-4, seed=0)
CK_RESTORE_MESHES = ((1, 4), (2, 2))
HD_ARCH = "hymba-1.5b"
HD_LEAVES = ("attn.wq", "attn.wk", "attn.wv", "attn.wo")


def _leaf_prints(model, state, mesh_info) -> dict:
    """By leaf path: the block of the whole stacked leaf the model holds
    and its moments' (`RankLeaf`), and a `fingerprint` of the parameter
    block (its layers stacked) and of each moment."""
    import torch

    from repro_torch.optim.adamw import rank_leaves

    named = dict(model.named_parameters())
    out = {}
    for leaf in rank_leaves(model, mesh_info):
        mine = [named[n].detach() for n in leaf.names]
        p = torch.stack(mine).reshape(*leaf.lead, *mine[0].shape) if leaf.lead \
            else mine[0]
        out[leaf.path] = dict(
            block=tuple(slice(0, n) for n in leaf.lead) + leaf.layer_block,
            moment_block=leaf.moment_block, p=fingerprint(p),
            m=fingerprint(state["m"][leaf.path]), v=fingerprint(state["v"][leaf.path]))
    return out


def _ckpt_ranks(cfg, meshes: dict, store: Path) -> dict:
    """The checkpoint part on this rank (`ckpt_hd_body`): on (1, 2) the
    straight run (checkpoints under ``store / "straight"``), the run
    stopped at CK["every"] (its checkpoint under ``store / "resume"``)
    with the fingerprints of what the rank held there, and the run
    resumed from it; then that step restored on each of
    CK_RESTORE_MESHES that holds the rank: the rank reads the committed
    step once (``read_s``) and cuts its blocks for each mesh
    (``seconds``: the model's allocation and the cut)."""
    import torch
    import torch.distributed as dist

    from repro_torch.interop import rank_state_from, state_template
    from repro_torch.launch.mesh import batch_axes_of
    from repro_torch.launch.train import train_loop
    from repro_torch.models import Model
    from repro_torch.runtime import CheckpointManager
    from repro_torch.sharding import ParamShard

    kw = dict(steps=CK["steps"], batch=CK["batch"], seq=CK["seq"], lr=CK["lr"],
              seed=CK["seed"], ckpt_every=CK["every"], print_fn=lambda *_: None)
    out = {}
    mesh = meshes[(1, 2)]
    if mesh.is_member:
        straight = train_loop(cfg, mesh, ckpt_dir=store / "straight", **kw)
        del straight["model"], straight["opt_state"]
        torch.cuda.empty_cache()
        stopped = train_loop(cfg, mesh, ckpt_dir=store / "resume",
                             stop_at=CK["every"], **kw)
        held = _leaf_prints(stopped["model"], stopped["opt_state"],
                            (mesh, batch_axes_of(mesh)))
        del stopped["model"], stopped["opt_state"]
        torch.cuda.empty_cache()
        resumed = train_loop(cfg, mesh, ckpt_dir=store / "resume", resume=True, **kw)
        del resumed["model"], resumed["opt_state"]
        torch.cuda.empty_cache()
        out["train"] = dict(coord=mesh.coord, straight=straight, stopped=stopped,
                            resumed=resumed, held=held)
    dist.barrier()  # every checkpoint is on disk
    t0 = time.perf_counter()
    state, _ = CheckpointManager(store / "resume").restore(
        state_template(Model(cfg, "meta")), step=CK["every"])
    out["read_s"] = time.perf_counter() - t0
    for shape in CK_RESTORE_MESHES:
        mesh = meshes[shape]
        if not mesh.is_member:
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = Model(cfg, mesh.device, ParamShard.of(mesh))
        minfo = (mesh, batch_axes_of(mesh))
        opt = rank_state_from(model, state, minfo)
        torch.cuda.synchronize()
        out[shape] = dict(coord=mesh.coord, step=int(opt["step"]),
                          seconds=time.perf_counter() - t0,
                          held=_leaf_prints(model, opt, minfo))
        del model, opt
        torch.cuda.empty_cache()
    del state
    dist.barrier()  # the next part's timings start together
    return out


def _hd_ranks(cfg, meshes: dict, inp: dict) -> dict:
    """The head-dim part on this rank (`ckpt_hd_body`): the model built
    from FAM["seed"] with the planner's head-dim blocks, served with
    shard_head_dim_fallback=True on each of FAM_MESHES that holds the
    rank: `_served`, the tally, the parameter bytes and a `fingerprint`
    of each attention leaf (HD_LEAVES)."""
    import torch

    from repro_torch.launch import serve_batch
    from repro_torch.models import build_model
    from repro_torch.sharding import ParamShard

    out = {}
    for shape in FAM_MESHES:
        mesh = meshes[shape]
        if not mesh.is_member:
            continue
        model = build_model(cfg, mesh.device, seed=FAM["seed"],
                            shard=ParamShard.of(mesh, head_dim_fallback=True))
        res = serve_batch(cfg, mesh, inp["prompts"], FAM["gen_len"], model=model,
                          keep_logits=True, print_fn=lambda *_: None)
        out[shape] = dict(
            _served(res, mesh), coord=mesh.coord, collectives=res["collectives"],
            param_bytes=nbytes(*model.parameters()),
            num_params=sum(p.numel() for p in model.parameters()),
            digests={n: fingerprint(p) for n, p in model.named_parameters()
                     if n.endswith(HD_LEAVES)})
        del model, res
        torch.cuda.empty_cache()
    return out


def ckpt_hd_body(inp: dict, store: str) -> dict:
    """What each of RANKS_WORLD ranks runs for the checkpoint and head-dim
    parts (`_ckpt_ranks`, `_hd_ranks`).  Returns their results and this
    process's kernel launch counts."""
    from repro_torch.launch.mesh import make_rank_mesh

    counters = launch_counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    shapes = dict.fromkeys(((1, 2),) + CK_RESTORE_MESHES + FAM_MESHES)
    meshes = {shape: make_rank_mesh(shape, device="cuda",
                                    ranks=range(shape[0] * shape[1]))
              for shape in shapes}
    cfg = fam_config(HD_ARCH)
    out = {"ckpt": _ckpt_ranks(cfg, meshes, Path(store)),
           "hd": _hd_ranks(cfg, meshes, inp)}
    out["launches"] = {name: getattr(mod, attr)
                       for name, (mod, attr) in counters.items()}
    return out


def _check_ckpt(card: str, cfg, got: list, store: Path) -> None:
    """The checkpoint part's gates (`ckpt_hd_part`): the resumed losses the
    straight run's, bitwise; every restored rank's blocks, and the (1, 2)
    ranks' blocks at the stop, the blocks of the checkpoint restored on
    one card (by `fingerprint`)."""
    import torch

    from repro_torch.interop import rank_state_from, reference_state, state_template
    from repro_torch.models import Model
    from repro_torch.runtime import CheckpointManager

    runs = [r["ckpt"]["train"] for r in got if "train" in r["ckpt"]]
    if len(runs) != 2:
        fail(f"ranks checkpoint: {len(runs)} ranks trained on (1, 2)")
    for r in runs:
        straight, first, rest = r["straight"], r["stopped"], r["resumed"]
        if first["losses"] + rest["losses"] != straight["losses"]:
            fail(f"ranks checkpoint {r['coord']}: stopped at {CK['every']} and "
                 f"resumed, the losses {first['losses'] + rest['losses']} are not "
                 f"the straight run's {straight['losses']} bitwise")
        if straight["losses"] != runs[0]["straight"]["losses"]:
            fail("ranks checkpoint: the (1, 2) ranks' losses differ")
    t0 = time.perf_counter()
    model = Model(cfg, "cuda")
    folder = store / "resume" / f"step_{CK['every']:09d}"
    state, step = CheckpointManager(store / "resume").restore(
        state_template(model), step=CK["every"])
    opt = rank_state_from(model, state)
    del state
    torch.cuda.synchronize()
    one_card_s = time.perf_counter() - t0
    params, moments = reference_state(model, opt)
    del model, opt
    torch.cuda.empty_cache()
    holders = [("(1, 2) at the stop", r["coord"], r["held"]) for r in runs]
    for shape in CK_RESTORE_MESHES:
        members = [r["ckpt"][shape] for r in got if shape in r["ckpt"]]
        if len(members) != shape[0] * shape[1]:
            fail(f"ranks checkpoint: {len(members)} ranks restored on {shape}")
        for m in members:
            if m["step"] != CK["every"]:
                fail(f"ranks checkpoint {shape} {m['coord']}: step {m['step']}")
        holders += [(f"{shape} restored", m["coord"], m["held"]) for m in members]
    leaves = 0
    for path in holders[0][2]:
        *keys, name = path.split("/")
        whole = {"p": params, "m": moments["m"], "v": moments["v"]}
        for part, tree in whole.items():
            for k in keys:
                tree = tree[k]
            t = tree[name].to("cuda")
            for what, coord, held in holders:
                leaf = held[path]
                block = leaf["block"] if part == "p" else leaf["moment_block"]
                if fingerprint(t[block]) != leaf[part]:
                    fail(f"ranks checkpoint {what} {coord}: {part} of {path} is "
                         "not its block of the checkpoint restored on one card")
            del t
        leaves += 1
    ckpt_bytes = (folder / "arrays.npz").stat().st_size
    r = runs[0]
    read_s = [x["ckpt"]["read_s"] for x in got]
    cut_s = [m["seconds"] for shape in CK_RESTORE_MESHES
             for m in (x["ckpt"][shape] for x in got if shape in x["ckpt"])]
    writes = r["straight"]["checkpoint_seconds"]["write"]
    print(f"ranks checkpoint {HD_ARCH} ({cfg.num_layers} layers, f32) (1, 2) "
          f"[{card}]: {CK['steps']} steps of {CK['batch']} x {CK['seq']} tokens, "
          f"losses {r['straight']['losses']}; stopped at {CK['every']} and "
          "resumed: the straight run's losses bitwise; every (1, 4) and (2, 2) "
          "rank's restored parameters and moments, and the (1, 2) ranks' blocks "
          f"at the stop, are their blocks of the checkpoint restored on one card "
          f"({leaves} leaves, fingerprints)")
    print(f"ranks checkpoint [{card}]: {ckpt_bytes} B a checkpoint "
          f"({ckpt_bytes / 1e9:.3f} GB, params and both moments); gather and host "
          f"copy on the (1, 2) ranks {', '.join(f'{s:.3f}' for s in r['straight']['checkpoint_seconds']['gather'])} s; "
          f"write (rank 0's thread) {', '.join(f'{s:.3f}' for s in writes)} s; "
          f"resume's restore on (1, 2) {r['resumed']['checkpoint_seconds']['restore']:.3f} s; "
          f"for {', '.join(map(str, CK_RESTORE_MESHES))} each rank read the step in "
          f"{min(read_s):.3f}-{max(read_s):.3f} s (the {len(got)} at once) and cut "
          f"its blocks in {min(cut_s):.3f}-{max(cut_s):.3f} s a mesh; restore on "
          f"one card {one_card_s:.3f} s; steps "
          f"{', '.join(f'{s * 1e3:.1f}' for s in r['straight']['step_seconds'])} ms")


def _check_hd(card: str, cfg, got: list, want: dict, digests: dict,
              inp: dict) -> None:
    """The head-dim part's gates (`ckpt_hd_part`)."""
    for shape in FAM_MESHES:
        members = [r["hd"][shape] for r in got if shape in r["hd"]]
        if len(members) != shape[0] * shape[1]:
            fail(f"ranks head-dim {shape}: {len(members)} ranks answered")
        _held_to(f"head-dim {HD_ARCH} {shape}", card, members, want, want["tol"])
        for m in members:
            ref = digests[shape, m["coord"]["model"]]
            if m["digests"] != ref:
                bad = sorted(n for n, d in m["digests"].items() if d != ref.get(n))
                fail(f"ranks head-dim {shape} {m['coord']}: the attention leaves "
                     f"{bad[:4]} are not the planner's head-dim blocks")
            params, _ = _planned_bytes(cfg, shape, m["coord"], head_dim_fallback=True)
            if m["param_bytes"] != params:
                fail(f"ranks head-dim {shape} {m['coord']}: holds "
                     f"{m['param_bytes']} B of parameters, the planner's blocks "
                     f"under the flag {params}")
            counted = _fam_counted(cfg, inp, shape, m["coord"], head_dim_fallback=True)
            if m["collectives"] != counted:
                fail(f"ranks head-dim {shape} {m['coord']}: the tally "
                     f"{m['collectives']} is not the counting mesh's {counted}")
        m = members[0]
        without, _ = _planned_bytes(cfg, shape, m["coord"])
        print(f"ranks head-dim {HD_ARCH} {shape} rank 0 [{card}]: "
              f"{m['num_params'] / 1e6:.1f} M parameters ({m['param_bytes']} B, "
              f"the planner's blocks under shard_head_dim_fallback; "
              f"{without} B without it); every rank's {len(m['digests'])} "
              "attention leaves the planner's head-dim blocks (fingerprints); "
              "tallies equal the counting mesh's; prefill "
              f"{m['prefill_s'] * 1e3:.3f} ms; decode {m['decode_s_per_tok'] * 1e3:.3f} "
              f"ms a token (unsharded {want['decode_s_per_tok'] * 1e3:.3f}); a decode "
              f"step: {_fmt_tally(m['collectives']['decode'])}; the prefill: "
              f"{_fmt_tally(m['collectives']['prefill'])}")


def ckpt_hd_part(card: str) -> dict:
    """The checkpoint and head-dim parts of the ranks phase (`ckpt_hd_body`
    on RANKS_WORLD processes on cuda:0 over gloo), hymba-1.5b at its
    published width: `_check_ckpt` and `_check_hd`, the latter against the
    unsharded model from FAM["seed"] (tokens equal, logits within
    max(FAM_TOL, FAM_FLOOR_MULT x the same-run floor) of max|logit|, each
    rank's attention leaves the unsharded model's head-dim blocks by
    `fingerprint`, its parameter bytes the planner's blocks under the
    flag, its tallies a counting mesh's).  The checkpoints are deleted at
    the end.  Returns the ranks' kernel launch counts."""
    import shutil

    import torch

    from repro_torch.launch import make_local_mesh, serve_batch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import build_model
    from repro_torch.models.model import reference_path
    from repro_torch.sharding import ParamShard

    t_part = time.perf_counter()
    cfg = fam_config(HD_ARCH)
    inp = _fam_inputs(cfg)
    one = make_local_mesh(device="cuda")
    kw = dict(keep_logits=True, print_fn=lambda *_: None)
    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda", seed=FAM["seed"])
    want = serve_batch(cfg, one, inp["prompts"], FAM["gen_len"], model=model, **kw)
    digests = {}
    for shape in FAM_MESHES:
        for i in range(shape[1]):
            shard = ParamShard({"data": shape[0], "model": shape[1]},
                               {"data": 0, "model": i}, head_dim_fallback=True)
            digests[shape, i] = {
                n: fingerprint(p[shard.block(reference_path(n)[0], p.shape)[1]])
                for n, p in model.named_parameters() if n.endswith(HD_LEAVES)}
    _perturb(model)
    moved = serve_batch(cfg, one, inp["prompts"], FAM["gen_len"], model=model,
                        **kw)["logits"]
    want["floor"] = float((moved - want["logits"]).abs().max()
                          / want["logits"].abs().max())
    want["tol"] = max(FAM_TOL, FAM_FLOOR_MULT * want["floor"])
    del model, moved
    torch.cuda.empty_cache()
    print(f"ranks head-dim {HD_ARCH} ({cfg.num_layers} layers, f32) unsharded "
          f"[{card}]: decode {want['decode_s_per_tok'] * 1e3:.3f} ms a token; its "
          f"floor (the weights moved by one rounding) {want['floor']:.3e} of "
          f"max|logit|, so the bound {want['tol']:.3e}")

    store = ROOT / "build" / "ckpt_ranks"
    shutil.rmtree(store, ignore_errors=True)
    t0 = time.perf_counter()
    got = run_ranks(ckpt_hd_body, RANKS_WORLD, ROOT / "build" / "ckhd_ranks",
                    inp, str(store), device="cuda", timeout_s=RANKS_TIMEOUT_S)
    job_s = time.perf_counter() - t0
    _check_hd(card, cfg, got, want, digests, inp)
    _check_ckpt(card, cfg, got, store)
    shutil.rmtree(store)
    print(f"ranks checkpoint and head-dim [{card}]: the rank job {job_s:.1f} s, "
          f"the part {time.perf_counter() - t_part:.1f} s")
    return {name: sum(r["launches"][name] for r in got) for name in got[0]["launches"]}


def ranks_phase(counters, island: dict) -> dict:
    """The rank path on the card (`ranks_body` on RANKS_WORLD processes,
    all on cuda:0 over gloo): qwen3-moe-30b-a3b at full width with 2 layers
    in f32 on (1, 4) and (1, 2) rank meshes against the unsharded model on
    the same weights (tokens equal, logits within RANKS_TOL of
    max|logit|); the (1, 4) mesh's expert leaves moved to the (1, 2) mesh,
    bitwise that mesh's own; the model with 4 layers in bf16 timed on
    (1, 2) beside the unsharded model (finite logits, tokens repeating
    run to run); and the island SA with one island a rank, bitwise the
    batched islands of `island_run`, its avg_hop recomputed here on the
    hop_cost kernel.  Every launch count is set to 0 before and read
    after, the ranks' own included."""
    import numpy as np
    import torch

    from repro_torch.kernels.hop_eval import hop_cost
    from repro_torch.launch import make_local_mesh, serve_batch
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import build_model

    card = card_label()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t_phase = time.perf_counter()
    cfg = ranks_config(RANKS_PARITY_LAYERS, "float32")
    prompts, _ = serve_prompts(cfg, RANKS["batch"], RANKS["prompt_len"],
                               RANKS["seed"])
    one = make_local_mesh(device="cuda")
    kw = dict(keep_logits=True, print_fn=lambda *_: None)
    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda", seed=RANKS["seed"])
    want = serve_batch(cfg, one, prompts, RANKS["gen_len"], model=model, **kw)
    del model
    timing = ranks_config(RANKS_TIMING_LAYERS, "bfloat16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(timing, "cuda", seed=RANKS["seed"])
    serve_batch(timing, one, prompts, RANKS["gen_len"], model=model, **kw)
    alone = serve_batch(timing, one, prompts, RANKS["gen_len"], model=model, **kw)
    alone_peak = torch.cuda.max_memory_allocated()
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    got = run_ranks(ranks_body, RANKS_WORLD, ROOT / "build" / "ranks", prompts,
                    island["traffic"], island["seed"], device="cuda",
                    timeout_s=RANKS_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0

    _held_to("f32 (1, 4)", card, [r["parity_1x4"] for r in got], want, RANKS_TOL)
    _held_to("f32 (1, 2)", card, [r["parity_1x2"] for r in got[:2]], want,
             RANKS_TOL)
    for rank, r in enumerate(got):
        if rank < 2 and not r["remesh"]["exact"]:
            fail(f"ranks remesh: rank {rank}'s experts moved from the 4-rank "
                 "mesh differ from the 2-rank mesh's own")
        if rank >= 2 and not r["remesh"]["none"]:
            fail(f"ranks remesh: rank {rank}, off the 2-rank mesh, holds a block")
    moved = got[0]["remesh"]
    print(f"ranks remesh [{card}]: the experts of {RANKS_PARITY_LAYERS} layers "
          f"moved from (1, 4) to (1, 2) in {moved['seconds']:.3f} s "
          f"({moved['bytes'] / 2**30:.3f} GiB a rank after); bitwise the (1, 2) "
          "mesh's own shards")
    print(f"ranks bf16 ({RANKS_TIMING_LAYERS} layers) unsharded [{card}]: prefill "
          f"{alone['prefill_s'] * 1e3:.3f} ms ({RANKS['batch']} x "
          f"{RANKS['prompt_len']} tokens); decode "
          f"{alone['decode_s_per_tok'] * 1e3:.3f} ms a token, "
          f"{RANKS['batch'] / alone['decode_s_per_tok']:.1f} tokens/s; peak "
          f"memory {alone_peak / 2**30:.3f} GiB (max_memory_allocated)")
    for rank, r in enumerate(got[:2]):
        t = r["timing"]
        if not t["finite"]:
            fail(f"ranks bf16: rank {rank}'s logits are not finite")
        if not np.array_equal(t["tokens"], t["first_tokens"]):
            fail(f"ranks bf16: rank {rank}'s second serve gave other tokens")
        if not np.array_equal(t["tokens"], got[0]["timing"]["tokens"]):
            fail("ranks bf16: the ranks' greedy tokens differ")
        print(f"ranks bf16 ({RANKS_TIMING_LAYERS} layers) (1, 2) rank {rank} "
              f"[{card}]: prefill {t['prefill_s'] * 1e3:.3f} ms (first call "
              f"{t['first_prefill_s'] * 1e3:.3f}); decode "
              f"{t['decode_s_per_tok'] * 1e3:.3f} ms a token (first call "
              f"{t['first_decode_s_per_tok'] * 1e3:.3f}), "
              f"{RANKS['batch'] / t['decode_s_per_tok']:.1f} tokens/s; peak "
              f"memory {t['peak_bytes'] / 2**30:.3f} GiB (max_memory_allocated); "
              f"one decode step's all_reduce alone "
              f"{t['all_reduce_s'] * 1e3:.3f} ms (mean of {RANKS_COLLECTIVES})")
    placement = island["placement"]
    for rank, r in enumerate(got):
        if not np.array_equal(r["island"]["placement"], placement):
            fail(f"ranks island: rank {rank}'s placement differs from the "
                 "batched islands'")
        if r["island"]["avg_hop"] != got[0]["island"]["avg_hop"]:
            fail("ranks island: the ranks' avg_hop differ")
    traffic = island["traffic"]
    x = torch.tensor(placement % SLICE["mesh_w"], dtype=torch.float32, device="cuda")
    y = torch.tensor(placement // SLICE["mesh_w"], dtype=torch.float32,
                     device="cuda")
    hop = float(hop_cost(torch.tensor(traffic, dtype=torch.float32, device="cuda"),
                         x, y)) / max(int(traffic.sum()), 1)
    avg_hop = got[0]["island"]["avg_hop"]
    if not np.isclose(hop, avg_hop, rtol=1e-6, atol=0.0):
        fail(f"ranks island: hop_cost / trace_len = {hop!r} differs from avg_hop "
             f"= {avg_hop!r} beyond rtol 1e-6")
    print(f"ranks island [{card}]: {RANKS_WORLD} ranks, one island each: "
          f"placement bitwise the batched islands'; avg_hop {avg_hop!r} "
          f"(hop_cost {hop!r}); search {got[0]['island']['seconds']:.3f} s "
          f"against {island['seconds']:.3f} s batched")
    in_tp = tp_part(card)
    in_train = train_ranks_part(card)
    in_families = tp_families_part(card)
    in_ckpt_hd = ckpt_hd_part(card)
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    in_ranks = {name: sum(r["launches"][name] for r in got) + in_tp[name]
                + in_train[name] + in_families[name] + in_ckpt_hd[name]
                for name in launches}
    print(f"ranks phase [{card}]: {time.perf_counter() - t_phase:.1f} s "
          f"({ranks_s:.1f} s in the expert-parallel rank job); launches here "
          f"{json.dumps(launches)}, in the ranks {json.dumps(in_ranks)}")
    for name, count in in_ranks.items():
        if count:
            fail(f"ranks: the ranks launched {name} {count} times, not 0")
    for name in PATHS["ranks"]:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the ranks phase")
    for name, want_n in EXACT_LAUNCHES["ranks"].items():
        if launches[name] != want_n:
            fail(f"ranks: {name} launched {launches[name]} times, not {want_n}")
    return {name: launches[name] + in_ranks[name] for name in launches}


# ------------------------------------------------------------- serve phase

SERVE = dict(batch=4, prompt_len=32, gen_len=32)  # the full-width runs
SERVE_CHECK = dict(batch=2, prompt_len=16, gen_len=8)  # card against CPU
INVARIANT_STEPS = 4  # decode steps held to the train forward
INVARIANT_TOL = 2e-2  # of max|logit|: tests/test_models_smoke.py's bound
CPU_TOL, MARGIN = 1e-4, 1e-3  # card vs CPU: logits; decided tokens


def card_label() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def serve_prompts(cfg, batch: int, prompt_len: int, seed: int = 0):
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)
    frontend = None
    if cfg.family in ("vlm", "audio"):
        frontend = rng.standard_normal(
            (batch, cfg.frontend_seq, cfg.frontend_dim)).astype(np.float32)
    return prompts, frontend


def serve(cfg, model, prompts, frontend, gen_len: int) -> dict:
    from repro_torch.launch import make_local_mesh, serve_batch

    return serve_batch(cfg, make_local_mesh(device=model.device), prompts, gen_len,
                       frontend=frontend, model=model, keep_logits=True,
                       print_fn=lambda *_: None)


def check_invariant(name: str, cfg, model, prompts, frontend, res,
                    gated: int = INVARIANT_STEPS + 1) -> list[float]:
    """The serving invariant: the prefill's last logits and the first
    INVARIANT_STEPS decode steps' logits against a ``mode="train"``
    forward over prompt + generated tokens, at the same positions, each
    as a share of max|logit|.  Fails where one of the first ``gated``
    positions (the prefill's first) exceeds INVARIANT_TOL; returns all."""
    import numpy as np
    import torch

    plen, n = prompts.shape[1], INVARIANT_STEPS
    seq = np.concatenate([prompts, res["tokens"][:, :n]], axis=1)
    fe = None if frontend is None else torch.as_tensor(frontend, device=model.device)
    with torch.inference_mode():
        full, _, _ = model(torch.as_tensor(seq, device=model.device), mode="train",
                           frontend=fe)
    want = full[:, plen - 1:plen + n].float().cpu().transpose(0, 1)  # (n+1, B, V)
    errs = ((want - res["logits"][:n + 1]).abs().amax(dim=(1, 2))
            / want.abs().max()).tolist()
    if not max(errs[:gated]) < INVARIANT_TOL:
        fail(f"serve {name}: prefill/decode logits differ from the train "
             f"forward by {fmt_errs(errs)} of max|logit| (bound "
             f"{INVARIANT_TOL} on the first {gated})")
    return errs


def fmt_errs(errs) -> str:
    return "[" + ", ".join(f"{e:.3e}" for e in errs) + "]"


def compare_cpu_card(name: str, cpu_res, card_res) -> float:
    """Card against CPU: every step's logits within CPU_TOL * max|logit|,
    tokens equal wherever the CPU's top-2 margin exceeds MARGIN * max."""
    import torch

    a, b = cpu_res["logits"], card_res["logits"]
    scale = float(a.abs().max())
    err = float((a - b).abs().max()) / scale
    if not err < CPU_TOL:
        fail(f"serve {name}: card logits differ from the CPU's by {err:.3e} of "
             f"max|logit| (bound {CPU_TOL})")
    top2 = torch.topk(a[:-1], 2, dim=-1).values
    decided = ((top2[..., 0] - top2[..., 1]) > MARGIN * scale).numpy().T
    same = cpu_res["tokens"] == card_res["tokens"]
    if not same[decided].all():
        fail(f"serve {name}: card tokens differ from the CPU's where the "
             "top-2 margin decides them")
    return err


def decode_bound_ms(model, caches_bytes: int) -> float:
    """The least time a decode step can take on the card: every weight but
    the embedding table (a decode step gathers B rows of it) plus the
    caches it reads, once, over the memory rate."""
    weights = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                  if n != "embed")
    return (weights + caches_bytes) / H100_BYTES_PER_S * 1e3


def full_width_run(name: str, card: str, decode_gated: bool) -> dict:
    """One architecture at full width and depth in bf16 on the card: init
    from a torch.Generator (seed 0) on the card, greedy serve_batch twice
    (the same tokens bitwise), the serving invariant, and the timings
    beside the decode step's memory bound; then the invariant in f32 on
    the same weights (`f32_invariant`).  Where ``decode_gated`` is false,
    the bf16 decode steps' drift from the train forward is printed, not
    held (only the prefill's position is)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(name)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_model(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, frontend = serve_prompts(cfg, SERVE["batch"], SERVE["prompt_len"])
    first = serve(cfg, model, prompts, frontend, SERVE["gen_len"])
    res = serve(cfg, model, prompts, frontend, SERVE["gen_len"])
    if not (first["tokens"] == res["tokens"]).all():
        fail(f"serve {name}: a second greedy serve_batch gave other tokens")
    toks = res["tokens"]
    if toks.shape != (SERVE["batch"], SERVE["gen_len"]) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"serve {name}: tokens of shape {toks.shape} in "
             f"[{toks.min()}, {toks.max()}]")
    if not torch.isfinite(res["logits"]).all():
        fail(f"serve {name}: non-finite logits")
    gated = INVARIANT_STEPS + 1 if decode_gated else 1
    inv = check_invariant(name, cfg, model, prompts, frontend, res, gated)
    peak = torch.cuda.max_memory_allocated()
    caches = model.init_caches(SERVE["batch"], SERVE["prompt_len"] + SERVE["gen_len"])
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(caches))
    bound = decode_bound_ms(model, cache_bytes)
    dec_ms = res["decode_s_per_tok"] * 1e3
    params = sum(p.numel() for p in model.parameters())
    print(f"serve {name} [{card}]: {params / 1e9:.3f} B parameters "
          f"{cfg.param_dtype}, init {init_s:.3f} s; prefill "
          f"{res['prefill_s'] * 1e3:.3f} ms ({SERVE['batch']} x "
          f"{SERVE['prompt_len']} tokens; first call "
          f"{first['prefill_s'] * 1e3:.3f} ms); decode {dec_ms:.3f} ms a token "
          f"(first call {first['decode_s_per_tok'] * 1e3:.3f}), "
          f"{SERVE['batch'] / res['decode_s_per_tok']:.1f} tokens/s; peak "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated)")
    print(f"serve {name} [{card}]: decode bound {bound:.3f} ms a token "
          f"({(bound * 1e-3 * H100_BYTES_PER_S) / 1e9:.3f} GB of weights and "
          f"caches over 3.35 TB/s): decode at {100 * bound / dec_ms:.1f}% of it; "
          f"greedy tokens repeat bitwise; bf16 prefill/decode vs train forward "
          f"{fmt_errs(inv)} of max|logit| (bound {INVARIANT_TOL} on the first "
          f"{gated})")
    print(f"serve {name} [{card}]: first tokens {toks[0, :8].tolist()}")
    busy_share(name, card, cfg, model, prompts, frontend)
    f32_invariant(name, card, cfg, model, prompts, frontend)
    out = {"name": name, "init_s": init_s, "prefill_ms": res["prefill_s"] * 1e3,
           "decode_ms": dec_ms, "bound_ms": bound, "peak_bytes": peak}
    del model
    torch.cuda.empty_cache()
    return out


def f32_invariant(name: str, card: str, cfg, model, prompts, frontend) -> None:
    """The serving invariant at full width and depth in f32, on the bf16
    model's weights upcast on the card: prefill, INVARIANT_STEPS greedy
    decode steps and the train forward, within INVARIANT_TOL at every
    position."""
    import dataclasses

    import torch

    from repro_torch.models import Model

    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                activation_dtype="float32")
    model32 = Model(cfg32, "cuda")
    with torch.no_grad():
        for p32, p in zip(model32.parameters(), model.parameters()):
            p32.copy_(p)
    res = serve(cfg32, model32, prompts, frontend, INVARIANT_STEPS + 1)
    inv = check_invariant(name + " (f32)", cfg32, model32, prompts, frontend, res)
    print(f"serve {name} [{card}]: f32 on the same weights, prefill/decode vs "
          f"train forward {fmt_errs(inv)} of max|logit| (bound "
          f"{INVARIANT_TOL} on every position)")
    del model32
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def busy_share(name: str, card: str, cfg, model, prompts, frontend) -> None:
    """One more serve_batch of 8 tokens under device-only tracing: the
    card's busy share of the wall time, and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        serve(cfg, model, prompts, frontend, 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sorted(((getattr(e, "self_device_time_total", 0.0), e.count, e.key)
                   for e in trace.key_averages()), reverse=True)
    busy_s = sum(b[0] for b in busy) / 1e6
    launches = sum(b[1] for b in busy)
    print(f"serve {name} [{card}]: traced serve_batch of 8 tokens: device busy "
          f"{busy_s:.4f} s of {wall:.3f} s wall ({100 * busy_s / wall:.2f}% "
          f"busy), {launches} device operations")
    for us, count, key in busy[:5]:
        print(f"serve {name} device time {us / 1e3:.3f} ms over {count} calls: "
              f"{key[:90]}")


def width_check_run(card: str) -> None:
    """llama3-8b at full width with two layers in f32: the same weights on
    the CPU and on the card (mapped through the reference tree), greedy
    serve_batch on both."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.interop import model_params_from, reference_tree
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=2,
                              param_dtype="float32", activation_dtype="float32")
    t0 = time.perf_counter()
    cpu = build_model(cfg, "cpu", seed=0)
    on_card = model_params_from(cfg, reference_tree(cpu), device="cuda")
    setup_s = time.perf_counter() - t0
    prompts, frontend = serve_prompts(cfg, SERVE_CHECK["batch"],
                                      SERVE_CHECK["prompt_len"])
    t0 = time.perf_counter()
    a = serve(cfg, cpu, prompts, frontend, SERVE_CHECK["gen_len"])
    cpu_s = time.perf_counter() - t0
    b = serve(cfg, on_card, prompts, frontend, SERVE_CHECK["gen_len"])
    err = compare_cpu_card("llama3-8b-2L-f32", a, b)
    print(f"serve llama3-8b-2L-f32 [{card}]: full width, 2 "
          f"layers, f32, {SERVE_CHECK['batch']} x {SERVE_CHECK['prompt_len']} "
          f"prompt tokens, {SERVE_CHECK['gen_len']} new: card logits within "
          f"{err:.3e} of max|logit| of the CPU's (bound {CPU_TOL}), tokens "
          f"equal where decided; setup {setup_s:.1f} s, CPU serve {cpu_s:.1f} s")
    del on_card, cpu
    torch.cuda.empty_cache()


def reduced_runs(card: str, skip=("llama3-8b", "mamba2-780m")) -> None:
    """Every other architecture at its reduced size (f32): the same
    weights on the CPU and the card, greedy serve_batch on both (prefill
    and decode logits within CPU_TOL * max), and the serving invariant on
    the card."""
    import torch

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.interop import model_params_from, reference_tree
    from repro_torch.models import build_model

    for name in ARCHS:
        if name in skip:
            continue
        cfg = get_config(name).reduced()
        cpu = build_model(cfg, "cpu", seed=0)
        model = model_params_from(cfg, reference_tree(cpu), device="cuda")
        prompts, frontend = serve_prompts(cfg, SERVE_CHECK["batch"],
                                          SERVE_CHECK["prompt_len"])
        a = serve(cfg, cpu, prompts, frontend, SERVE_CHECK["gen_len"])
        b = serve(cfg, model, prompts, frontend, SERVE_CHECK["gen_len"])
        err = compare_cpu_card(cfg.name, a, b)
        inv = check_invariant(cfg.name, cfg, model, prompts, frontend, b)
        print(f"serve {cfg.name} [{card}]: card vs CPU logits {err:.3e} of "
              f"max|logit| (bound {CPU_TOL}); serving invariant {max(inv):.3e} "
              f"(bound {INVARIANT_TOL}); decode {b['decode_s_per_tok'] * 1e3:.3f} "
              f"ms a token")
        del model
    torch.cuda.empty_cache()


def serve_phase(counters) -> dict:
    """The LLM serving path on the card (see the module docstring, 12),
    with every kernel's launch count set to 0 before and read after: the
    path runs none of them."""
    card = card_label()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    runs = [full_width_run("llama3-8b", card, decode_gated=True)]
    width_check_run(card)
    # mamba2-780m's bf16 decode drifts from the chunked scan by more than
    # INVARIANT_TOL within 4 steps in the reference too (PERF.md,
    # `tools/bf16_drift.py drift`):
    # its invariant is held in f32 on the same weights.
    runs.append(full_width_run("mamba2-780m", card, decode_gated=False))
    reduced_runs(card)
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    print(f"serve phase [{card}]: {time.perf_counter() - t0:.1f} s; launches",
          json.dumps(launches))
    for name, count in launches.items():
        if count != EXACT_LAUNCHES["serve"][name]:
            fail(f"serve: {name} launched {count} times, not 0")
    return launches


# ------------------------------------------------------------- train phase

TRAIN = dict(batch=8, seq=512, steps=20, lr=3e-4, seed=0)  # the full-width runs
TRAIN_LAYERS = 8  # llama3-8b's depth cut from 32: the whole model's state
# (8.03 B x (2 B param + 2 B grad + 8 B f32 m and v) = 96 GB) does not fit
# on one 80 GB card; 8 layers hold 33.5 GB.
MAMBA_STEPS = 10
TRAIN_CHECK_STEPS, TRAIN_STOP = 10, 5  # card against CPU; stop and resume
TRAIN_CPU_TOL = 1e-4  # card vs CPU in f32: losses, relative


def tiny_train_config(name: str):
    """tests/test_train_integration.py's tiny llama and MoE configs."""
    from repro_torch.configs import get_config

    kw = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
              vocab_size=128)
    kw.update(dict(num_experts=4, moe_d_ff=32) if "moe" in name else dict(d_ff=128))
    return dataclasses.replace(get_config(name).reduced(), **kw)


def counted_train_flops(cfg, remat: bool) -> int:
    """Matmul FLOPs of one train step at TRAIN's batch and length, counted
    op by op on the meta device (`repro_torch.launch.dryrun.count_cell`:
    the backward and, with remat, the recomputed forward included)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import count_cell

    sp = ShapeSpec("train_smoke", TRAIN["seq"], TRAIN["batch"], "train")
    return count_cell(cfg, sp, remat=remat)["flops_matmul"]


def traced_busy(fn) -> tuple[float, float, int, list]:
    """(device busy seconds, wall seconds, device operations, [(device
    microseconds, calls, name), ...] largest first) of one call of ``fn``
    under device-only tracing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    items = sorted(((getattr(e, "self_device_time_total", 0.0), e.count, e.key)
                    for e in trace.key_averages()), reverse=True)
    return sum(i[0] for i in items) / 1e6, wall, sum(i[1] for i in items), items


def full_width_train(name: str, card: str, steps: int, layers: int | None,
                     falling: bool) -> dict:
    """One architecture at full width in bf16 trained on the card by
    `train_loop` (remat on, the repeat task, seed 0, the trainer's
    schedule for ``steps``): every loss and grad norm finite, and where
    ``falling``, the mean of the last 5 losses below the first 5's; then
    the optimizer timed alone, one more step traced for the busy share,
    and a second run from the same seed, whose losses must repeat the
    first's bitwise."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import make_local_mesh, make_train_step, train_loop
    from repro_torch.optim import AdamWConfig, adamw_update

    cfg = get_config(name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_local_mesh(device="cuda")
    out = train_loop(cfg, mesh, steps=steps, batch=TRAIN["batch"], seq=TRAIN["seq"],
                     lr=TRAIN["lr"], seed=TRAIN["seed"], remat=True,
                     log_every=max(steps // 4, 1), print_fn=print)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms = np.array(out["losses"]), np.array(out["grad_norms"])
    if losses.shape != (steps,) or not (np.isfinite(losses).all()
                                        and np.isfinite(gnorms).all()):
        fail(f"train {name}: losses {losses.tolist()}, grad norms {gnorms.tolist()}")
    first, last = losses[:5].mean(), losses[-5:].mean()
    if falling and not last < first:
        fail(f"train {name}: the last 5 losses average {last:.4f}, not below the "
             f"first 5's {first:.4f}")
    model, out_losses = out["model"], out["losses"]
    step_s = float(np.median(out["step_seconds"][2:]))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    flops = counted_train_flops(cfg, remat=True)
    tflops = flops / step_s / 1e12
    n_params = sum(p.numel() for p in model.parameters())
    state = sum(p.numel() * (2 * p.element_size() + 8) for p in model.parameters())

    # The optimizer alone, on this model's gradients of one more batch.
    opt = AdamWConfig(lr=TRAIN["lr"], warmup_steps=5, total_steps=steps)
    bundle = make_train_step(cfg, mesh, opt=opt, remat=True, zero1=False)
    opt_state = bundle.init_opt(model)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
                                      global_batch=TRAIN["batch"], seed=TRAIN["seed"]))
    batch = {"tokens": torch.from_numpy(data.batch(steps)["tokens"]).cuda()}
    model.requires_grad_(True)
    model.loss(batch, remat=True)[0].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    opt_ms = cuda_ms(lambda: adamw_update(model, grads, opt_state, opt), iters=1,
                     warmup=1, repeats=3)
    model.zero_grad(set_to_none=True)
    step_fn = bundle.jit_for(batch)
    busy, wall, ops, items = traced_busy(lambda: step_fn(model, opt_state, batch))
    print(f"train {name} [{card}]: {cfg.num_layers} layers, {n_params / 1e9:.3f} B "
          f"parameters {cfg.param_dtype}, {TRAIN['batch']} x {TRAIN['seq']} tokens, "
          f"{steps} steps, remat; losses {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(first 5 mean {first:.4f}, last 5 mean {last:.4f}); grad norms "
          f"{gnorms.min():.4f}..{gnorms.max():.4f}")
    print(f"train {name} [{card}]: step {step_s * 1e3:.3f} ms (median of steps "
          f"3-{steps}; first {out['step_seconds'][0] * 1e3:.3f} ms), optimizer "
          f"{opt_ms:.3f} ms a step alone, {tokens / step_s:.1f} tokens/s; "
          f"{flops / 1e12:.3f} TFLOP of matmuls a step (counted on meta) -> "
          f"{tflops:.2f} TFLOP/s, "
          f"{100 * tflops * 1e12 / H100_BF16_FLOPS:.2f}% of 989.4 dense bf16")
    print(f"train {name} [{card}]: peak {peak / 2**30:.3f} GiB "
          f"(max_memory_allocated) against {state / 1e9:.2f} GB of state "
          f"(bf16 params and grads, f32 m and v); traced step: device busy "
          f"{busy:.4f} s of {wall:.3f} s wall ({100 * busy / wall:.2f}% busy), "
          f"{ops} device operations")
    for us, count, key in items[:6]:
        print(f"train {name} device time {us / 1e3:.3f} ms over {count} calls: "
              f"{key[:90]}")
    res = {"name": name, "step_ms": step_s * 1e3, "opt_ms": opt_ms,
           "tokens_per_s": tokens / step_s, "tflops": tflops, "peak_bytes": peak,
           "busy": busy / wall}
    del model, out, opt_state, grads, bundle, step_fn
    torch.cuda.empty_cache()
    again = train_loop(cfg, mesh, steps=steps, batch=TRAIN["batch"], seq=TRAIN["seq"],
                       lr=TRAIN["lr"], seed=TRAIN["seed"], remat=True,
                       print_fn=lambda *_: None)
    if again["losses"] != out_losses:
        fail(f"train {name}: a second run from the same seed gave other losses")
    print(f"train {name} [{card}]: a second run from seed {TRAIN['seed']} repeats "
          "every loss bitwise")
    del again
    torch.cuda.empty_cache()
    return res


def train_card_vs_cpu(card: str, tmp: Path) -> None:
    """The tiny llama and MoE configs in f32: TRAIN_CHECK_STEPS steps of
    `train_loop` on the CPU and the card from the same weights (losses
    within TRAIN_CPU_TOL relative); on the card a run stopped at
    TRAIN_STOP and resumed from its checkpoint equals the straight run
    bitwise."""
    import numpy as np
    import torch

    from repro_torch.interop import model_params_from, reference_tree
    from repro_torch.launch import make_local_mesh, train_loop
    from repro_torch.models import build_model

    kw = dict(steps=TRAIN_CHECK_STEPS, batch=2, seq=16, lr=1e-3, log_every=100,
              print_fn=lambda *_: None)
    card_mesh = make_local_mesh(device="cuda")
    for name in ("llama3-8b", "qwen3-moe-30b-a3b"):
        cfg = tiny_train_config(name)
        cpu = build_model(cfg, "cpu", seed=0)
        on_card = model_params_from(cfg, reference_tree(cpu), device="cuda")
        a = train_loop(cfg, make_local_mesh(device="cpu"), model=cpu, **kw)
        b = train_loop(cfg, card_mesh, model=on_card, **kw)
        err = float(np.max(np.abs(np.array(b["losses"]) - a["losses"])
                           / np.abs(a["losses"])))
        if not err < TRAIN_CPU_TOL:
            fail(f"train {name} tiny: card losses differ from the CPU's by {err:.3e} "
                 f"relative (bound {TRAIN_CPU_TOL})")
        ckpt = tmp / name
        straight = train_loop(cfg, card_mesh, **kw)
        train_loop(cfg, card_mesh, ckpt_dir=ckpt, ckpt_every=TRAIN_STOP,
                   stop_at=TRAIN_STOP, **kw)
        resumed = train_loop(cfg, card_mesh, ckpt_dir=ckpt, resume=True, **kw)
        same = resumed["losses"] == straight["losses"][TRAIN_STOP:] and all(
            torch.equal(p, q) for p, q in zip(straight["model"].parameters(),
                                              resumed["model"].parameters()))
        if not same:
            fail(f"train {name} tiny: the run stopped at {TRAIN_STOP} and resumed "
                 "differs from the straight run on the card")
        print(f"train {name} tiny f32 [{card}]: {TRAIN_CHECK_STEPS} steps, card vs "
              f"CPU losses within {err:.3e} relative (bound {TRAIN_CPU_TOL}); "
              f"losses {a['losses'][0]:.5f} -> {a['losses'][-1]:.5f}; stopped at "
              f"{TRAIN_STOP} and resumed from its checkpoint: bitwise the straight run")


def train_bf16_checkpoint(card: str, tmp: Path) -> None:
    """llama3-8b reduced with bf16 parameters: one train step on the card,
    then model and optimizer state saved and restored into a fresh model
    through `CheckpointManager`, bitwise."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.interop import (load_reference_tree, opt_state_from,
                                     reference_opt_state, reference_tree)
    from repro_torch.launch import make_local_mesh, make_train_step
    from repro_torch.models import build_model
    from repro_torch.runtime import CheckpointManager

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              param_dtype="bfloat16", activation_dtype="bfloat16")
    model = build_model(cfg, "cuda", seed=0)
    bundle = make_train_step(cfg, make_local_mesh(device="cuda"))
    opt_state = bundle.init_opt(model)
    tokens = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                        global_batch=2)).batch(0)["tokens"]
    opt_state, _ = bundle.jit_for(None)(model, opt_state,
                                        {"tokens": torch.from_numpy(tokens).cuda()})
    mgr = CheckpointManager(tmp / "bf16")
    mgr.save(1, (reference_tree(model), reference_opt_state(model, opt_state)))
    fresh = build_model(cfg, "cuda", seed=1)
    (params, ref_opt), _ = mgr.restore(
        (reference_tree(fresh), reference_opt_state(fresh, bundle.init_opt(fresh))))
    load_reference_tree(fresh, params)
    back = opt_state_from(fresh, ref_opt)
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    same = all(torch.equal(bits(p), bits(q)) for p, q in
               zip(model.parameters(), fresh.parameters()))
    same &= all(torch.equal(opt_state[k][n], back[k][n])
                for k in ("m", "v") for n in opt_state[k])
    if not (same and int(back["step"]) == int(opt_state["step"])):
        fail("train: a bf16 model and its optimizer state did not restore bitwise")
    print(f"train llama3-8b reduced bf16 [{card}]: model and optimizer state "
          "saved and restored bitwise (CheckpointManager)")


def train_phase(counters) -> dict:
    """The training path on the card (see the module docstring, 13), with
    every kernel's launch count set to 0 before and read after: the path
    runs none of them."""
    import tempfile

    card = card_label()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    full_width_train("llama3-8b", card, TRAIN["steps"], TRAIN_LAYERS, falling=True)
    # mamba2-780m's loss does not fall within 10 steps at lr 3e-4 (nor 20
    # or 40, in bf16 or f32, on the card: tools/train_curves.py), while the
    # port follows the reference's bf16 steps at full width on the CPU
    # (tools/train_dynamics.py, PERF.md's Findings): it is held to finite
    # losses and a bitwise repeat, not to a fall.
    full_width_train("mamba2-780m", card, MAMBA_STEPS, None, falling=False)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        train_card_vs_cpu(card, Path(tmp))
        train_bf16_checkpoint(card, Path(tmp))
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    print(f"train phase [{card}]: {time.perf_counter() - t0:.1f} s; launches",
          json.dumps(launches))
    for name, count in launches.items():
        if count != EXACT_LAUNCHES["train"][name]:
            fail(f"train: {name} launched {count} times, not 0")
    return launches


# ---------------------------------------------------------- roofline phase

# llama3-8b's steps as the train and serve phases run them: (kind, seq,
# batch); the decode step's cache holds the served prompt and new tokens.
ROOF_STEPS = (("train", TRAIN["seq"], TRAIN["batch"]),
              ("prefill", SERVE["prompt_len"], SERVE["batch"]),
              ("decode", SERVE["prompt_len"] + SERVE["gen_len"], SERVE["batch"]))
ROOF_UNITS = (2, 4)  # the two truncated depths counted and run on the card
ROOF_REPEATS, ROOF_WARMUP = 5, 2
ROOF_FLOP_TOL = 0.01  # the profiler's matmul FLOPs against the counted ones
ROOF_TIME_FLOOR = 0.95  # a step may not beat its compute or least-traffic bound
# Counted peak live bytes against max_memory_allocated: the card's peak
# holds ~62 MiB more than the step's tensors (library workspace), 0.2-2.2%
# of the phase's peaks on an H100.
ROOF_PEAK_TOL = 0.03
ROOF_DRYRUN = (("llama3-8b", "train_4k"), ("llama3-8b", "prefill_32k"),
               ("llama3-8b", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k"))
PROFILER_MATMULS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def profiler_matmul_flops(call) -> int:
    """The matmul FLOPs ``torch.profiler`` (``with_flops``) records for one
    call of ``call`` on the card.  The profiler records an op when it is
    called, so it also counts the ops that remat's early stop calls and
    aborts before their kernel (`torch.utils.checkpoint`'s recomputation
    stops at the last tensor the backward needs); the caller turns early
    stop off to compare it with a count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        call()
        torch.cuda.synchronize()
    return int(sum(e.flops or 0 for e in prof.events() if e.name in PROFILER_MATMULS))


def step_seconds(call) -> float:
    """Median host seconds of ROOF_REPEATS synchronised calls after
    ROOF_WARMUP."""
    import numpy as np
    import torch

    for _ in range(ROOF_WARMUP):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROOF_REPEATS):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def card_step(cfg, sp) -> dict:
    """One step of ``cfg`` (from a torch.Generator seeded 0) on the card:
    its median seconds and peak memory over one call; with remat's early
    stop off, the profiler's matmul FLOPs of one call and the count of the
    same on meta; for decode, `decode_bound_ms`'s bytes."""
    import torch
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from repro_torch.launch.dryrun import cell_step, count_cell
    from repro_torch.models import build_model

    torch.cuda.empty_cache()
    model = build_model(cfg, "cuda", seed=0)
    call, args = cell_step(cfg, sp, model,
                           generator=torch.Generator("cuda").manual_seed(0))
    run = lambda: (call(), None)[1]  # drop the step's outputs
    seconds = step_seconds(run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    out = {"s": seconds, "peak": torch.cuda.max_memory_allocated()}
    with set_checkpoint_early_stop(False):
        out["prof_flops"] = profiler_matmul_flops(run)
        out["counted_flops"] = count_cell(cfg, sp)["flops_matmul"]
    if sp.kind == "decode":
        caches = sum(t.numel() * t.element_size() for t in _leaves(args[1]))
        out["decode_bound_s"] = decode_bound_ms(model, caches) / 1e3
    del model, call, args
    torch.cuda.empty_cache()
    return out


def _line(n1: float, v1: float, n2: float, v2: float, n: float) -> float:
    return v2 + (v2 - v1) / (n2 - n1) * (n - n2)


def roofline_phase(counters) -> dict:
    """llama3-8b at its published width in bf16: the train (remat),
    prefill and decode steps counted on the meta device
    (`repro_torch.launch.roofline.measure_cell`) and run on the card at
    ROOF_UNITS layers, both extrapolated linearly to 32 layers, beside the
    roofline terms at the data-sheet peaks; then the dry run of
    ROOF_DRYRUN at full size on meta.  Every kernel's launch count is set
    to 0 before and read after: the path runs none of them."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import (measure_cell, model_flops,
                                             roofline_terms, truncate_config)

    card = card_label()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    cfg = get_config("llama3-8b")
    n1, n2 = ROOF_UNITS
    full = cfg.num_layers
    for kind, seq, batch in ROOF_STEPS:
        sp = ShapeSpec(f"{kind}_{batch}x{seq}", seq, batch, kind)
        rec = measure_cell(cfg, sp, n1=n1, n2=n2, verbose=False)
        if rec["status"] != "ok":
            fail(f"roofline {sp.name}: counting failed: {rec['error']}")
        if rec["linear_gap"] != {"flops": 0.0, "bytes": 0.0}:
            fail(f"roofline {sp.name}: meta counts are not linear in depth: "
                 f"{rec['linear_gap']}")
        runs, least = {}, {}
        for n in (n1, n2):
            depth = rec["depths"][str(n)]
            counted = depth["counters"]
            runs[n] = card_step(truncate_config(cfg, n), sp)
            run = runs[n]
            matmul = sum(v for k, v in counted.items() if k.startswith("flops_matmul:"))
            ferr = abs(run["prof_flops"] - run["counted_flops"]) / run["counted_flops"]
            least[n] = depth["memory"]["argument_size_in_bytes_one_card"] / H100_BYTES_PER_S
            terms = roofline_terms(counted)
            peak = depth["memory"]["peak_live_bytes"]
            perr = abs(peak - run["peak"]) / run["peak"]
            print(f"roofline {sp.name} at {n} layers [{card}]: {run['s'] * 1e3:.3f} ms "
                  f"(median of {ROOF_REPEATS}); matmul FLOPs counted {matmul:.6e}; "
                  f"without early stop counted {run['counted_flops']:.6e}, profiler "
                  f"{run['prof_flops']:.6e} ({ferr:.2e} apart, bound "
                  f"{ROOF_FLOP_TOL}); compute {terms['compute_s'] * 1e3:.3f} ms, least "
                  f"traffic {least[n] * 1e3:.3f} ms; peak live counted {peak / 2**30:.3f} "
                  f"GiB, max_memory_allocated {run['peak'] / 2**30:.3f} GiB ({perr:.2e} "
                  f"apart, bound {ROOF_PEAK_TOL})")
            if not ferr <= ROOF_FLOP_TOL:
                fail(f"roofline {sp.name} at {n} layers: the profiler's matmul FLOPs "
                     f"{run['prof_flops']} are {ferr:.3e} from the counted "
                     f"{run['counted_flops']}")
            if not perr <= ROOF_PEAK_TOL:
                fail(f"roofline {sp.name} at {n} layers: counted peak {peak} is "
                     f"{perr:.3e} from max_memory_allocated {run['peak']}")
            if run["s"] < ROOF_TIME_FLOOR * max(terms["compute_s"], least[n]):
                fail(f"roofline {sp.name} at {n} layers: {run['s']} s beats its bound "
                     f"(compute {terms['compute_s']}, least traffic {least[n]}): a "
                     "count is wrong")
        c = rec["counters"]
        terms = roofline_terms(c)
        measured = _line(n1, runs[n1]["s"], n2, runs[n2]["s"], full)
        least_full = _line(n1, least[n1], n2, least[n2], full)
        if measured < ROOF_TIME_FLOOR * max(terms["compute_s"], least_full):
            fail(f"roofline {sp.name}: {measured} s at {full} layers beats its bound")
        mf = model_flops(cfg, sp)
        extra = ""
        if kind == "decode":
            dec = _line(n1, runs[n1]["decode_bound_s"], n2, runs[n2]["decode_bound_s"], full)
            extra = f", decode_bound_ms {dec * 1e3:.3f} ms (weights but the embedding, caches)"
        print(f"roofline {sp.name} at {full} layers (from {n1} and {n2}) [{card}]: "
              f"flops {c['flops']:.6e} (matmul bf16 {c.get('flops_matmul:bfloat16', 0):.6e}, "
              f"f32 {c.get('flops_matmul:float32', 0):.6e}, pointwise "
              f"{c['flops_pointwise']:.6e}), bytes {c['bytes']:.6e}; compute_s "
              f"{terms['compute_s']:.6f}, memory_s {terms['memory_s']:.6f}, bound_s "
              f"{terms['bound_s']:.6f} ({terms['dominant']}); least traffic "
              f"{least_full:.6f} s{extra}; measured_s {measured:.6f}; roofline_fraction "
              f"{terms['bound_s'] / measured:.4f}; mfu {mf / H100_BF16_FLOPS / measured:.4f} "
              f"(model_flops {mf:.6e})")
    for arch, shape in ROOF_DRYRUN:
        rec = run_cell(arch, shape, False, verbose=False)
        if rec["status"] != "ok":
            fail(f"dry run {arch} x {shape}: {rec.get('error')}")
        mem = rec["memory"]
        print(f"dryrun {arch} x {shape} x 16x16 (unpartitioned counts on meta, "
              f"{rec['count_s']:.1f} s on the card's host): flops "
              f"{rec['cost']['flops']:.4e}, bytes {rec['cost']['bytes accessed']:.4e}, "
              f"args {mem['argument_size_in_bytes'] / 1e9:.3f} GB a device of the mesh, "
              f"one card: args {mem['argument_size_in_bytes_one_card'] / 1e9:.3f} GB, "
              f"peak {mem['peak_live_bytes'] / 1e9:.3f} GB")
    launches = {name: getattr(mod, attr) for name, (mod, attr) in counters.items()}
    print(f"roofline phase [{card}]: {time.perf_counter() - t0:.1f} s; launches",
          json.dumps(launches))
    for name, count in launches.items():
        if count != EXACT_LAUNCHES["roofline"][name]:
            fail(f"roofline: {name} launched {count} times, not 0")
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    global H100_BYTES_PER_S, H100_F32_FLOPS, H100_TF32_FLOPS, H100_BF16_FLOPS
    from repro_torch.launch.roofline import (H100_BF16_FLOPS, H100_BYTES_PER_S,
                                             H100_F32_FLOPS, H100_TF32_FLOPS)

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch import spans
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(_build.KERNELS)} kernels")
    for name in _build.KERNELS:
        print(f"ptxas {name}: {_build.ptxas_report(name)}")

    rng = np.random.default_rng(0)
    rows = [timed(check(dev, rng)) for check in (
        check_lif_step, check_part_degrees, check_connectivity_degrees,
        check_swap_deltas, check_link_loads, check_hop_cost)]

    for r in rows:
        print_row(r, r.pop("shape"))

    counters = launch_counters()
    with ScreenSpy() as screens:
        prof, cut_res, cut_hop, cut_launches = traced_run("cut", counters)
    row = timed(check_replay_screen(dev, screens.calls[-1]))
    print_row(row, row.pop("shape"))
    rows.append(row)
    with SelectSpy() as selects:
        _, vol_res, vol_hop, vol_launches = traced_run(
            "volume", counters, prof, reset=selects.reset)
    if vol_launches["volume_select"] != selects.count:
        fail(f"volume: {vol_launches['volume_select']} volume_select launches "
             f"for {selects.count} device selection calls")
    row = timed(check_volume_select(dev, selects.calls))
    print_row(row, row.pop("shape"))
    rows.append(row)
    spans.clear()
    with spans.recording():
        _, dev_res, dev_hop, dev_launches = traced_run("device", counters, prof,
                                                       reset=spans.clear)
    spy = stepper_spans()
    check_result(prof, cut_res, "cut", cut_hop)
    check_result(prof, vol_res, "volume", vol_hop)
    check_device_run(prof, cut_res, dev_res, dev_hop, dev_launches, spy)
    runs = [cut_launches, vol_launches, dev_launches]
    runs += baseline_runs(prof, cut_res, counters).values()
    runs += fault_runs(prof, cut_res, counters).values()
    runs.append(sweep_run(prof, cut_res, counters))
    runs += sharded_runs(prof, cut_res, vol_res, counters).values()
    island_launches, island = island_run(prof, cut_res, counters)
    runs.append(island_launches)
    runs += layout_runs(counters).values()
    runs += engines_phase(counters).values()
    check_profile_raster(prof, dev)
    runs.append(ranks_phase(counters, island))
    runs.append(serve_phase(counters))
    runs.append(train_phase(counters))
    runs.append(roofline_phase(counters))
    launches = {name: sum(run[name] for run in runs) for name in counters}
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    if loaded:
        fail(f"the port loaded reference or JAX modules: {loaded}")

    kernels = []
    for r in rows:
        kernels.append({"name": r["name"], "route": "cuda", "source": r["source"],
                        "replaces": r["replaces"], "launches": launches[r["name"]],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    label = card_label()
    print(json.dumps({"kernels": kernels}))
    print(label)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
