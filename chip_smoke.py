#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the four CUDA kernels from ``src/repro_torch/csrc`` (``nvcc``,
   one process per source, in parallel).
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes the slice run gives it (exact for lif_step, part_degrees and
   link_loads; rtol 1e-4 / atol 1e-2 for swap_deltas), and times the
   kernel, the plain version and, where one exists, one PyTorch call that
   computes the same function.
3. Runs the slice run — ``profile_snn`` of the paper's edge_5120 SNN
   (1200 steps) and ``run_toolchain`` on a 16x16 mesh at capacity 40 with
   the vec partitioner, the batched SA on the kernel scorer and the
   link-load screen — with every kernel's launch count set to 0 just
   before and read just after; every kernel must have launched.
4. Checks the result by the toolchain's own means: a valid partition whose
   cut matches a recount, spike conservation in the NoC stats, identical
   stats from the numpy screen, and an identical partition from a CPU
   re-run.

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
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 on the CUDA cores, H100 SXM data sheet

SLICE = dict(snn="edge_5120", num_steps=1200, mesh_w=16, mesh_h=16,
             capacity=40, seed=0)


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


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and operations over the f32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------- kernel checks


def check_lif_step(dev, rng) -> dict:
    import torch

    from repro_torch.kernels.lif_step.kernel import lif_step_cuda
    from repro_torch.kernels.lif_step.ref import lif_step_ref

    n = 5120  # edge_5120's neurons; one launch per profiling step
    kw = dict(decay=0.9, threshold=1.0, v_reset=0.0, refractory=1)
    v = torch.tensor(rng.uniform(-0.5, 1.2, n).astype("float32"), device=dev)
    refr = torch.tensor(rng.integers(0, 3, n).astype("int32"), device=dev)
    cur = torch.tensor(rng.uniform(0.0, 0.6, n).astype("float32"), device=dev)
    got = lif_step_cuda(v, refr, cur, **kw)
    want = lif_step_ref(v, refr, cur, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("v", "refr", "fired"), got, want):
        if not torch.equal(a, b):
            fail(f"lif_step {name} differs from the plain version "
                 f"({int((a != b).sum())} of {n})")
    err = float((got[0] - want[0]).abs().max())
    t_bytes, by = bound(nbytes(v, refr, cur, *got), 4 * n)
    return dict(
        name="lif_step", source="src/repro_torch/csrc/lif_step.cu",
        replaces="src/repro/kernels/lif_step/kernel.py:38", max_abs_err=err,
        kernel=lambda: lif_step_cuda(v, refr, cur, **kw),
        plain=lambda: lif_step_ref(v, refr, cur, **kw),
        library=None, iters=200, bound_ms=t_bytes, bound_by=by,
        shape=f"N={n}")


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


def check_swap_deltas(dev, rng) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.swap_delta.kernel import swap_deltas_cuda
    from repro_torch.kernels.swap_delta.ref import distance_matrix, swap_deltas_ref

    kc, k, mesh_w = 256, 141, 16  # 141 partitions padded to 256 cores
    c = np.zeros((kc, kc), dtype=np.float32)
    c[:k, :k] = rng.integers(0, 600, (k, k))
    np.fill_diagonal(c, 0.0)
    sym = torch.tensor(c + c.T, device=dev)
    perm = rng.permutation(kc)
    x = torch.tensor((perm % mesh_w).astype(np.float32), device=dev)
    y = torch.tensor((perm // mesh_w).astype(np.float32), device=dev)
    got = swap_deltas_cuda(sym, x, y)
    want = swap_deltas_ref(sym, x, y)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-2):
        fail("swap_deltas differs from the plain version beyond "
             "rtol 1e-4 / atol 1e-2")
    if float(torch.diagonal(got).abs().max()) > 1e-3:
        fail("swap_deltas diagonal is not ~0")
    d = distance_matrix(x, y)
    t_bound, by = bound(nbytes(sym, x, y, got), 4.0 * kc ** 3)
    return dict(
        name="swap_deltas", source="src/repro_torch/csrc/swap_deltas.cu",
        replaces="src/repro/kernels/swap_delta/kernel.py:68",
        max_abs_err=float((got - want).abs().max()),
        kernel=lambda: swap_deltas_cuda(sym, x, y),
        plain=lambda: swap_deltas_ref(sym, x, y),
        library=lambda: (sym @ d, d @ sym), iters=200,
        bound_ms=t_bound, bound_by=by,
        shape=f"K={kc}")


def check_link_loads(dev, rng) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.link_load.kernel import link_loads_cuda
    from repro_torch.kernels.link_load.ref import link_loads_ref

    b, w, h, per_window = 256, 16, 16, 8000  # one chunk of the slice replay
    k = w * h
    win = np.repeat(np.arange(b), per_window)
    s = rng.integers(0, k, win.shape[0])
    t = rng.integers(0, k, win.shape[0])
    counts_np = np.bincount((win * k + s) * k + t, minlength=b * k * k)
    counts = torch.tensor(counts_np.reshape(b, k, k).astype(np.int32), device=dev)
    cores = torch.arange(k, dtype=torch.int32, device=dev)
    x, y = cores % w, cores // w
    got = link_loads_cuda(counts, x, y, w, h)
    want = link_loads_ref(counts, x, y, w, h)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("link_loads differs from the plain version")
    hops = (np.abs(s % w - t % w) + np.abs(s // w - t // w)).sum()
    t_bound, by = bound(nbytes(counts, x, y, got), float(hops))
    return dict(
        name="link_loads", source="src/repro_torch/csrc/link_loads.cu",
        replaces="src/repro/kernels/link_load/kernel.py:99",
        max_abs_err=float((got - want).abs().max()),
        kernel=lambda: link_loads_cuda(counts, x, y, w, h),
        plain=lambda: link_loads_ref(counts, x, y, w, h),
        library=None, iters=20, bound_ms=t_bound, bound_by=by,
        shape=f"B={b} K={k} records/window={per_window}")


# ------------------------------------------------------------- slice run


def timed(row: dict) -> dict:
    """Time a kernel check's three callables: ``ms``/``plain_ms``/
    ``library_ms`` per call (CUDA events) and the device time per call of
    each (profiler), the library call only where one exists."""
    out = {k: v for k, v in row.items()
           if k not in ("kernel", "plain", "library", "iters")}
    for key, fn in (("ms", row["kernel"]), ("plain_ms", row["plain"]),
                    ("library_ms", row["library"])):
        out[key] = None if fn is None else cuda_ms(fn, row["iters"])
        out["device_" + key] = None if fn is None else device_ms(fn, row["iters"])
    return out


def kernel_modules():
    from repro_torch.kernels.gain_eval import kernel as gain_eval
    from repro_torch.kernels.lif_step import kernel as lif_step
    from repro_torch.kernels.link_load import kernel as link_load
    from repro_torch.kernels.swap_delta import kernel as swap_delta

    return {"lif_step": lif_step, "part_degrees": gain_eval,
            "swap_deltas": swap_delta, "link_loads": link_load}


def slice_config(device: str, screen: str):
    from repro_torch.core import ToolchainConfig

    return ToolchainConfig(
        method="sneap", mesh_w=SLICE["mesh_w"], mesh_h=SLICE["mesh_h"],
        capacity=SLICE["capacity"], seed=SLICE["seed"],
        partition_impl="vec", objective="cut", mapper="sa",
        mapper_kwargs={"impl": "vec", "score_backend": "auto"},
        noc_mode="queued", noc_kwargs={"screen": screen}, device=device)


def run_slice(device: str = "cuda"):
    """The main path, through the entry points a user calls."""
    from repro_torch.core import run_toolchain
    from repro_torch.snn import make_snn, profile_snn

    t0 = time.perf_counter()
    prof = profile_snn(make_snn(SLICE["snn"]), num_steps=SLICE["num_steps"],
                       seed=SLICE["seed"], device=device)
    profile_s = time.perf_counter() - t0
    res = run_toolchain(prof, config=slice_config(device, "linkload"))
    return prof, res, profile_s


def check_result(prof, res, device: str = "cuda") -> None:
    import numpy as np

    from repro_torch.core import edge_cut, evaluate_phase, partition_phase
    from repro_torch.core.graph import validate_partition

    pres = res.partition
    validate_partition(prof.graph, pres.part, pres.k, SLICE["capacity"])
    if edge_cut(prof.graph, pres.part) != pres.edge_cut:
        fail("edge_cut does not match a recount of the partition")
    if not np.isfinite(res.mapping.avg_hop) or res.mapping.avg_hop <= 0:
        fail(f"avg_hop is not a positive finite number: {res.mapping.avg_hop}")
    placement = np.asarray(res.mapping.placement)
    if np.unique(placement).shape[0] != pres.k:
        fail("placement is not one distinct core per partition")
    noc = res.noc
    if noc.num_noc_spikes + noc.num_local_spikes != prof.num_spikes:
        fail("NoC stats lose spikes: noc + local != trace length")
    if not np.isfinite(noc.avg_latency) or noc.avg_latency < noc.avg_hop:
        fail("average latency is below the average hop count")
    # The screen never changes results (the reference's promise).
    numpy_screen = evaluate_phase(prof, pres, res.mapping,
                                  slice_config(device, "numpy"))
    for f in dataclasses.fields(noc):
        a, b = getattr(noc, f.name), getattr(numpy_screen, f.name)
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
        if not same:
            fail(f"NoCStats.{f.name} differs between the linkload and "
                 f"numpy screens")
    # The device never changes the partition.
    cpu = partition_phase(prof, slice_config("cpu", "numpy"))
    if not np.array_equal(cpu.part, pres.part) or cpu.edge_cut != pres.edge_cut:
        fail("the CPU re-partition differs from the card's")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
        check_lif_step, check_part_degrees, check_swap_deltas, check_link_loads)]

    def fmt(x):
        return "n/a" if x is None else f"{x:.5f}"

    for r in rows:
        print(f"kernel {r['name']} [{r.pop('shape')}]: max_abs_err="
              f"{r['max_abs_err']} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}); per call ms={fmt(r['ms'])} "
              f"plain_ms={fmt(r['plain_ms'])} library_ms={fmt(r['library_ms'])}; "
              f"device time per call ms={fmt(r['device_ms'])} "
              f"plain_ms={fmt(r['device_plain_ms'])} "
              f"library_ms={fmt(r['device_library_ms'])}")

    from torch.profiler import ProfilerActivity, profile

    mods = kernel_modules()
    for m in mods.values():
        m.launches = 0
    # Device-only tracing (kernels, copies, fills) of the whole main path:
    # it gives the card's busy time without timing any host op.
    with profile(activities=[ProfilerActivity.CUDA]) as trace:
        t0 = time.perf_counter()
        prof, res, profile_s = run_slice()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: m.launches for name, m in mods.items()}
    busy = sorted(((getattr(e, "self_device_time_total", 0.0), e.count, e.key)
                   for e in trace.key_averages()), reverse=True)
    busy_s = sum(b[0] for b in busy) / 1e6
    print(f"slice device: busy {busy_s:.4f} s of {wall:.3f} s wall "
          f"({100 * busy_s / wall:.2f}% busy)")
    for us, count, key in busy[:8]:
        print(f"slice device time {us / 1e3:.3f} ms over {count} calls: {key[:90]}")
    print(f"slice: profile {profile_s:.2f} s, {prof.num_neurons} neurons, "
          f"{prof.num_steps} steps kept, {prof.num_spikes} transmissions")
    print("slice summary:", json.dumps(res.summary()))
    print("slice phase_seconds:", json.dumps(res.phase_seconds))
    print("slice launches:", json.dumps(launches))
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched by the slice run")
    check_result(prof, res)
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
