#!/usr/bin/env python3
"""Where the time of the lif_step and link_loads kernels goes, on one GPU.

    python3 tools/probe_lif_link.py

Builds variants of ``src/repro_torch/csrc/lif_step.cu`` and
``link_loads.cu`` with parts changed (text substitutions on copies under
``build/probe/``; the sources are not touched) and prints, for each, the
microseconds a launch from CUDA events around back-to-back launches (a
floor of the host's launch rate for short kernels) and the profiler's
device time a launch.  Some variants' outputs are wrong by construction;
only their times mean anything.

lif_step, one fused step of edge_5120 (5,120 neurons, 95,788 synapses) on
the raster row of step 30 of its profile:
  base         the kernel as it is (16 synapses in flight)
  batch1       one synapse in flight at a time
  batch8       eight in flight
  batch32      32 in flight
  threads32    32 threads a block (160 blocks)
  threads128   128 threads a block (40 blocks)
  no_hit       each spike lookup right before its add (no hit mask)
  empty        every thread returns at once
  then a copy instrumented with clock64 prints, for thread 0 of blocks
  40 and 79 (interior neurons), the cycles of the first batch's loads
  and spike lookups, its adds, the other batches, and the step and
  stores.

link_loads, 256 windows x 8,000 packet records on the 16 x 16 mesh, with
random routes ("random") and with each route repeated 8 times in a row
("runs8", as consecutive packets of a firing to one core):
  base         the kernel as it is (__match_any_sync groups)
  no_match     no merging: every record walks its own route
  runs         merging of equal neighbouring records only (shuffle + ballot)
  one_add      each group adds once instead of walking its route
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MATCH = "    const unsigned group = __match_any_sync(0xffffffffu, key);\n"
OWN = "    const unsigned group = 1u << lane;\n"
RUNS = """    const int32_t up = __shfl_up_sync(0xffffffffu, key, 1);
    const unsigned starts = __ballot_sync(0xffffffffu, lane == 0 || up != key);
    const unsigned upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1;
    const int first = 31 - __clz(starts & upto);
    const unsigned later = starts & ~upto;
    const unsigned end = later ? (1u << (__ffs(later) - 1)) - 1 : 0xffffffffu;
    const unsigned group = end & ~((1u << first) - 1);
"""
WALK = "  const int sx = m.x[s], sy = m.y[s], dx = m.x[d], dy = m.y[d];\n"
ONE = ("  atomicAdd(&bins[(m.x[s] + m.y[d]) & 15], c);\n"
       "  if (c != 0x7fffffff) return;\n" + WALK)
HIT = """#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      hit |= (c0 + j < d && prev[s[j]]) ? 1u << j : 0u;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)  // ascending sources
      if (hit >> j & 1u) acc = __fadd_rn(acc, w[j]);
"""
NO_HIT = """#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j < d && prev[s[j]]) acc = __fadd_rn(acc, w[j]);
"""
BATCH = "constexpr int kBatch = 16;"
THREADS = "constexpr int kThreads = 64;"
LIF_VARIANTS = {
    "batch1": (BATCH, "constexpr int kBatch = 1;"),
    "batch8": (BATCH, "constexpr int kBatch = 8;"),
    "batch32": (BATCH, "constexpr int kBatch = 32;"),
    "threads32": (THREADS, "constexpr int kThreads = 32;"),
    "threads128": (THREADS, "constexpr int kThreads = 128;"),
    "no_hit": (HIT, NO_HIT),
    "empty": ("  if (i >= n) return;\n", "  if (n > 0) return;\n"),
}
LIF_PHASES = (
    ("namespace {\n", "namespace {\n__device__ long long g_clk[16];\n"),
    ("  if (i >= n) return;\n",
     "  long long clk[5] = {clock64()};\n  if (i >= n) return;\n"),
    ("#pragma unroll\n    for (int j = 0; j < kBatch; ++j)  // ascending sources\n",
     "    if (c0 == 0) clk[1] = clock64();\n"
     "#pragma unroll\n    for (int j = 0; j < kBatch; ++j)  // ascending sources\n"),
    ("      if (hit >> j & 1u) acc = __fadd_rn(acc, w[j]);\n",
     "      if (hit >> j & 1u) acc = __fadd_rn(acc, w[j]);\n"
     "    if (c0 == 0) clk[2] = clock64() + (acc == 12345.0f);\n"),
    ("  const float cur = __fadd_rn(acc, drive_i);\n",
     "  clk[3] = clock64();\n  const float cur = __fadd_rn(acc, drive_i);\n"),
    ("  fired_out[i] = fired ? 1 : 0;\n}\n",
     "  fired_out[i] = fired ? 1 : 0;\n  clk[4] = clock64();\n"
     "  const int slot = blockIdx.x == 40 ? 0 : (blockIdx.x == 79 ? 1 : -1);\n"
     "  if (threadIdx.x == 0 && slot >= 0)\n"
     "    for (int q = 0; q < 5; ++q) g_clk[slot * 8 + q] = clk[q];\n}\n"),
)
READ_CLK = """
extern "C" int read_clk(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_clk, sizeof(long long) * 16));
}
"""
LIF_PHASE_NAMES = ("first batch: loads + lookups", "first batch: adds",
                   "other batches", "step + stores")
LINK_VARIANTS = {"no_match": (MATCH, OWN), "runs": (MATCH, RUNS),
                 "one_add": (WALK, ONE)}


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"probe: the kernel source changed; cannot find:\n{old}")
    return src.replace(old, new)


def instrumented(src: str) -> str:
    for old, new in LIF_PHASES:
        src = sub(src, old, new)
    return src + READ_CLK


def build(kernel: str, changes: dict, out_dir: Path, nvcc: str, flags,
          extra: dict | None = None) -> dict:
    """Compile every variant of ``kernel`` in parallel; name -> its
    loaded library."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / f"{kernel}.cu").read_text()
    texts = {"base": src, **{n: sub(src, *c) for n, c in changes.items()}}
    texts.update({n: f(src) for n, f in (extra or {}).items()})
    procs = {}
    for name, text in texts.items():
        cu, so = out_dir / f"{kernel}-{name}.cu", out_dir / f"{kernel}-{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen([nvcc, *flags, "-o", str(so), str(cu)],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"probe: nvcc failed for {kernel} {name}:\n{log}")
        regs = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"probe ptxas {kernel} {name}: {'; '.join(regs)}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def report(label: str, libs: dict, kernel: str, argtypes, args, check) -> None:
    from chip_smoke import cuda_ms, device_ms

    for name, lib in libs.items():
        fn = getattr(lib, f"{kernel}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

        def call(fn=fn):
            check(fn(*args()), name)
        dev = device_ms(call, 200)
        dev = "n/a" if dev is None else f"{dev * 1e3:.3f}"
        print(f"probe {label} {name}: events {cuda_ms(call, 200) * 1e3:.3f} us, "
              f"device {dev} us a launch")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import lif_inputs
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif_step import lif_steps, synapses_from_dense
    from repro_torch.kernels.lif_step.kernel import _ARGTYPES as LIF_ARGS
    from repro_torch.kernels.link_load.kernel import _ARGTYPES as LINK_ARGS
    from repro_torch.kernels.link_load.ref import pack_routes

    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    out_dir = _build.build_dir().parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    lif_libs = build("lif_step", LIF_VARIANTS, out_dir, nvcc, _build.NVCC_FLAGS,
                     {"phases": instrumented})
    link_libs = build("link_loads", LINK_VARIANTS, out_dir, nvcc, _build.NVCC_FLAGS)
    stream = torch.cuda.current_stream().cuda_stream

    weights, drive_np = lif_inputs(32)
    syn = synapses_from_dense(torch.from_numpy(weights)).to("cuda")
    drive = torch.from_numpy(drive_np).to("cuda")
    kw = dict(decay=0.9, threshold=1.0, v_reset=0.0, refractory=1)
    raster, v, refr = lif_steps(syn, drive, **kw)
    n = weights.shape[0]
    prev, fired = raster[30].clone(), torch.empty(n, dtype=torch.uint8, device="cuda")
    print(f"probe lif_step: N={n}, {int(prev.sum())} sources fired at step 30")
    report("lif_step", lif_libs, "lif_step", LIF_ARGS, lambda: (
        syn.src.data_ptr(), syn.w.data_ptr(), syn.deg.data_ptr(),
        prev.data_ptr(), drive[31].data_ptr(), v.data_ptr(), refr.data_ptr(),
        v.data_ptr(), refr.data_ptr(), fired.data_ptr(), n, syn.src.shape[0],
        0.9, 1.0, 0.0, 1,
        stream), _build.check)
    torch.cuda.synchronize()
    clk = (ctypes.c_longlong * 16)()
    if lif_libs["phases"].read_clk(clk) != 0:
        raise RuntimeError("probe: reading the clock64 buffer failed")
    for slot, block in ((0, 40), (1, 79)):
        a = clk[slot * 8: slot * 8 + 5]
        parts = ", ".join(f"{name} {a[q + 1] - a[q]}"
                          for q, name in enumerate(LIF_PHASE_NAMES))
        print(f"probe lif_step phases, block {block} (cycles): {parts}; "
              f"total {a[4] - a[0]}")

    rng = np.random.default_rng(0)
    b, w, h, per = 256, 16, 16, 8000
    k = w * h
    cores = torch.arange(k, dtype=torch.int32, device="cuda")
    x, y = cores % w, cores // w
    woff = torch.arange(0, b * per + 1, per, dtype=torch.int32, device="cuda")
    out = torch.empty((b, 2 * (w - 1) * h + 2 * w * (h - 1)), dtype=torch.int32,
                      device="cuda")
    for label, run in (("random", 1), ("runs8", 8)):
        s = np.repeat(rng.integers(0, k, b * per // run), run)
        d = np.repeat(rng.integers(0, k, b * per // run), run)
        rec = pack_routes(torch.tensor(s, device="cuda"),
                          torch.tensor(d, device="cuda"))
        report(f"link_loads {label}", link_libs, "link_loads", LINK_ARGS,
               lambda rec=rec: (
            rec.data_ptr(), None, woff.data_ptr(), x.data_ptr(), y.data_ptr(),
            out.data_ptr(), b, b * per, w, h, stream), _build.check)
    return 0


if __name__ == "__main__":
    sys.exit(main())
