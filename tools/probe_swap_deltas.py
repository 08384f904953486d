#!/usr/bin/env python3
"""Where the time of the swap_deltas kernel goes, on one GPU.

    python3 tools/probe_swap_deltas.py

Builds variants of ``src/repro_torch/csrc/swap_deltas.cu`` with parts cut
out (text substitutions on a copy under ``build/probe/``; the source is
not touched) and times each at K = 256 (16 x 16 mesh) and K = 1024
(32 x 32 mesh) on integer traffic: microseconds a launch from CUDA events
around back-to-back launches (a floor of the host's launch rate for short
kernels) and the profiler's device time a launch.  The variants' outputs
are wrong by construction; only their times mean anything.

  base         the kernel as it is
  no_mma       each MMA replaced by one FMA on its operands
  no_r         the r row sums cut to one add per k-tile
  no_mma_no_r  both
  loads_only   the k-loop keeps its cp.async ring and barriers only
  empty        every block returns after finding its tile pair
  tile32       32-wide tiles at every K (the kernel picks 16 up to 512)

Then a copy instrumented with ``clock64`` prints, for thread 0 of blocks 0
and 100, the cycles of the prologue, of each phase of a k-step (averaged
over the k-tiles: cp.async wait, first barrier, r sums and S_ij capture,
fragments and MMAs, second barrier) and of the epilogue.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MMA = '''  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));'''
FMA = "  c[0] += __uint_as_float(a[0] ^ a[3]) * __uint_as_float(b0 ^ b1);"
R_SUM = '''      r_part += sv.x * manhattan(qx, qy, xv.x, yv.x);
      r_part += sv.y * manhattan(qx, qy, xv.y, yv.y);
      r_part += sv.z * manhattan(qx, qy, xv.z, yv.z);
      r_part += sv.w * manhattan(qx, qy, xv.w, yv.w);'''
ONE_ADD = "      r_part += sv.x;"
FRAGMENTS = "    float rx[MT][2], ry[MT][2];  // D[i, k] rows: i0 + mt*16 + g (+8)"
SKIP = "    if (K > 0) {\n      __syncthreads();\n      continue;\n    }\n" + FRAGMENTS
# clock64 probes: (anchor text, text to put in its place).
PHASES = (
    ("namespace {\n", "namespace {\n__device__ long long g_clk[512];\n"),
    ("  const int kk0 = warp * 8;\n",
     "  const int kk0 = warp * 8;\n"
     "  const int slot = blockIdx.x == 0 ? 0 : (blockIdx.x == 100 ? 1 : -1);\n"
     "  auto rec = [&](int i) {\n"
     "    if (tid == 0 && slot >= 0) g_clk[slot * 256 + i] = clock64();\n"
     "  };\n  rec(0);\n"),
    ("  for (int kt = 0; kt < nk; ++kt) {\n",
     "  rec(1);\n  for (int kt = 0; kt < nk; ++kt) {\n"),
    ("    cp_async_wait<STAGES - 1>();  // k-tile kt has landed\n"
     "    __syncthreads();\n",
     "    cp_async_wait<STAGES - 1>();\n    rec(2 + kt * 5);\n"
     "    __syncthreads();\n    rec(3 + kt * 5);\n"),
    (FRAGMENTS, "    rec(4 + kt * 5);\n" + FRAGMENTS),
    ("    __syncthreads();  // the next iteration refills stage st\n",
     "    rec(5 + kt * 5);\n    __syncthreads();\n    rec(6 + kt * 5);\n"),
    ("  cp_async_wait<0>();\n", "  cp_async_wait<0>();\n  rec(240);\n"),
    ("}\n\ntemplate <int TILE>\nvoid launch(",
     "  rec(241);\n}\n\ntemplate <int TILE>\nvoid launch("),
)
READ_CLK = """
extern "C" int read_clk(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_clk, sizeof(long long) * 512));
}
"""
PHASE_NAMES = ("wait", "barrier 1", "r + S_ij", "fragments + MMA", "barrier 2")
PAIR = "  const int bj = bi + rem;\n"
RETURN = PAIR + "  if (K > 0) return;\n"


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise SystemExit(f"probe: the kernel source changed; cannot find:\n{old}")
    return src.replace(old, new)


def variants(src: str) -> dict[str, str]:
    no_mma = sub(src, MMA, FMA)
    return {
        "base": src,
        "no_mma": no_mma,
        "no_r": sub(src, R_SUM, ONE_ADD),
        "no_mma_no_r": sub(no_mma, R_SUM, ONE_ADD),
        "loads_only": sub(src, FRAGMENTS, SKIP),
        "empty": sub(src, PAIR, RETURN),
        "tile32": sub(src, "    if (K <= 512) {", "    if (K <= 0) {"),
        "phases": instrumented(src),
    }


def instrumented(src: str) -> str:
    for old, new in PHASES:
        src = sub(src, old, new)
    return src + READ_CLK


def print_phases(lib, k: int) -> None:
    """Cycle counts of the instrumented build's last launch."""
    clk = (ctypes.c_longlong * 512)()
    if lib.read_clk(clk) != 0:
        raise RuntimeError("probe: reading the clock64 buffer failed")
    nk = -(-k // 32)
    for slot, block in ((0, 0), (1, 100)):
        a = clk[slot * 256: slot * 256 + 256]
        steps = [[a[2 + 5 * kt + i] - (a[1] if kt == 0 and i == 0 else
                                        a[1 + 5 * kt + i]) for i in range(5)]
                 for kt in range(nk)]
        mean = [sum(col) / nk for col in zip(*steps)]
        parts = ", ".join(f"{n} {m:.0f}" for n, m in zip(PHASE_NAMES, mean))
        print(f"probe swap_deltas K={k} phases, block {block} (cycles): "
              f"prologue {a[1] - a[0]}; per k-step ({nk}) {parts}; "
              f"epilogue {a[241] - a[240]}; total {a[241] - a[0]}")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, device_ms
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    out_dir = _build.build_dir().parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "swap_deltas.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT), so)
    fns, libs = {}, {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            print(f"probe: nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = ctypes.CDLL(str(so))
        fn = libs[name].swap_deltas_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    rng = np.random.default_rng(0)
    for k, mesh_w, top in ((256, 16, 600), (1024, 32, 60)):
        c = rng.integers(0, top, (k, k)).astype(np.float32)
        sym = torch.tensor(c + c.T, device="cuda")
        place = rng.permutation(k)
        x = torch.tensor((place % mesh_w).astype(np.float32), device="cuda")
        y = torch.tensor((place // mesh_w).astype(np.float32), device="cuda")
        out = torch.empty((k, k), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for name, fn in fns.items():
            def call(fn=fn):
                _build.check(fn(sym.data_ptr(), x.data_ptr(), y.data_ptr(),
                                out.data_ptr(), k, stream), name)
            print(f"probe swap_deltas K={k} {name}: events "
                  f"{cuda_ms(call, 200) * 1e3:.3f} us, device "
                  f"{device_ms(call, 200) * 1e3:.3f} us a launch")
        torch.cuda.synchronize()
        print_phases(libs["phases"], k)
    return 0


if __name__ == "__main__":
    sys.exit(main())
