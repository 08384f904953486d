#!/usr/bin/env python3
"""Where the time of the hop_cost kernel goes, on one GPU.

    python3 tools/probe_hop_cost.py

Builds variants of ``src/repro_torch/csrc/hop_cost.cu`` (text
substitutions on a copy under ``build/probe/``; the source is not
touched) and times each at K = 141 (the slice runs' partition count) and
K = 4096 on integer traffic, over several grid sizes: the profiler's
device time a launch and microseconds a launch from CUDA events around
back-to-back launches (a floor of the host's launch rate for short
kernels).  ``grid`` = the wrapper's choice (``kernel.grid_blocks``).

  base       the kernel as it is (UNROLL = 2 float4 loads a thread)
  unroll4    4 loads a thread in flight
  unroll8    8 loads a thread in flight
  general    the base library at K = 4096 with the float4 column path
             off (each element's column coordinates loaded alone)
  no_ticket  every block writes its partial and returns: no ticket, no
             final sum (the result is wrong; times the first phase)
  empty      every block returns at once (the launch's floor)

Only the base variant's results are checked (against the plain version,
rtol 1e-6); the others are wrong by construction or not the shipped code.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UNROLL = "constexpr int UNROLL = 2;"
TICKET = "last = atomicAdd(ticket, 1u) == gridDim.x - 1;"
ENTRY = "  __shared__ bool last;\n"
VARIANTS = {
    "base": [],
    "unroll4": [(UNROLL, "constexpr int UNROLL = 4;")],
    "unroll8": [(UNROLL, "constexpr int UNROLL = 8;")],
    "no_ticket": [(TICKET, "last = false;")],
    "empty": [(ENTRY, ENTRY + "  if (K > 0) return;\n")],
}


def build(variants: dict) -> dict[str, Path]:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    src = (ROOT / "src" / "repro_torch" / "csrc" / "hop_cost.cu").read_text()
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"probe: anchor for {name} not found")
            text = text.replace(old, new)
        cu = out_dir / f"hop_cost_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"hop_cost_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import cuda_ms, device_ms
    from repro_torch.kernels.hop_eval import kernel as hk
    from repro_torch.kernels.hop_eval.ref import hop_cost_ref

    libs = build(VARIANTS)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    for k, mesh_w in ((141, 16), (4096, 64)):
        c = torch.tensor(rng.integers(0, 600, (k, k)).astype(np.float32), device=dev)
        place = rng.permutation(max(k, mesh_w * mesh_w))[:k]
        x = torch.tensor((place % mesh_w).astype(np.float32), device=dev)
        y = torch.tensor((place // mesh_w).astype(np.float32), device=dev)
        want = hop_cost_ref(c, x, y)
        grid = hk.grid_blocks(k, sms)
        grids = sorted({grid, 1, 2, sms, 2 * sms, 4 * sms, 8 * sms, 16 * sms,
                        -(-k * k // 4 // hk.THREADS)})
        print(f"K={k}: wrapper grid {grid}; bound "
              f"{k * k * 4 / 3.35e12 * 1e6:.3f} us (bytes)")
        runs = [(name, path, int(k % 4 == 0)) for name, path in libs.items()]
        if k % 4 == 0:
            runs.insert(1, ("general", libs["base"], 0))
        for name, lib_path, row_vectors in runs:
            fn = getattr(ctypes.CDLL(str(lib_path)), "hop_cost_launch")
            fn.argtypes = hk._ARGTYPES
            fn.restype = ctypes.c_int
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            out = torch.empty(1, dtype=torch.float32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream
            for blocks in grids:
                partials = torch.empty(blocks, dtype=torch.float64, device=dev)

                def call(blocks=blocks, partials=partials):
                    rc = fn(c.data_ptr(), x.data_ptr(), y.data_ptr(),
                            partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                            k, 0, row_vectors, blocks, stream)
                    if rc:
                        raise SystemExit(f"probe: launch failed ({rc})")

                call()
                torch.cuda.synchronize()
                checked = name in ("base", "general")
                if checked and not torch.allclose(out[0], want, rtol=1e-6,
                                                  atol=0.0):
                    raise SystemExit(f"probe: {name} at K={k}, {blocks} blocks "
                                     f"differs: {float(out[0])} vs {float(want)}")
                dev_ms = device_ms(call, 50)
                dev_us = "     n/a" if dev_ms is None else f"{dev_ms * 1e3:8.3f}"
                ev_us = cuda_ms(call, 50) * 1e3
                print(f"  {name:9s} blocks={blocks:5d}: device {dev_us} us, "
                      f"events {ev_us:8.3f} us a launch")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
