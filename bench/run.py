#!/usr/bin/env python3
"""Run one cell of the benchmark on the card this process sees.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``, ``bench/``
and the port (``src/repro_torch``).  Prints progress and, last, each number
of the comparison beside its limit on standard error, and one JSON object on
the last line of standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks`` comes
last.  Exits non-zero without a result where there is no card, where the
port is missing, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Build and kernel caches stay inside the checkout, at fixed paths.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path.insert(0, str(ROOT / "src"))


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        err("bench: the port (src/repro_torch) is not in this checkout")
        return 2
    import harness
    import torch

    spec = harness.load_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        err(f"bench: {args.workload} needs {spec.chips} CUDA device(s); "
            f"this process sees {torch.cuda.device_count()}")
        return 3
    out = harness.run(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                      T_START, log=err)
    for name, c in out["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAIL"
        err(f"check {name}: {c['value']!r} limit {c['limit']!r} {ok}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
