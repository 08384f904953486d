"""Three-term roofline of the port's steps from op counts, at the H100's
data-sheet peaks.

  compute    = matmul FLOPs by dtype / that dtype's peak
               + pointwise FLOPs / the f32 CUDA-core peak
  memory     = bytes read + written, op by op / HBM bandwidth
  collective = the collectives' operand bytes (``coll:*``) / NVLink 4's
               rate a direction, 450 GB/s

Counts come from `repro_torch.launch.dryrun.count_cell`: the eager step
run on the meta device under `op_analysis.OpCounter`, either unsharded
on one card (no collective) or, with ``mesh`` (a counting mesh,
`repro_torch.launch.mesh.make_abstract_mesh`), the step of one position
of that mesh: per-chip counts, as the reference reads its partitioned
HLO, with the collectives its tally records.  ``roofline_terms`` takes
per-chip counters as they are; ``chips`` spreads one-card counts' compute
and memory evenly over more cards (an ideal split), never the
collective term.  The collective term is a floor: a 16-wide axis spans
two 8-card HGX nodes, whose link between them is slower than NVLink,
and a ring all-reduce moves each operand byte about twice.

The reference measures each cell at two truncated depths and extrapolates
because XLA's cost analysis sees a rolled loop once.  An eager step has no
loop to roll, but the same two-depth measurement is what the card can
afford (a full-depth model does not fit one card), so `measure_cell`
counts at ``n1`` and ``n2`` units and extrapolates linearly,

    v(L) = v(n2) + (v(n2) - v(n1)) / (n2 - n1) * (L - n2),

the ``coll:*`` counters too, as the reference's ``_counters`` does, and
also counts at the full depth on meta, recording the relative gap
between the two (``linear_gap``; 0 for FLOPs and bytes when
`truncate_config` keeps every flavor of the stack).  ``model_flops`` is
6*N*D (train) or 2*N*D (prefill, decode) with N the active parameters.
``main`` counts every cell per chip of the 16x16 mesh's first position
at the dry run's ``kv_chunk`` and the config's own ``ssm_chunk``: the
reference's larger prefill chunks bound the copies of its unrolled
loops, which an eager step does not make.  A record's ``chips`` is the
number of cards its counts are one of (the mesh's size, or 1 unsharded):
``useful_ratio`` and ``bound_mfu`` set the whole batch's 6ND
against the counts of all of them, as the reference multiplies its
per-chip HLO FLOPs by 256.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

__all__ = ["H100_BF16_FLOPS", "H100_TF32_FLOPS", "H100_F32_FLOPS",
           "H100_BYTES_PER_S", "H100_HBM_BYTES", "H100_NVLINK_BYTES_PER_S",
           "PEAK_MATMUL_FLOPS",
           "truncate_config", "measure_cell", "model_flops",
           "roofline_terms", "useful_ratio", "bound_mfu", "main"]

# H100 SXM data sheet, dense (no sparsity), at its 700 W power limit.
H100_BF16_FLOPS = 989.4e12  # bf16 / fp16 tensor cores
H100_TF32_FLOPS = 494.7e12  # TF32 tensor cores
H100_F32_FLOPS = 67e12  # f32 on the CUDA cores
H100_BYTES_PER_S = 3.35e12  # HBM3
H100_HBM_BYTES = 80e9
# NVLink 4 on the H100 SXM: 900 GB/s both ways, 450 GB/s a direction.
H100_NVLINK_BYTES_PER_S = 450e9
# A matmul's operand dtype -> its peak.  The port turns TF32 off
# (`repro_torch.device.resolve_device`), so f32 products run on the CUDA
# cores.
PEAK_MATMUL_FLOPS = {"bfloat16": H100_BF16_FLOPS, "float16": H100_BF16_FLOPS,
                     "float32": H100_F32_FLOPS}


def truncate_config(cfg, units: int):
    """Scale the repeating unit down while keeping every flavor intact."""
    fam = cfg.family
    if fam in ("dense", "ssm"):
        return dataclasses.replace(cfg, num_layers=units)
    if fam == "moe":
        return dataclasses.replace(
            cfg, num_layers=units + cfg.first_dense_layers)
    if fam == "hybrid":
        # keep exactly 3 global layers; scale the SWA count
        n = units + 3
        return dataclasses.replace(
            cfg, num_layers=n, global_attn_layers=(0, n // 2, n - 1))
    if fam == "vlm":
        per = cfg.cross_attn_every
        return dataclasses.replace(cfg, num_layers=(per + 1) * units)
    if fam == "audio":
        return dataclasses.replace(cfg, num_layers=units, encoder_layers=units)
    raise ValueError(fam)


def _units_of(cfg) -> int:
    """Number of repeating units in the full config."""
    fam = cfg.family
    if fam in ("dense", "ssm"):
        return cfg.num_layers
    if fam == "moe":
        return cfg.num_layers - cfg.first_dense_layers
    if fam == "hybrid":
        return cfg.num_layers - len(cfg.global_attn_layers)
    if fam == "vlm":
        return cfg.num_layers // (cfg.cross_attn_every + 1)
    if fam == "audio":
        return cfg.num_layers
    raise ValueError(fam)


def _counters(counts: dict) -> dict:
    """The extrapolated counters of one count: FLOPs (all, matmul by
    dtype, pointwise), bytes, and each collective's operand bytes
    (``coll:<op>``), as Python ints."""
    c = {"flops": counts["flops"], "bytes": counts["bytes accessed"],
         "flops_pointwise": counts["flops_pointwise"]}
    for dtype, v in counts["flops_matmul_by_dtype"].items():
        c[f"flops_matmul:{dtype}"] = v
    for op, v in counts.get("collectives", {}).items():
        if not op.startswith("_"):
            c[f"coll:{op}"] = v
    return c


def _extrapolate(v1: int, v2: int, n1: int, n2: int, units: int):
    """v(units) on the line through (n1, v1), (n2, v2); exact in integers
    where the slope is one."""
    if n1 == n2:
        return v2
    if (v2 - v1) % (n2 - n1) == 0:
        return v2 + (v2 - v1) // (n2 - n1) * (units - n2)
    return v2 + (v2 - v1) / (n2 - n1) * (units - n2)


def measure_cell(arch, shape, n1: int = 2, n2: int = 4,
                 kv_chunk: int = 1024, overrides: dict | None = None,
                 step_kwargs: dict | None = None, verbose: bool = True,
                 full: bool = True, mesh=None) -> dict:
    """Counts of a cell on meta at ``n1`` and ``n2`` units, extrapolated
    to the full depth (``counters``), and, with ``full``, counted at the
    full depth too (``full_counters``, ``linear_gap``).  ``arch`` is a name
    or an `ArchConfig`, ``shape`` a name of `SHAPES` or a `ShapeSpec`;
    ``depths`` holds each count's counters and memory.  Unsharded on one
    card, or per chip at the position of ``mesh`` (a counting mesh;
    ``partitioned`` says which)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES

    from .dryrun import count_cell

    cfg = get_config(arch) if isinstance(arch, str) else arch
    sp = SHAPES[shape] if isinstance(shape, str) else shape
    full_units = _units_of(cfg)
    n2 = min(n2, full_units)
    n1 = min(n1, max(n2 - 1, 1))
    rec = {"arch": cfg.name, "shape": sp.name, "n1": n1, "n2": n2,
           "units": full_units, "kv_chunk": kv_chunk,
           "overrides": overrides or {}, "step_kwargs": step_kwargs or {},
           "partitioned": mesh is not None,
           "chips": mesh.size(mesh.axis_names) if mesh is not None else 1}
    depths = {}
    for n in dict.fromkeys((n1, n2) + ((full_units,) if full else ())):
        tcfg = truncate_config(cfg, n)
        if overrides:
            tcfg = dataclasses.replace(tcfg, **overrides)
        try:
            counts = count_cell(tcfg, sp, kv_chunk=kv_chunk, mesh=mesh,
                                **(step_kwargs or {}))
        except Exception as e:  # noqa: BLE001 -- a sweep records the cell's failure
            return {**rec, "status": "error", "error": f"{type(e).__name__}: {e}",
                    "at_units": n}
        depths[n] = {"counters": _counters(counts), "memory": counts["memory"],
                     "count_s": counts["count_s"]}
        if verbose:
            print(f"[roofline] {cfg.name} x {sp.name} at {n} units: "
                  f"{counts['count_s']:.1f}s, flops={counts['flops']:.4e}")
    v1, v2 = depths[n1]["counters"], depths[n2]["counters"]
    out = {k: _extrapolate(v1.get(k, 0), v2.get(k, 0), n1, n2, full_units)
           for k in sorted(set(v1) | set(v2))}
    rec.update(status="ok", counters=out,
               count_s=[depths[n]["count_s"] for n in depths],
               depths={str(n): d for n, d in depths.items()})
    if full:
        fc = depths[full_units]["counters"]
        rec["full_counters"] = fc
        rec["linear_gap"] = {k: (fc[k] - out[k]) / fc[k] if fc[k] else 0.0
                             for k in ("flops", "bytes")}
    return rec


def model_flops(cfg, shape) -> float:
    """6*N*D (active params for MoE) per step, for the whole batch."""
    from repro_torch.configs.shapes import SHAPES

    sp = SHAPES[shape] if isinstance(shape, str) else shape
    n_active = cfg.active_params_billion() * 1e9
    if sp.kind == "train":
        tokens = sp.global_batch * sp.seq_len
        return 6.0 * n_active * tokens
    if sp.kind == "prefill":
        tokens = sp.global_batch * sp.seq_len
        return 2.0 * n_active * tokens
    tokens = sp.global_batch  # one token per sequence
    return 2.0 * n_active * tokens


def roofline_terms(counters: dict, chips: int = 1) -> dict:
    """Seconds of a step at the H100's peaks from `measure_cell`'s
    ``counters``: per-chip counters as they are; one-card counters'
    compute and memory spread evenly over ``chips`` cards.  The
    collective term is the ``coll:*`` bytes over NVLink's rate a
    direction, a floor (see the module docstring)."""
    if chips < 1:
        raise ValueError(f"chips must be >= 1, not {chips}")
    compute_s = counters.get("flops_pointwise", 0) / H100_F32_FLOPS
    for key, v in counters.items():
        if key.startswith("flops_matmul:"):
            dtype = key.split(":", 1)[1]
            if dtype not in PEAK_MATMUL_FLOPS:
                raise ValueError(f"no H100 peak for {dtype} matmuls")
            compute_s += v / PEAK_MATMUL_FLOPS[dtype]
    coll = sum(v for k, v in counters.items() if k.startswith("coll:"))
    terms = {"compute_s": compute_s / chips,
             "memory_s": counters.get("bytes", 0) / H100_BYTES_PER_S / chips,
             "collective_s": coll / H100_NVLINK_BYTES_PER_S}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant, "bound_s": terms[dominant],
            "coll_bytes": coll}


def useful_ratio(rec: dict, mf: float) -> float | None:
    """6ND of the whole batch (``mf``) over the FLOPs counted on all of
    the record's ``chips`` cards (its per-chip count times their number)."""
    flops = rec["counters"].get("flops", 0) * rec.get("chips", 1)
    return mf / flops if flops else None


def bound_mfu(rec: dict, mf: float, terms: dict) -> float:
    """The mfu of a step that ran at the record's bound: one card's share
    of 6ND at the bf16 peak over ``terms["bound_s"]`` (`roofline_terms`
    of its counters); at most 1 where the counted work holds the useful
    work (the report's "roofline frac")."""
    if not terms["bound_s"]:
        return 0.0
    return mf / rec.get("chips", 1) / H100_BF16_FLOPS / terms["bound_s"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--kv-chunk", type=int, default=1024)
    ap.add_argument("--out", default="results/torch_roofline_raw.jsonl")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    from repro_torch.configs import ARCHS, get_config
    from repro_torch.configs.shapes import SHAPES, applicable

    from .mesh import make_abstract_mesh

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    done = set()
    if out.exists() and not args.force:
        for line in out.read_text().splitlines():
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("status") in ("ok", "skip"):
                done.add((r["arch"], r["shape"]))
    archs = ARCHS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes:
            if (arch, shape) in done:
                continue
            ok, reason = applicable(cfg, shape)
            if not ok:
                rec = {"arch": arch, "shape": shape, "status": "skip",
                       "reason": reason}
            else:
                rec = measure_cell(arch, shape, kv_chunk=args.kv_chunk,
                                   mesh=make_abstract_mesh())
                if rec["status"] == "ok":
                    mf = model_flops(cfg, shape)
                    rec["model_flops"] = mf
                    rec["roofline"] = roofline_terms(rec["counters"])
                    rec["useful_ratio"] = useful_ratio(rec, mf)
            with out.open("a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"[roofline] written -> {out}")


if __name__ == "__main__":
    main()
