"""conn_roofline: the least device time of the volume refiner's D* rows
that the connectivity kernel evaluates, over the device time inside the
refinement levels (the ``refine_level_vec`` span, every level and engine),
in percent.

The work is read from the refiner's own ``sneap.partition.refine.eval``
spans whose ``engine`` is ``kernel`` (``rows``, ``inc_entries``, ``edges``
and ``k``), not from the kernel's wrapper, so another way of evaluating the
same rows reads the same work.  Host-engine evaluations add no bytes.  The
least time is the bytes over the HBM rate (``eval_bytes``)."""
import program_spans as ps

SPANS = [("repro_torch.core.refine_vec", "refine_level_vec")]
SPAN = "bench.refine_level_vec"
EVAL = "sneap.partition.refine.eval"


def eval_bytes(rows: int, inc_entries: int, edges: int, k: int) -> int:
    """Bytes one evaluation moves, from ``csrc/connectivity_degrees.cu``: a
    block a row reads the row's two CSR offsets (``vxadj``, 4 + 4), its id
    and its own partition (``rows``, ``own``, 8 + 8), and for each entry of
    its incidence list the hyperedge id and weight (``vedges``, ``w``,
    4 + 4), and writes its k float32 sums.  The entries gather rows of Φ,
    the (E, k) int32 member counts: the kernel's own bound counts Φ once a
    call, and a call gathers no more of its rows than it has entries, so
    Φ adds 4 k min(E, entries) bytes."""
    phi_rows = min(edges, inc_entries)
    return 24 * rows + 8 * inc_entries + 4 * k * rows + 4 * k * phi_rows


def read(ctx):
    jobs = ps.per_job(ctx.traces, ps.recorded())
    if not jobs:
        return None
    nbytes = sum(eval_bytes(s.attrs["rows"], s.attrs["inc_entries"],
                            s.attrs["edges"], s.attrs["k"])
                 for j in jobs for s in j
                 if s.name == EVAL and s.attrs.get("engine") == "kernel")
    device = [t.device_s(SPAN) for t in ctx.traces]
    if not nbytes or any(d is None for d in device) or not sum(device):
        return None
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / sum(device)
