"""vol_refine_s: seconds of the partitioner's refinement under the volume
objective, from the program's own ``sneap.partition.refine`` spans (one a
level, coarse to fine) that hold ``sneap.partition.refine.eval`` spans: a
volume level evaluates its D* rows inside such children, on the
connectivity kernel or on the host, as their ``engine`` says.  Mean over
the traced jobs.  Nothing to read where the program keeps no spans or no
level evaluates its rows so."""
import program_spans as ps

NAMES = ("sneap.partition.refine",)
EVAL = "sneap.partition.refine.eval"


def read(ctx):
    jobs = ps.per_job(ctx.traces, ps.recorded())
    if jobs is not None:
        jobs = [[s for s in j if s.id in {e.parent for e in j
                                          if e.name == EVAL}]
                for j in jobs]
    return ps.seconds(jobs, NAMES)
