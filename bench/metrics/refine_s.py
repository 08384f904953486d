"""refine_s: seconds of the partitioner's refinement, from the program's
own ``sneap.partition.refine`` spans (one a level, coarse to fine, on the
degree kernels where a level is dense enough), mean over the traced jobs.
Nothing to read where the program keeps no spans."""
import program_spans as ps

NAMES = ("sneap.partition.refine",)


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
