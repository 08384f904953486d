"""vol_eval_s: seconds of the volume refiner's D* row evaluations, from the
program's own ``sneap.partition.refine.eval`` spans (one an evaluated chunk
of rows, by any engine: the connectivity kernel, the host's dense
incidence product or its gather over the incidence lists), mean over the
traced jobs.  Nothing to read where the program keeps no spans."""
import program_spans as ps

NAMES = ("sneap.partition.refine.eval",)


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
