"""vol_select_s: seconds of the volume refiner's conflict-free mover
selection, from the program's own ``sneap.partition.refine.select`` spans
(one a batch of a volume level, on the selection kernel or on the host as
their ``engine`` says), mean over the traced jobs.  Nothing to read where
the program keeps no such span."""
import program_spans as ps

NAMES = ("sneap.partition.refine.select",)


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
