"""polish_s: seconds of the greedy polish after the device SA, from the
program's own ``sneap.polish`` spans (one ``swap_deltas`` launch and one
host read a step), mean over the traced jobs.  Nothing to read where the
program keeps no spans."""
import program_spans as ps

NAMES = ("sneap.polish",)


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
