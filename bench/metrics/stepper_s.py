"""stepper_s: seconds of the replay's joint stepper over the congested
windows, from the program's own ``sneap.replay.stepper`` spans (the torch
cycle loop on the card, with its host reads every ``CHECK_EVERY`` cycles),
mean over the traced jobs.  Nothing to read where the program keeps no
spans."""
import program_spans as ps

NAMES = ("sneap.replay.stepper",)


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
