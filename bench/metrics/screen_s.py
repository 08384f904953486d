"""screen_s: seconds of the queued replay's host screens, from the
program's own spans: ``sneap.noc.order`` (the canonical record sort and the
local split), ``sneap.replay.windows`` (window ids, injection cycles,
hops), ``sneap.replay.screen`` (the ``link_loads`` call with its upload and
download), ``sneap.replay.expand`` (the dirty windows' route expansion and
membership) and ``sneap.replay.schedule`` (the static schedule screen),
mean over the traced jobs.  Nothing to read where the program keeps no
spans."""
import program_spans as ps

NAMES = ("sneap.noc.order", "sneap.replay.windows", "sneap.replay.screen",
         "sneap.replay.expand", "sneap.replay.schedule")


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
