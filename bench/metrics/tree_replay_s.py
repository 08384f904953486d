"""tree_replay_s: seconds of the multicast replay after the record sort,
from the program's own spans: ``sneap.noc.dedupe`` (the firings and their
(firing, destination core) packets) and ``sneap.replay.tree.links`` (window
ids, injection cycles, the XY trees and their parent pointers),
``.screen`` (the overload screen on the link-load kernel), ``.schedule``
(the static schedule screen), ``.stepper`` (the host's tree-fork cycle
loop) and ``.stats``, mean over the traced jobs.  Nothing to read where
the program keeps no spans."""
import program_spans as ps

NAMES = ("sneap.noc.dedupe", "sneap.replay.tree.links",
         "sneap.replay.tree.screen", "sneap.replay.tree.schedule",
         "sneap.replay.tree.stepper", "sneap.replay.tree.stats")


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
