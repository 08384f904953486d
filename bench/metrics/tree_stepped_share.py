"""tree_stepped_share: the share of the multicast replay's NoC-bound
firings that the tree-fork stepper steps, in percent, over the traced
jobs: the ``stepped_firings`` counts of the program's
``sneap.replay.tree.schedule`` spans (the firings left after both
screens) over the ``firings`` counts of its ``sneap.replay.tree.links``
spans.  The rest are scored analytically.  Nothing to read where the
program keeps no spans."""
import program_spans as ps


def read(ctx):
    jobs = ps.per_job(ctx.traces, ps.recorded())
    firings = ps.count(jobs, "sneap.replay.tree.links", "firings")
    if not firings:
        return None
    stepped = ps.count(jobs, "sneap.replay.tree.schedule",
                       "stepped_firings") or 0
    return 100.0 * stepped / firings
