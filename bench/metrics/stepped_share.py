"""stepped_share: the share of the queued replay's NoC-bound packets that
the joint stepper steps, in percent, over the traced jobs: the
``stepped`` counts of the program's ``sneap.replay.schedule`` spans (the
packets left after both screens) over the ``noc_packets`` counts of its
``sneap.replay.windows`` spans.  The rest are scored analytically.
Nothing to read where the program keeps no spans."""
import program_spans as ps


def read(ctx):
    jobs = ps.per_job(ctx.traces, ps.recorded())
    packets = ps.count(jobs, "sneap.replay.windows", "noc_packets")
    if not packets:
        return None
    stepped = ps.count(jobs, "sneap.replay.schedule", "stepped") or 0
    return 100.0 * stepped / packets
