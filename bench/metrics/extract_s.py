"""extract_s: seconds of the profile's host extraction, from the program's
own spans: ``sneap.profile.extract`` (the trace expanded from the raster,
cut at the spike target) and ``sneap.profile.graph`` (the synapse graph and
the multicast hypergraph), mean over the traced jobs.  Nothing to read
where the program keeps no spans or the profile is made in set-up."""
import program_spans as ps

NAMES = ("sneap.profile.extract", "sneap.profile.graph")


def read(ctx):
    return ps.seconds(ps.per_job(ctx.traces, ps.recorded()), NAMES)
