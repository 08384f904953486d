"""edge_cut: spikes communicated between partitions under the platform's
stated cast, mean over the cell's first ``quality_jobs`` jobs: the edge cut
under unicast, the connectivity-1 volume (the replay's NoC packets) under
multicast."""


def read(ctx):
    jobs = ctx.quality_jobs
    return sum(j["edge_cut"] for j in jobs) / len(jobs)
