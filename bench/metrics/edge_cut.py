"""edge_cut: spikes carried between partitions, mean over the cell's first
``quality_jobs`` jobs."""


def read(ctx):
    jobs = ctx.quality_jobs
    return sum(j["edge_cut"] for j in jobs) / len(jobs)
