"""avg_hop: the placement's average hops a spike (the paper's Eq. 2, as the
program reports it and the reference recounts it), mean over the cell's
first ``quality_jobs`` jobs, which every run completes."""


def read(ctx):
    jobs = ctx.quality_jobs
    return sum(j["avg_hop"] for j in jobs) / len(jobs)
