"""partition_s: the program's own seconds of the partition phase
(``phase_seconds["partition"]``: `sneap_partition`, its coarsening,
initial partition and refinement on the degree kernels), mean over the
traced jobs."""

SPANS = [("repro_torch.core.pipeline", "partition_phase")]


def read(ctx):
    return sum(j["phase_seconds"]["partition"] for j in ctx.jobs) / len(ctx.jobs)
