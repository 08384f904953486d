"""mapping_s: the program's own seconds of the mapping phase
(``phase_seconds["mapping"]``: the traffic matrix, the population SA and
the greedy polish on ``swap_deltas``, the placement's scoring), mean over
the traced jobs."""

SPANS = [("repro_torch.core.pipeline", "mapping_phase")]


def read(ctx):
    return sum(j["phase_seconds"]["mapping"] for j in ctx.jobs) / len(ctx.jobs)
