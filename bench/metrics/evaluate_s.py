"""evaluate_s: the program's own seconds of the evaluation phase
(``phase_seconds["evaluate"]``: ``simulate_noc``, queued or analytic),
mean over the traced jobs."""

SPANS = [("repro_torch.core.pipeline", "evaluate_phase")]


def read(ctx):
    return sum(j["phase_seconds"]["evaluate"] for j in ctx.jobs) / len(ctx.jobs)
