"""job_s: the window's wall time over the jobs it completed.  The window is
the span of whole jobs, back to back, so a stall between or inside jobs
counts."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs)
