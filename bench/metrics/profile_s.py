"""profile_s: host seconds around ``repro_torch.snn.profile_snn`` in a job
(the device loop and the host extraction together), mean over the traced
jobs.  Nothing to read where the profile is made in set-up."""

SPANS = [("repro_torch.snn", "profile_snn")]


def read(ctx):
    times = [j["profile_s"] for j in ctx.jobs if "profile_s" in j]
    return sum(times) / len(times) if times else None
