"""sa_host_s: seconds the card idles while the device SA's host sets up a
call: inside the program's ``sneap.sa.setup`` span (the traffic's upload,
the chains, their first costs) and the ``sneap.sa.epoch`` that captures
the epoch's CUDA graph (attr ``captured``: an eager warm-up epoch, then
the capture), outside their ``sneap.sa.wait`` spans (reads of a device
result: the device's own pace), from the profiler's device activity, mean
over the traced jobs.  The other epochs are left out: outside the profiler
the host draws and replays an epoch far faster than the card runs its
graph, so idle card inside them is the profiler's cost on graph launches.
Nothing to read where the program keeps no spans."""
import program_spans as ps

NAMES = ("sneap.sa.setup", "sneap.sa.epoch")
INNER = ("sneap.sa.wait",)


def _one_off(spans):
    return [s for s in spans
            if s.name != "sneap.sa.epoch" or s.attrs.get("captured")]


def read(ctx):
    jobs = ps.per_job(ctx.traces, ps.recorded())
    if jobs is not None:
        jobs = [_one_off(j) for j in jobs]
    return ps.idle_outside(ctx.traces, jobs, NAMES, INNER)
