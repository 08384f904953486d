"""sa_roofline: the mapping's least device time over the device time inside
the ``mapping_phase`` span, in percent.

The work is what the search's own schedule asks for, read from the call of
``sa_search_jax_batch`` (iterations, chains, steps a temperature, the
configs and their partition counts K) and from the ``swap_deltas`` launches
(one a polish step):

* each proposal of each chain reads two traffic rows and two distance rows
  of K float64 entries and does 4 K float64 operations;
* each polish step reads the K x K float32 traffic block and writes the K x
  K swap deltas once, and does 2 K^3 operations (the product the deltas
  come from) on the TF32 tensor cores.

The least time is the larger of the bytes over the HBM rate and the
operations over their peaks (float64 on the CUDA cores, TF32)."""

SPANS = [("repro_torch.core.pipeline", "mapping_phase"),
         ("repro_torch.core.mapping_device", "sa_search_jax_batch")]
COUNTERS = [("repro_torch.kernels.swap_delta.kernel", "launches")]
SPAN = "bench.mapping_phase"


def job_work(call: dict, polish_steps: int) -> tuple[float, float, float]:
    """(bytes, float64 operations, TF32 operations) of one search call."""
    ks = [int(t.shape[0]) for t in call["traffics"]]
    sweeps = int(call["sweeps_per_temp"])
    epochs = max(int(call["iters"]) // sweeps, 1)
    proposals = epochs * sweeps * int(call["chains"])
    nbytes = sum(proposals * 4 * k * 8 for k in ks)
    f64 = sum(proposals * 4 * k for k in ks)
    k = max(ks)
    nbytes += polish_steps * 2 * k * k * 4
    return float(nbytes), float(f64), float(polish_steps * 2 * k ** 3)


def read(ctx):
    key = "{}.{}".format(*COUNTERS[0])
    nbytes = f64 = tf32 = 0.0
    for j in ctx.jobs:
        calls = j.get("calls", {}).get("sa_search_jax_batch", [])
        if len(calls) != 1:
            return None
        b, f, t = job_work(calls[0], j["launches"][key])
        nbytes, f64, tf32 = nbytes + b, f64 + f, tf32 + t
    device = [t.device_s(SPAN) for t in ctx.traces]
    if any(d is None for d in device) or not sum(device):
        return None
    p = ctx.peaks
    least = max(nbytes / p["hbm_bytes_per_s"],
                f64 / p["f64_flops"] + tf32 / p["tf32_flops"])
    return 100.0 * least / sum(device)
