"""lif_roofline: the profile's least device time over the device time inside
the ``profile_snn`` span, in percent.

The least time is the bytes the profile's steps need over the HBM rate:
each step reads the synapse list once (a source id and a weight a synapse),
each neuron's synapse count, the previous raster row and the drive row, and
reads and writes the membrane state and the refractory counter once and
writes the raster row.  The steps are those the ``lif_step`` wrapper counts.
The span's device time holds every kernel and copy of the profile, so the
count measures the same work whatever implements it."""

SPANS = [("repro_torch.snn", "profile_snn")]
COUNTERS = [("repro_torch.kernels.lif_step.kernel", "launches")]
SPAN = "bench.profile_snn"


def step_bytes(num_neurons: int, num_synapses: int) -> int:
    """Bytes one step needs: 8 a synapse, 4 + 1 + 4 for the count, the
    previous raster row and the drive row, 8 + 8 for v and refr read and
    written, 1 for the raster row written, a neuron."""
    return 8 * num_synapses + 26 * num_neurons


def read(ctx):
    key = "{}.{}".format(*COUNTERS[0])
    steps = sum(j.get("launches", {}).get(key, 0) for j in ctx.jobs)
    device = [t.device_s(SPAN) for t in ctx.traces]
    if not steps or any(d is None for d in device) or not sum(device):
        return None
    net = ctx.network
    nbytes = steps * step_bytes(net.num_neurons, int(net.syn_src.shape[0]))
    return 100.0 * nbytes / ctx.peaks["hbm_bytes_per_s"] / sum(device)
