"""Faults planted in the program for a run: each breaks the timed path
underneath, and a run with one planted has to come out not correct.

Each takes ``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
`Planted` here) and plants itself through it.  ``bench/tests`` drives whole
runs with each at a tiny size; ``bench/control.py --faults`` reads them at a
cell's own size on the card.  The benchmark's own runs never plant one.
"""
from __future__ import annotations

__all__ = ["FAULTS", "Planted"]


def search_unchanged(patch):
    """The search's steps return the state they were given; the polish
    still runs."""
    from repro_torch.core import mapping_device

    patch(mapping_device._Population, "epoch",
          lambda self: self.best.copy_(self.cost))


def state_unchanged(patch):
    """The search's steps and the polish return the state they were given."""
    from repro_torch.core import mapping_device

    search_unchanged(patch)
    patch(mapping_device, "greedy_polish",
          lambda sym, placement, x, y, **kw: (placement.clone(), 1))


def half_left_out(patch):
    """The placement search sees half of the trace's transmissions."""
    from repro_torch.core import pipeline

    inner = pipeline.build_traffic

    def half(profile, pres, cfg):
        return inner(profile, pres, cfg) // 2

    patch(pipeline, "build_traffic", half)


def answer_altered(patch):
    """One neuron's partition is altered where the partition is produced."""
    from repro_torch.core import pipeline

    inner = pipeline.partition_phase

    def altered(profile, cfg):
        pres = inner(profile, cfg)
        pres.part = pres.part.copy()
        pres.part[0] = (pres.part[0] + 1) % pres.k
        return pres

    patch(pipeline, "partition_phase", altered)


def spikes_altered(patch):
    """One transmission of the profile's trace is altered."""
    import repro_torch.snn as snn

    inner = snn.profile_snn

    def altered(*args, **kwargs):
        prof = inner(*args, **kwargs)
        prof.trace_dst = prof.trace_dst.copy()
        prof.trace_dst[0] = (prof.trace_dst[0] + 1) % prof.num_neurons
        return prof

    patch(snn, "profile_snn", altered)


FAULTS = {f.__name__: f for f in (search_unchanged, state_unchanged,
                                  half_left_out, answer_altered,
                                  spikes_altered)}


class Planted:
    """``with Planted(fault):`` plants ``fault`` and takes it out again."""

    def __init__(self, fault):
        self.fault, self.saved = fault, []

    def __enter__(self):
        def patch(obj, name, value):
            self.saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, value)

        self.fault(patch)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()
