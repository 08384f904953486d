"""Carry the reference's artifacts over into this package's dataclasses.

The tests feed each stage of the port the reference's own upstream output,
so that a fault shows up in the stage that caused it.  Every function here
takes plain numpy fields — a dict, or any object with the attributes — and
never a type of the reference package, which this package does not import.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, Hypergraph
from repro_torch.core.partition import PartitionResult
from repro_torch.snn.simulate import ProfileResult
from repro_torch.snn.topology import SNNTopology

__all__ = ["graph_from", "hypergraph_from", "partition_from", "profile_from",
           "topology_from"]


def _get(obj, name: str, default=None):
    if isinstance(obj, dict):
        return obj.get(name, default)
    return getattr(obj, name, default)


def _arr(obj, name: str) -> np.ndarray:
    return np.array(_get(obj, name))


def topology_from(obj) -> SNNTopology:
    """An `SNNTopology` from ``syn_src``, ``syn_dst``, the dense ``weights``
    and the stimulus fields (``name``, ``layer_sizes``, ``input_size``,
    ``input_rate``, ``input_amp``, ``target_spikes``)."""
    return SNNTopology(
        name=str(_get(obj, "name")),
        layer_sizes=[int(v) for v in _get(obj, "layer_sizes")],
        syn_src=_arr(obj, "syn_src"),
        syn_dst=_arr(obj, "syn_dst"),
        weights=_arr(obj, "weights"),
        input_size=int(_get(obj, "input_size")),
        input_rate=float(_get(obj, "input_rate")),
        input_amp=float(_get(obj, "input_amp")),
        target_spikes=(None if _get(obj, "target_spikes") is None
                       else int(_get(obj, "target_spikes"))),
        meta=dict(_get(obj, "meta", None) or {}),
    )


def hypergraph_from(obj) -> Hypergraph:
    """A `Hypergraph` from its CSR fields (``hxadj``, ``hpins``, ``hwgt``,
    ``hsrc``, ``hfire``, ``num_vertices``)."""
    return Hypergraph(
        hxadj=_arr(obj, "hxadj"), hpins=_arr(obj, "hpins"),
        hwgt=_arr(obj, "hwgt"), hsrc=_arr(obj, "hsrc"),
        hfire=_arr(obj, "hfire"), num_vertices=int(_get(obj, "num_vertices")),
    )


def graph_from(obj) -> Graph:
    """A `Graph` from its CSR fields (``xadj``, ``adjncy``, ``adjwgt``,
    ``vwgt``), with a coarsening level's ``cmap`` and the ``hyper`` view
    attached when the source has them."""
    graph = Graph(_arr(obj, "xadj"), _arr(obj, "adjncy"),
                  _arr(obj, "adjwgt"), _arr(obj, "vwgt"))
    if _get(obj, "cmap") is not None:
        graph.cmap = _arr(obj, "cmap")
    hyper = _get(obj, "hyper")
    if hyper is not None:
        graph.hyper = hypergraph_from(hyper)
    return graph


def profile_from(obj) -> ProfileResult:
    """A `ProfileResult` from a profile's fields, its ``graph`` (and the
    graph's ``hyper``) given the same way."""
    return ProfileResult(
        name=str(_get(obj, "name")),
        graph=graph_from(_get(obj, "graph")),
        trace_t=_arr(obj, "trace_t"),
        trace_src=_arr(obj, "trace_src"),
        trace_dst=_arr(obj, "trace_dst"),
        num_neurons=int(_get(obj, "num_neurons")),
        num_steps=int(_get(obj, "num_steps")),
        fire_counts=_arr(obj, "fire_counts"),
        seconds=float(_get(obj, "seconds", 0.0)),
    )


def partition_from(obj) -> PartitionResult:
    """A `PartitionResult` from ``part``, ``k``, ``edge_cut``, ``capacity``
    and the optional bookkeeping fields."""
    vol = _get(obj, "comm_volume")
    return PartitionResult(
        part=_arr(obj, "part"), k=int(_get(obj, "k")),
        edge_cut=int(_get(obj, "edge_cut")),
        capacity=int(_get(obj, "capacity")),
        num_levels=int(_get(obj, "num_levels", 0)),
        seconds=float(_get(obj, "seconds", 0.0)),
        impl=str(_get(obj, "impl", "scalar")),
        objective=str(_get(obj, "objective", "cut")),
        comm_volume=None if vol is None else int(vol),
    )
