"""Profiling phase: simulate an SNN, emit its graph + spike trace (paper §3.2).

The simulator raster is post-processed into the three artifacts the rest
of the toolchain consumes:
  * the spike-weighted undirected synapse graph G(N, S) — edge weight =
    number of spikes communicated on that synapse over the window,
  * the multicast hypergraph H(N, E) attached as ``graph.hyper`` — one
    hyperedge per firing neuron holding its destination pin set with
    per-pin spike counts (the ``objective="volume"`` partitioning metric
    and the multicast NoC replay both derive from it), and
  * the spike trace — (time_step, src_neuron, dst_neuron) per transmission
    (a neuron firing with fan-out f contributes f trace records).

If the topology declares a `target_spikes` count (Table 1), the trace is
truncated at the time step where the cumulative transmission count first
reaches the target, so benchmark traffic volumes match the paper.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.graph import Graph, Hypergraph, build_graph, build_hypergraph
from repro_torch.device import resolve_device
from repro_torch.kernels.lif_step import synapses_from_dense

from .lif import LIFParams, lif_run_synapses
from .topology import SNNTopology

__all__ = ["ProfileResult", "profile_drive", "profile_snn"]


@dataclass
class ProfileResult:
    name: str
    graph: Graph
    trace_t: np.ndarray  # (S,) int32 time step per transmission
    trace_src: np.ndarray  # (S,) int32 source neuron
    trace_dst: np.ndarray  # (S,) int32 destination neuron
    num_neurons: int
    num_steps: int
    fire_counts: np.ndarray  # (N,) firings per neuron over the window
    seconds: float

    @property
    def num_spikes(self) -> int:
        return int(self.trace_t.shape[0])

    @property
    def hyper(self) -> "Hypergraph | None":
        """Multicast hypergraph view of the profiled traffic."""
        return self.graph.hyper


def _expand_trace(
    raster: np.ndarray, xadj: np.ndarray, adjncy: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand a (T, N) raster into per-synapse transmission records."""
    fired_t, fired_i = np.nonzero(raster)
    out_deg = np.diff(xadj)
    counts = out_deg[fired_i]
    total = int(counts.sum())
    trace_t = np.repeat(fired_t, counts).astype(np.int32)
    trace_src = np.repeat(fired_i, counts).astype(np.int32)
    # Gather each firing neuron's adjacency slice without a Python loop.
    starts = xadj[fired_i]
    cum = np.concatenate([[0], np.cumsum(counts)])
    idx = np.arange(total) - np.repeat(cum[:-1], counts) + np.repeat(starts, counts)
    trace_dst = adjncy[idx].astype(np.int32)
    return trace_t, trace_src, trace_dst


def _synapse_csr(n: int, src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    xadj = np.zeros(n + 1, dtype=np.int64)
    np.add.at(xadj, src + 1, 1)
    return np.cumsum(xadj), dst.astype(np.int64)


def profile_drive(topo: SNNTopology, num_steps: int, seed: int) -> np.ndarray:
    """The (T, N) f32 external drive ``profile_snn`` feeds the network:
    Poisson events of ``input_amp`` on the input layer, from ``seed``."""
    rng = np.random.default_rng(seed)
    drive = np.zeros((num_steps, topo.num_neurons), dtype=np.float32)
    events = rng.random((num_steps, topo.input_size)) < topo.input_rate
    drive[:, : topo.input_size] = events * topo.input_amp
    return drive


def _cache_key(topo: SNNTopology, num_steps: int, seed: int,
               params: LIFParams) -> str:
    """Content hash of everything that shapes the profiled trace.

    The key covers the synapse lists and weights plus every trace-shaping
    scalar (``input_size``/``input_rate``/``input_amp``/``target_spikes``),
    not just the topology's name and size — rebuilding a same-name,
    same-size topology with different connectivity must *miss* the cache,
    never return another topology's stale profile.  "torch-seq" tags the
    port's cache layout, apart from the reference's files: both devices
    sum each neuron's current in the same (ascending source) order, so a
    raster from either serves both.
    """
    h = hashlib.sha1(
        f"{topo.name}/{num_steps}/{seed}/{params}/{topo.num_neurons}/"
        f"{topo.input_size}/{topo.input_rate}/{topo.input_amp}/"
        f"{topo.target_spikes}/torch-seq".encode()
    )
    h.update(np.ascontiguousarray(topo.syn_src, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(topo.syn_dst, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(topo.weights, dtype=np.float32).tobytes())
    return h.hexdigest()[:16]


def profile_snn(
    topo: SNNTopology,
    num_steps: int = 1200,
    seed: int = 0,
    params: LIFParams = LIFParams(),
    cache_dir: str | Path | None = None,
    device: "str | torch.device" = "cuda",
) -> ProfileResult:
    """Run the LIF simulation and extract graph + trace.

    The step loop runs on ``device`` (the card by default; raises where
    CUDA is absent unless ``device="cpu"``); the raster comes back to the
    host once, and the graph/trace extraction is host numpy.
    """
    dev = resolve_device(device)
    key = None
    if cache_dir is not None:
        h = _cache_key(topo, num_steps, seed, params)
        key = Path(cache_dir) / f"profile_torch_{topo.name}_{h}.npz"
        if key.exists():
            z = np.load(key, allow_pickle=False)
            graph = Graph(z["xadj"], z["adjncy"], z["adjwgt"], z["vwgt"])
            graph.hyper = Hypergraph(
                hxadj=z["hxadj"], hpins=z["hpins"], hwgt=z["hwgt"],
                hsrc=z["hsrc"], hfire=z["hfire"],
                num_vertices=int(z["num_neurons"]),
            )
            return ProfileResult(
                name=topo.name, graph=graph, trace_t=z["trace_t"],
                trace_src=z["trace_src"], trace_dst=z["trace_dst"],
                num_neurons=int(z["num_neurons"]), num_steps=int(z["num_steps"]),
                fire_counts=z["fire_counts"], seconds=float(z["seconds"]),
            )

    n = topo.num_neurons
    # The root span of the profile's steps; its seconds are the result's.
    with spans.phase("sneap.profile", neurons=n, steps=num_steps) as whole:
        src = topo.syn_src.astype(np.int64)
        dst = topo.syn_dst.astype(np.int64)
        with spans.span("sneap.profile.upload", synapses=int(src.shape[0])):
            drive = torch.from_numpy(profile_drive(topo, num_steps, seed))
            # The synapse list is built on the host and only it goes to the
            # card: the dense (N, N) matrix is never uploaded.
            weights = np.ascontiguousarray(topo.weights, dtype=np.float32)
            syn = synapses_from_dense(torch.from_numpy(weights))
            if dev.type == "cuda":
                drive = drive.pin_memory().to(dev, non_blocking=True)
                syn = syn.to(dev)
        # The step loop, up to the raster on the host: a wait.
        with spans.span("sneap.profile.lif", steps=num_steps):
            raster = lif_run_synapses(syn, drive, params)

        with spans.span("sneap.profile.extract") as s:
            xadj, adjncy = _synapse_csr(n, src, dst)
            trace_t, trace_src, trace_dst = _expand_trace(raster, xadj, adjncy)

            # Truncate at the step where cumulative transmissions reach
            # Table 1's count.
            if (topo.target_spikes is not None
                    and trace_t.shape[0] > topo.target_spikes):
                step_end = int(trace_t[topo.target_spikes - 1])
                keep = trace_t <= step_end
                trace_t, trace_src, trace_dst = (
                    trace_t[keep], trace_src[keep], trace_dst[keep])
                raster = raster[: step_end + 1]
                num_steps = step_end + 1

            fire_counts = raster.sum(axis=0).astype(np.int64)
            s.add(spikes=int(trace_t.shape[0]))

        with spans.span("sneap.profile.graph"):
            # Synapse graph: each directed synapse (i -> j) carried
            # fire_counts[i] spikes.
            graph = build_graph(n, src=src, dst=dst, weight=fire_counts[src])
            # Multicast view: one hyperedge per source with its destination
            # pin set.
            graph.hyper = build_hypergraph(n, src, dst, fire_counts)
        whole.add(spikes=int(trace_t.shape[0]))
    seconds = whole.seconds
    result = ProfileResult(
        name=topo.name, graph=graph, trace_t=trace_t, trace_src=trace_src,
        trace_dst=trace_dst, num_neurons=n, num_steps=num_steps,
        fire_counts=fire_counts, seconds=seconds,
    )
    if key is not None:
        key.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            key, xadj=graph.xadj, adjncy=graph.adjncy, adjwgt=graph.adjwgt,
            vwgt=graph.vwgt, trace_t=trace_t, trace_src=trace_src,
            trace_dst=trace_dst, num_neurons=n, num_steps=num_steps,
            fire_counts=fire_counts, seconds=seconds,
            hxadj=graph.hyper.hxadj, hpins=graph.hyper.hpins,
            hwgt=graph.hyper.hwgt, hsrc=graph.hyper.hsrc,
            hfire=graph.hyper.hfire,
        )
    return result
