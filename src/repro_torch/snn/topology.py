"""Builders for the paper's five evaluated SNNs (Table 1).

| SNN         | topology              | paper spikes |
|-------------|-----------------------|--------------|
| Smooth_320  | feedforward, 2 layer  | 175,124      |
| Smooth_1280 | feedforward, 2 layer  | 981,808      |
| MLP_2048    | feedforward, 2 layer  | 15,905,792   |
| Edge_5120   | feedforward, 3 layer  | 4,570,546    |
| Random_6212 | feedforward, 3 layer  | 51,756,245   |

"Smooth"/"Edge" follow the CARLsim image-processing tutorials (local
receptive fields on 2D grids); MLP is fully connected; "Random" uses random
inter-layer connectivity.  Spike counts are matched to Table 1 by
truncating the profiled trace at the step where the cumulative transmission
count reaches the paper's number (see `simulate.profile_snn`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["SNNTopology", "make_snn", "PAPER_SNNS"]


@dataclass
class SNNTopology:
    name: str
    layer_sizes: list[int]
    syn_src: np.ndarray  # (E,) int32 directed synapse sources
    syn_dst: np.ndarray  # (E,) int32 directed synapse destinations
    weights: np.ndarray  # (N, N) float32 dense synaptic matrix
    input_size: int
    input_rate: float  # Bernoulli firing probability of the stimulus
    input_amp: float
    target_spikes: int | None = None
    meta: dict = field(default_factory=dict)

    @property
    def num_neurons(self) -> int:
        return int(sum(self.layer_sizes))


def _grid(n: int) -> tuple[int, int]:
    """Near-square (h, w) with h*w >= n."""
    h = int(math.sqrt(n))
    while n % h:
        h -= 1
    return h, n // h


def _local_edges(n_src: int, n_dst: int, radius: int) -> tuple[np.ndarray, np.ndarray]:
    """Receptive-field connectivity between two 2D-gridded layers."""
    hs, ws = _grid(n_src)
    hd, wd = _grid(n_dst)
    src_r, src_c = np.divmod(np.arange(n_src), ws)
    # Scale source coords into the destination grid.
    ctr_r = (src_r * hd) // hs
    ctr_c = (src_c * wd) // ws
    offs = [(dr, dc) for dr in range(-radius, radius + 1) for dc in range(-radius, radius + 1)]
    srcs, dsts = [], []
    for dr, dc in offs:
        rr, cc = ctr_r + dr, ctr_c + dc
        ok = (rr >= 0) & (rr < hd) & (cc >= 0) & (cc < wd)
        srcs.append(np.nonzero(ok)[0])
        dsts.append(rr[ok] * wd + cc[ok])
    return np.concatenate(srcs).astype(np.int64), np.concatenate(dsts).astype(np.int64)


def _full_edges(n_src: int, n_dst: int) -> tuple[np.ndarray, np.ndarray]:
    s = np.repeat(np.arange(n_src), n_dst)
    d = np.tile(np.arange(n_dst), n_src)
    return s, d


def _random_edges(
    n_src: int, n_dst: int, p: float, rng: np.random.Generator
) -> tuple[np.ndarray, np.ndarray]:
    mask = rng.random((n_src, n_dst)) < p
    s, d = np.nonzero(mask)
    return s.astype(np.int64), d.astype(np.int64)


def _assemble(
    name: str,
    layer_sizes: list[int],
    layer_edges: list[tuple[np.ndarray, np.ndarray]],
    gain: float,
    input_rate: float,
    target_spikes: int | None,
) -> SNNTopology:
    n = sum(layer_sizes)
    offsets = np.cumsum([0] + layer_sizes)
    w = np.zeros((n, n), dtype=np.float32)
    all_src, all_dst = [], []
    for li, (s, d) in enumerate(layer_edges):
        gs = s + offsets[li]
        gd = d + offsets[li + 1]
        all_src.append(gs)
        all_dst.append(gd)
        # Normalize by fan-in so a fraction ~1/gain of presynaptic activity fires a neuron.
        fan_in = np.bincount(gd, minlength=n).astype(np.float32)
        w[gs, gd] = gain / np.maximum(fan_in[gd], 1.0)
    return SNNTopology(
        name=name,
        layer_sizes=layer_sizes,
        syn_src=np.concatenate(all_src).astype(np.int32),
        syn_dst=np.concatenate(all_dst).astype(np.int32),
        weights=w,
        input_size=layer_sizes[0],
        input_rate=input_rate,
        input_amp=1.5,  # suprathreshold: an input event fires the input neuron
        target_spikes=target_spikes,
        meta={"layers": layer_sizes},
    )


def make_snn(name: str, seed: int = 0) -> SNNTopology:
    rng = np.random.default_rng(seed)
    if name == "smooth_320":
        sizes = [160, 160]
        edges = [_local_edges(160, 160, radius=1)]
        return _assemble(name, sizes, edges, gain=2.0, input_rate=0.14, target_spikes=175_124)
    if name == "smooth_1280":
        sizes = [640, 640]
        edges = [_local_edges(640, 640, radius=1)]
        return _assemble(name, sizes, edges, gain=2.0, input_rate=0.18, target_spikes=981_808)
    if name == "mlp_2048":
        sizes = [1024, 1024]
        edges = [_full_edges(1024, 1024)]
        return _assemble(name, sizes, edges, gain=2.0, input_rate=0.06, target_spikes=15_905_792)
    if name == "edge_5120":
        sizes = [2048, 2048, 1024]
        edges = [_local_edges(2048, 2048, radius=2), _local_edges(2048, 1024, radius=2)]
        return _assemble(name, sizes, edges, gain=2.5, input_rate=0.10, target_spikes=4_570_546)
    if name == "random_6212":
        sizes = [2071, 2070, 2071]
        edges = [
            _random_edges(2071, 2070, p=0.10, rng=rng),
            _random_edges(2070, 2071, p=0.10, rng=rng),
        ]
        return _assemble(name, sizes, edges, gain=2.5, input_rate=0.12, target_spikes=51_756_245)
    raise KeyError(f"unknown SNN {name!r}; have {PAPER_SNNS}")


PAPER_SNNS = ["smooth_320", "smooth_1280", "mlp_2048", "edge_5120", "random_6212"]
