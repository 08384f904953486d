"""The benchmark's SNN generator: a configuration's network and drive from a seed.

One general generator for every configuration under ``bench/configs``: the
layers and connection rules of the paper's Table 1 networks (local receptive
fields on 2-D grids, or random connections at a probability), each synapse's
weight ``gain / fan_in`` of its destination, and the Poisson drive of the
input layer.  The benchmark hands the port only what this module makes; the
plain reference (``bench/reference``) reads the same arrays.  Nothing here
imports the port.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["Network", "derive_seed", "build", "dense_weights", "drive"]


def derive_seed(seed: int, *tags: int) -> int:
    """A 32-bit child seed of the run's ``--seed`` for one use, named by tags."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1)[0])


@dataclass
class Network:
    name: str
    layers: list[int]
    syn_src: np.ndarray  # (E,) int32, global source neuron
    syn_dst: np.ndarray  # (E,) int32, global destination neuron
    syn_w: np.ndarray  # (E,) float32 weight
    input_rate: float
    input_amp: float
    target_spikes: int | None
    lif: dict

    @property
    def num_neurons(self) -> int:
        return int(sum(self.layers))

    @property
    def input_size(self) -> int:
        return int(self.layers[0])


def _grid(n: int) -> tuple[int, int]:
    """Near-square (h, w) with h * w == n."""
    h = int(math.sqrt(n))
    while n % h:
        h -= 1
    return h, n // h


def _local(n_src: int, n_dst: int, radius: int) -> tuple[np.ndarray, np.ndarray]:
    """Receptive fields: each source reaches the destinations within
    ``radius`` of its position scaled onto the destination grid."""
    hs, ws = _grid(n_src)
    hd, wd = _grid(n_dst)
    src_r, src_c = np.divmod(np.arange(n_src), ws)
    ctr_r, ctr_c = (src_r * hd) // hs, (src_c * wd) // ws
    srcs, dsts = [], []
    for dr in range(-radius, radius + 1):
        for dc in range(-radius, radius + 1):
            rr, cc = ctr_r + dr, ctr_c + dc
            ok = (rr >= 0) & (rr < hd) & (cc >= 0) & (cc < wd)
            srcs.append(np.nonzero(ok)[0])
            dsts.append(rr[ok] * wd + cc[ok])
    return np.concatenate(srcs), np.concatenate(dsts)


def _random(n_src: int, n_dst: int, p: float,
            rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    return np.nonzero(rng.random((n_src, n_dst)) < p)


def build(name: str, snn: dict, seed: int) -> Network:
    """The network of a configuration's ``snn`` block; random connections
    draw from ``seed``."""
    rng = np.random.default_rng(seed)
    layers = [int(n) for n in snn["layers"]]
    if len(snn["connections"]) != len(layers) - 1:
        raise ValueError(f"{name}: one connection rule per pair of layers")
    offsets = np.cumsum([0] + layers)
    n = offsets[-1]
    srcs, dsts = [], []
    for li, rule in enumerate(snn["connections"]):
        if rule["kind"] == "local":
            s, d = _local(layers[li], layers[li + 1], int(rule["radius"]))
        elif rule["kind"] == "random":
            s, d = _random(layers[li], layers[li + 1], float(rule["p"]), rng)
        else:
            raise ValueError(f"{name}: unknown connection kind {rule['kind']!r}")
        srcs.append(s.astype(np.int64) + offsets[li])
        dsts.append(d.astype(np.int64) + offsets[li + 1])
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    fan_in = np.bincount(dst, minlength=n).astype(np.float32)
    w = np.float32(snn["gain"]) / np.maximum(fan_in[dst], np.float32(1.0))
    return Network(name=name, layers=layers, syn_src=src.astype(np.int32),
                   syn_dst=dst.astype(np.int32), syn_w=w.astype(np.float32),
                   input_rate=float(snn["input_rate"]),
                   input_amp=float(snn["input_amp"]),
                   target_spikes=snn.get("target_spikes"), lif=dict(snn["lif"]))


def dense_weights(net: Network) -> np.ndarray:
    """The (N, N) float32 matrix, weights[i, j] = strength i -> j."""
    n = net.num_neurons
    w = np.zeros((n, n), dtype=np.float32)
    w[net.syn_src, net.syn_dst] = net.syn_w
    return w


def drive(net: Network, steps: int, seed: int) -> np.ndarray:
    """(steps, N) float32 external drive: Poisson events of ``input_amp`` on
    the input layer at ``input_rate``, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    out = np.zeros((steps, net.num_neurons), dtype=np.float32)
    events = rng.random((steps, net.input_size)) < net.input_rate
    out[:, : net.input_size] = events * np.float32(net.input_amp)
    return out
