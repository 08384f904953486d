"""The shared graph and trace builders of ``tests/conftest.py``, built with
the port's own types.

Each function draws the same numpy values from the same seed as its
namesake in ``conftest.py`` and hands them to `repro_torch.core.graph`
instead of the reference's builders, so a test that cannot import the
reference (the card's ``tests/test_torch_cuda_engines.py``) runs on the
same inputs as the reference's suites.  ``tests/test_torch_graph.py``
holds every builder here bitwise to its ``conftest.py`` namesake.  This
module imports numpy and the port only.
"""
import numpy as np

from repro_torch.core.graph import build_graph, build_hypergraph


def random_graph(n: int, p: float, seed: int = 0, max_w: int = 100):
    """Random undirected weighted graph (``conftest.random_graph``)."""
    r = np.random.default_rng(seed)
    mask = np.triu(r.random((n, n)) < p, k=1)
    src, dst = np.nonzero(mask)
    w = r.integers(1, max_w, src.shape[0])
    return build_graph(n, src, dst, w)


def random_snn_traffic(n: int, pins: int, seed: int = 0, max_fire: int = 20):
    """Directed synapses and fire counts (``conftest.random_snn_traffic``)."""
    r = np.random.default_rng(seed)
    src = r.integers(0, n, pins)
    dst = r.integers(0, n, pins)
    fire = r.integers(0, max_fire, n)
    return src, dst, fire


def random_hypergraph(n: int, pins: int, seed: int = 0, max_fire: int = 20):
    """Random SNN traffic with its hypergraph (``conftest.random_hypergraph``)."""
    src, dst, fire = random_snn_traffic(n, pins, seed, max_fire)
    g = build_graph(n, src, dst, fire[src])
    g.hyper = build_hypergraph(n, src, dst, fire)
    return g


def fanout_snn_graph(n: int, fan: int = 10, seed: int = 0, max_fire: int = 20):
    """Fan-out-heavy traffic with its hypergraph (``conftest.fanout_snn_graph``)."""
    r = np.random.default_rng(seed)
    src = np.repeat(np.arange(n), fan)
    dst = r.integers(0, n, n * fan)
    fire = r.integers(1, max_fire, n)
    g = build_graph(n, src, dst, fire[src])
    g.hyper = build_hypergraph(n, src, dst, fire)
    return g


def layered_snn_graph(widths, seed: int = 0, fire: int = 5):
    """Dense equal-weight layers with the hypergraph
    (``conftest.layered_snn_graph``)."""
    widths = list(widths)
    offs = np.cumsum([0] + widths)
    n = int(offs[-1])
    srcs, dsts = [], []
    for i in range(len(widths) - 1):
        a = np.arange(offs[i], offs[i + 1])
        b = np.arange(offs[i + 1], offs[i + 2])
        srcs.append(np.repeat(a, b.shape[0]))
        dsts.append(np.tile(b, a.shape[0]))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    fires = np.full(n, fire, dtype=np.int64)
    g = build_graph(n, src, dst, fires[src])
    g.hyper = build_hypergraph(n, src, dst, fires)
    return g


def random_spike_trace(seed=0, n_neurons=30, n_spikes=400, timesteps=20,
                       k=6, cores=9):
    """Spike trace, partition and placement (``conftest.random_spike_trace``)."""
    r = np.random.default_rng(seed)
    part = r.integers(0, k, n_neurons)
    placement = r.permutation(cores)[:k]
    t = np.sort(r.integers(0, timesteps, n_spikes))
    src = r.integers(0, n_neurons, n_spikes)
    dst = r.integers(0, n_neurons, n_spikes)
    return t, src, dst, part, placement
