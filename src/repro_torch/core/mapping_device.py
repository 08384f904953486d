"""Device-resident mapping searches: population SA, greedy polish, islands.

The counterpart of the reference's `repro.core.mapping_jax`, in torch on
the run's device:

  * `sa_search_jax` — a population of SA chains advanced in lock-step:
    each chain proposes a random swap, scores it with the O(K) incremental
    delta (`_delta_one`, batched over chains) and applies Metropolis
    acceptance.  A temperature epoch's proposals and uniforms are drawn in
    one call each from a `torch.Generator` on the device, so the step loop
    holds no RNG and no host sync; on the card each epoch's steps are
    captured once in a CUDA graph and replayed.  torch cannot reproduce
    ``jax.random``'s streams, so this search is held to the reference's
    quality bound, not to its placements.
  * `sa_search_jax_batch` — C configs' populations stacked into one
    ``(C, P, NC)`` state and advanced by the same graphed epochs (the
    sweep driver's device bucket).  `sa_search_jax` is a batch of one
    through the same code, each config draws from its own generator in
    the single call's order and shapes, and the deltas and costs are f64
    sums of integer products (exact below 2^53 on the toolchain's integer
    traffic, so independent of the reduction order the batch size picks):
    element i of a batch is bitwise ``sa_search_jax(seed=seeds[i])`` on the
    same device.
  * `greedy_polish` — full-neighbourhood steepest descent: the
    `kernels.swap_delta` op scores all O(K^2) swaps a step (the CUDA
    kernel on the card, the plain version on the CPU) and the single best
    swap is applied until none improves.  Deterministic: on traffic whose
    f32 sums are exact it gives the reference's placement and step count.
  * `polish_search` — the uniform-signature mapper over `greedy_polish`.
  * `island_sa` — the island model: ``n_dev`` independent populations
    (the reference's shard_map islands, one a device) as the config slots
    of one `_Population` over a shared traffic matrix, with a periodic
    exchange on the device that copies the global best chain into each
    island's worst; or, on a mesh of ranks, one island a rank with the
    exchange over ``all_gather``, bitwise the batched run.

The registry keys stay the reference's (``"sa_jax"``, ``"polish"``,
``"island"`` in `mapping.MAPPERS`), so one `ToolchainConfig` selects the
same search in both packages.  All of them minimize the paper's Eq. 2
pairwise objective and take no `placecost` objective.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import spans
from repro_torch.device import resolve_device
from repro_torch.kernels.swap_delta import swap_deltas

from .hopcost import hop_distance_matrix
from .mapping import MappingResult, pad_traffic

__all__ = ["sa_search_jax", "sa_search_jax_batch", "greedy_polish",
           "polish_search", "island_sa"]

ALPHA = 0.95  # geometric cooling a temperature epoch
ISLAND_SWEEPS = 64  # the island search's steps a temperature epoch


def _coords(num_cores: int, mesh_w: int,
            device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    ids = torch.arange(num_cores, device=device)
    return (ids % mesh_w).to(torch.float32), (ids // mesh_w).to(torch.float32)


def _cost(sym: torch.Tensor, placement: torch.Tensor,
          dist: torch.Tensor) -> torch.Tensor:
    """Total pairwise hop cost of ``placement`` (0-d, ``sym``'s dtype):
    sum(S * D) / 2."""
    d = dist[placement[:, None], placement[None, :]]
    return (sym * d).sum() / 2.0


def _chains(seed: int, chains: int, num_cores: int,
            device: torch.device) -> tuple[torch.Generator, torch.Tensor]:
    """A generator on ``device`` seeded with ``seed``, and its first draw:
    ``chains`` random permutations of the cores (chains, NC)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen, torch.rand((chains, num_cores), generator=gen,
                           device=device).argsort(dim=1)


def _delta_one(sym: torch.Tensor, dist: torch.Tensor, placement: torch.Tensor,
               a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """O(K) incremental swap deltas of chains ``placement`` (P, NC) for the
    swaps (a[p], b[p]); the formula of `hopcost.swap_delta`, batched."""
    ab = torch.stack([a, b], dim=1)[None]
    pl = placement[None]
    return _delta_pair(sym[None], dist, pl, ab, pl.gather(2, ab))[0]


def _delta_pair(syms, dist, placement, ab, cab) -> torch.Tensor:
    """`_delta_one` of C configs at once: the swaps ``ab`` (C, P, 2) of
    chains ``placement`` (C, P, NC) over traffic ``syms`` (C, NC, NC),
    whose cores are ``cab = placement[ab]``; both rows of each pair in
    one gather.  Returns (C, P) deltas."""
    d = dist[cab].gather(3, placement[:, :, None, :].expand(-1, -1, 2, -1))
    cfg = torch.arange(syms.shape[0], device=syms.device)[:, None, None]
    s = syms[cfg, ab]
    diff = (s[:, :, 0] - s[:, :, 1]) * (d[:, :, 1] - d[:, :, 0])
    return diff.sum(2) - diff.gather(2, ab).sum(2)


class _Population:
    """SA chains of C configs (C, P, NC) and their costs; one temperature
    epoch at a time over proposals and uniforms drawn into fixed buffers,
    each config's from its own generator."""

    def __init__(self, syms, dist, placements, t0s, sweeps_per_temp: int,
                 gens: list):
        self.syms, self.dist, self.gens = syms, dist, gens
        self.placement = placements
        c, p, nc = placements.shape
        dev = placements.device
        self.cost = torch.stack([
            torch.stack([_cost(syms[i], pl, dist) for pl in placements[i]])
            for i in range(c)])
        self.temp = torch.tensor([float(t) for t in t0s], dtype=torch.float32,
                                 device=dev)
        self.best = torch.empty((c, p), dtype=self.cost.dtype, device=dev)
        # Config-major draws: slot i is one contiguous (steps, P) block,
        # filled exactly as a single call's generator fills its buffer.
        self.a = torch.empty((c, sweeps_per_temp, p), dtype=torch.int64,
                             device=dev)
        self.b = torch.empty_like(self.a)
        self.ab = torch.empty((sweeps_per_temp, c, p, 2), dtype=torch.int64,
                              device=dev)
        self.neg_log_u = torch.empty((c, sweeps_per_temp, p),
                                     dtype=torch.float32, device=dev)
        self.nc = nc
        self.graph = None

    def draw(self) -> None:
        """The next epoch's proposals (a, b != a) and -log of its uniforms:
        ``u < exp(-delta / T)`` is ``delta < -log(u) * T``."""
        for i, gen in enumerate(self.gens):
            torch.randint(0, self.nc, self.a[i].shape, generator=gen,
                          out=self.a[i])
            torch.randint(0, self.nc - 1, self.b[i].shape, generator=gen,
                          out=self.b[i])
            torch.rand(self.neg_log_u[i].shape, generator=gen,
                       out=self.neg_log_u[i])
        self.b += self.b >= self.a
        torch.stack([self.a.transpose(0, 1), self.b.transpose(0, 1)], dim=3,
                    out=self.ab)
        self.neg_log_u.log_().neg_()

    def epoch(self) -> None:
        """sweeps_per_temp Metropolis steps of every chain, then cooling;
        ``best`` is the epoch's lowest cost of each chain."""
        self.best.fill_(float("inf"))
        thresholds = (self.neg_log_u * self.temp[:, None, None]).transpose(0, 1)
        for ab, threshold in zip(self.ab, thresholds):
            cab = self.placement.gather(2, ab)
            delta = _delta_pair(self.syms, self.dist, self.placement, ab, cab)
            accept = (delta <= 0) | (delta < threshold)
            self.placement.scatter_(
                2, ab, torch.where(accept[..., None], cab.flip(2), cab))
            self.cost += torch.where(accept, delta, 0.0)
            torch.minimum(self.best, self.cost, out=self.best)
        self.temp.mul_(ALPHA)

    def run_epoch(self) -> torch.Tensor:
        """Draw and run one epoch (replaying its CUDA graph on the card);
        returns a copy of the epoch's per-chain best costs (C, P)."""
        self.draw()
        if self.placement.device.type != "cuda":
            self.epoch()
            return self.best.clone()
        if self.graph is None:
            side = torch.cuda.Stream(self.placement.device)
            side.wait_stream(torch.cuda.current_stream())
            state = [t.clone() for t in (self.placement, self.cost, self.temp)]
            with torch.cuda.stream(side):
                self.epoch()  # warm-up outside the capture
            torch.cuda.current_stream().wait_stream(side)
            for t, saved in zip((self.placement, self.cost, self.temp), state):
                t.copy_(saved)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.epoch()
        self.graph.replay()
        return self.best.clone()


def sa_search_jax(
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    trace_length: int,
    seed: int = 0,
    iters: int = 20_000,
    chains: int = 16,
    sweeps_per_temp: int = 64,
    t0_frac: float = 0.25,
    torus: bool = False,
    polish: bool = True,
    device: "str | torch.device" = "cuda",
) -> MappingResult:
    """Population SA on ``device`` + optional greedy polish (registry:
    ``"sa_jax"``, the reference's name): `sa_search_jax_batch` of one."""
    return sa_search_jax_batch(
        [traffic], num_cores, mesh_w, [trace_length], [seed], iters=iters,
        chains=chains, sweeps_per_temp=sweeps_per_temp, t0_frac=t0_frac,
        torus=torus, polish=polish, device=device)[0]


def sa_search_jax_batch(
    traffics: list[np.ndarray],
    num_cores: int,
    mesh_w: int,
    trace_lengths: list[int],
    seeds: list[int],
    iters: int = 20_000,
    chains: int = 16,
    sweeps_per_temp: int = 64,
    t0_frac: float = 0.25,
    torus: bool = False,
    polish: bool = True,
    device: "str | torch.device" = "cuda",
) -> list[MappingResult]:
    """Batched `sa_search_jax`: one device program for a whole config bucket.

    All configs share ``(num_cores, mesh_w, iters, chains,
    sweeps_per_temp, torus)`` — what makes their populations stackable
    into one ``(C, P, NC)`` state (the sweep driver's bucketing key).
    Traffic matrices may have different ``k`` (each is zero-padded to
    ``num_cores``).  Each config's generator, initial placements and
    temperature schedule are those of ``sa_search_jax(seed=s)``, and each
    epoch's steps for the whole bucket are one CUDA graph on the card, so
    element ``i`` of the returned list is bitwise the single call's
    result on the same device; the polish tail runs per config on
    `swap_deltas`.  Reported ``seconds`` are the bucket's wall clock
    amortized per config.
    """
    dev = resolve_device(device)
    start = time.perf_counter()
    c = len(traffics)
    if not (len(trace_lengths) == len(seeds) == c):
        raise ValueError("traffics, trace_lengths, seeds must align")
    if c == 0:
        return []
    ks = [int(t.shape[0]) for t in traffics]
    epochs = max(iters // sweeps_per_temp, 1)
    with spans.span("sneap.sa", configs=c, k=max(ks), chains=chains,
                    epochs=epochs) as sa:
        with spans.span("sneap.sa.setup"):
            syms_np = np.empty((c, num_cores, num_cores), dtype=np.float64)
            for i, t in enumerate(traffics):
                padded = pad_traffic(np.asarray(t, dtype=np.float64),
                                     num_cores)
                syms_np[i] = padded + padded.T
            # The chains score in f64 (exact on integer traffic); the
            # polish's swap_deltas takes the f32 copy.
            syms = torch.tensor(syms_np, dtype=torch.float64, device=dev)
            dist = torch.tensor(hop_distance_matrix(num_cores, mesh_w,
                                                    torus=torus),
                                dtype=torch.float64, device=dev)
            gens, placements, t0s = [], [], []
            for i, s in enumerate(seeds):
                gen, pl = _chains(s, chains, num_cores, dev)
                gens.append(gen)
                placements.append(pl)
                cost0 = _cost(syms[i], pl[0], dist)
                with spans.span("sneap.sa.wait"):
                    t0s.append(t0_frac * float(cost0) / max(ks[i], 1))
            pop = _Population(syms, dist, torch.stack(placements), t0s,
                              sweeps_per_temp, gens)
        epoch_best = []
        for _ in range(epochs):
            with spans.span("sneap.sa.epoch") as ep:
                fresh = pop.graph is None
                epoch_best.append(pop.run_epoch())
                if fresh and pop.graph is not None:
                    ep.add(captured=1)
                    sa.add(captures=1)
        with spans.span("sneap.sa.wait"):
            best_hist = torch.stack(epoch_best).min(dim=2).values
            best_hist = best_hist.cpu().numpy()  # (epochs, C)
        if polish:
            x, y = _coords(num_cores, mesh_w, dev)
            syms32 = syms.to(torch.float32)
        results = []
        for i in range(c):
            with spans.span("sneap.sa.wait"):
                best = pop.placement[i, int(torch.argmin(pop.cost[i]))].clone()
            if polish:
                best, _ = greedy_polish(syms32[i], best, x, y)
            denom = max(int(trace_lengths[i]), 1)  # zero traffic: 1
            with spans.span("sneap.sa.wait"):
                final_cost = float(_cost(syms[i], best, dist))
                placement = best[:ks[i]].cpu().numpy().astype(np.int64)
            # The steps run on the device, so history is keyed by
            # temperature-epoch index (see MappingResult.history), as in
            # the reference.
            best_by_epoch = np.minimum.accumulate(best_hist[:, i])
            hist = [(float(j), cst / denom)
                    for j, cst in enumerate(best_by_epoch)]
            results.append(MappingResult(
                placement=placement,
                avg_hop=final_cost / denom,
                seconds=0.0,
                history=hist,
                evaluations=int(iters) * int(chains),
            ))
    seconds = (time.perf_counter() - start) / c
    for r in results:
        r.seconds = seconds
    return results


def greedy_polish(
    sym: torch.Tensor,
    placement: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    max_steps: int = 256,
) -> tuple[torch.Tensor, int]:
    """Steepest descent over the full swap neighbourhood.

    Each step scores all O(K^2) swaps in one `swap_deltas` call on the
    tensors' device, masks the diagonal, and applies the first-index
    minimum when it improves by more than 1e-6; ``steps`` counts every
    step run, the last non-improving one included.  ``sym`` must be the
    symmetric padded traffic C + C^T.  Returns a new placement.
    """
    with spans.span("sneap.polish", cores=int(placement.shape[0])) as sp:
        placement = placement.clone()
        nc = placement.shape[0]
        eye = torch.eye(nc, dtype=torch.bool, device=placement.device)
        steps = 0
        improved = True
        while improved and steps < max_steps:
            deltas = swap_deltas(sym, x[placement], y[placement])
            deltas.masked_fill_(eye, float("inf"))
            best, flat = torch.min(deltas.view(-1), 0)
            pair = torch.stack([best.double(), flat.double()])
            with spans.span("sneap.polish.wait"):
                best, flat = pair.tolist()
            improved = best < -1e-6
            if improved:
                a, b = divmod(int(flat), nc)
                placement[[a, b]] = placement[[b, a]]
            steps += 1
        sp.add(steps=steps)
    return placement, steps


def polish_search(
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    trace_length: int,
    seed: int = 0,
    init: np.ndarray | None = None,
    max_steps: int = 256,
    torus: bool = False,
    device: "str | torch.device" = "cuda",
) -> MappingResult:
    """Uniform-signature mapper over `greedy_polish` (registry: "polish").

    Starts from ``init`` (or a seeded random permutation) and runs
    full-neighbourhood steepest descent to a swap-local optimum.  The
    swap deltas rebuild plain Manhattan distances from coordinates, so
    torus meshes are not supported.
    """
    if torus:
        raise ValueError("polish_search is mesh-only (kernel distance is Manhattan)")
    dev = resolve_device(device)
    start = time.perf_counter()
    k = traffic.shape[0]
    trace_length = max(trace_length, 1)  # zero-traffic profiles normalize by 1
    padded = pad_traffic(np.asarray(traffic, dtype=np.float64), num_cores)
    sym = torch.tensor(padded + padded.T, dtype=torch.float32, device=dev)
    dist = torch.tensor(hop_distance_matrix(num_cores, mesh_w),
                        dtype=torch.float32, device=dev)
    placement = (np.asarray(init, dtype=np.int64).copy() if init is not None
                 else np.random.default_rng(seed).permutation(num_cores))
    x, y = _coords(num_cores, mesh_w, dev)
    best, steps = greedy_polish(sym, torch.tensor(placement, device=dev), x, y,
                                max_steps=max_steps)
    final_cost = float(_cost(sym, best, dist))
    seconds = time.perf_counter() - start
    # One swap_deltas call scores the whole O(K^2) neighbourhood a step.
    return MappingResult(
        placement=best[:k].cpu().numpy().astype(np.int64),
        avg_hop=final_cost / trace_length,
        seconds=seconds,
        history=[(float(steps), final_cost / trace_length)],
        evaluations=int(steps) * num_cores * num_cores,
    )


def _exchange(placement: torch.Tensor, cost: torch.Tensor,
              gather=None) -> None:
    """The islands' exchange, in place and on the device (no host sync):
    the lowest-cost chain of all islands' (first index on ties) is copied,
    with its cost, into each island's highest-cost chain.  ``placement``
    is (I, P, NC), ``cost`` (I, P): this process's islands.  ``gather``
    (islands on ranks) turns them into every island's, rank-major."""
    islands, _, nc = placement.shape
    all_place, all_cost = ((placement, cost) if gather is None
                           else (gather(placement), gather(cost)))
    flat = all_cost.reshape(-1).argmin().view(1)
    best_place = all_place.reshape(-1, nc).index_select(0, flat)
    best_cost = all_cost.reshape(-1).index_select(0, flat)
    rows = torch.arange(islands, device=cost.device)
    worst = cost.argmax(dim=1)
    placement[rows, worst] = best_place.expand(islands, nc)
    cost[rows, worst] = best_cost.expand(islands)


def island_sa(
    traffic: np.ndarray,
    num_cores: int,
    mesh_w: int,
    trace_length: int,
    n_dev: int = 4,
    seed: int = 0,
    rounds: int = 4,
    iters_per_round: int = 4_000,
    chains_per_device: int = 4,
    torus: bool = False,
    device: "str | torch.device" = "cuda",
    mesh=None,
    axis: str = "data",
) -> MappingResult:
    """Island-model SA (registry: ``"island"``): ``n_dev`` independent
    populations of ``chains_per_device`` chains, with a periodic exchange
    of the global best into each island's worst chain.

    Without ``mesh``, ``n_dev`` is the island count, the reference's
    ``n_dev = mesh.shape[axis]`` (one island a device of a jax mesh axis),
    and the islands are the config slots of one `_Population` on
    ``device``, over one traffic matrix expanded (not copied) to (n_dev,
    NC, NC), so each temperature epoch of all islands is one CUDA graph on
    the card.  With a mesh of ranks (`repro_torch.launch.mesh.
    make_rank_mesh`), as the reference runs it, ``n_dev =
    mesh.shape[axis]`` and the rank at index ``r`` of ``axis`` runs island
    ``r`` on its device (``device`` is not read); the exchange and the
    final choice ``all_gather`` every island's costs and chains over
    ``axis``, rank-major, so every rank returns the result of the batched
    run, bit for bit (the costs are f64 sums of integer products, exact in
    any order).
    Island ``i`` draws its initial chains and every proposal from its own
    `torch.Generator` on ``device``, seeded with the i-th child of
    ``np.random.SeedSequence(seed).spawn(n_dev)`` (its first 32-bit
    state word), so a seed repeats its result on the same device.

    Each of ``rounds`` rounds runs ``iters_per_round // 64`` epochs of 64
    steps, cooling by 0.95 an epoch from ``t0 = 0.25 * cost(first chain)
    / k``, the temperature continuing across rounds; then `_exchange`.
    The best chain of all islands, by a recount of each chain's cost, is
    the result.  torch cannot reproduce ``jax.random``'s streams, so this
    search is held to the reference test's quality bound, not to its
    placements.
    """
    if mesh is None:
        dev, islands, gather = resolve_device(device), range(n_dev), None
    else:
        n_dev, dev = mesh.shape[axis], mesh.device
        islands = [mesh.coord[axis]]

        def gather(local):  # this rank's (1, ...) -> every island's (n_dev, ...)
            return mesh.all_gather(local[0], axis)
    start = time.perf_counter()
    k = traffic.shape[0]
    trace_length = max(trace_length, 1)  # zero-traffic profiles normalize by 1
    padded = pad_traffic(np.asarray(traffic, dtype=np.float64), num_cores)
    sym = torch.tensor(padded + padded.T, dtype=torch.float64, device=dev)
    dist = torch.tensor(hop_distance_matrix(num_cores, mesh_w, torus=torus),
                        dtype=torch.float64, device=dev)
    children = np.random.SeedSequence(seed).spawn(n_dev)
    gens, placements = [], []
    for i in islands:
        gen, pl = _chains(int(children[i].generate_state(1)[0]),
                          chains_per_device, num_cores, dev)
        gens.append(gen)
        placements.append(pl)
    placements = torch.stack(placements)
    first = placements if gather is None else gather(placements)
    t0 = 0.25 * float(_cost(sym, first[0, 0], dist)) / max(k, 1)
    pop = _Population(sym.expand(len(islands), num_cores, num_cores), dist,
                      placements, [t0] * len(islands), ISLAND_SWEEPS, gens)
    epochs = iters_per_round // ISLAND_SWEEPS
    for r in range(rounds):
        pop.temp.fill_(t0 * ALPHA ** (r * epochs))
        for _ in range(max(epochs, 1)):
            pop.run_epoch()
        _exchange(pop.placement, pop.cost, gather)
    chains = (pop.placement if gather is None
              else gather(pop.placement)).reshape(-1, num_cores)
    costs = torch.stack([_cost(sym, pl, dist) for pl in chains])
    best = chains[int(torch.argmin(costs))]
    final_cost = float(_cost(sym, best, dist))
    seconds = time.perf_counter() - start
    return MappingResult(
        placement=best[:k].cpu().numpy().astype(np.int64),
        avg_hop=final_cost / trace_length,
        seconds=seconds,
        history=[(seconds, final_cost / trace_length)],
        evaluations=rounds * iters_per_round * n_dev * chains_per_device,
    )
