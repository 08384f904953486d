"""Device path for the joint congested-window stepper (``stepper="jax"``).

The counterpart of the reference's `repro.nocsim.replay_jax`
(``joint_stepper_jax``): the same cycle loop over the packets of every
congested window at once, in torch ops on the run's device instead of a
``lax.while_loop``.  The knob keeps the reference's name so that one
``noc_kwargs={"stepper": "jax"}`` selects the same stepper in both
packages.

Grant decisions mirror the numpy stepper (`replay._joint_stepper`)
exactly — per window-tagged link, the ``link_capacity`` oldest-injected
active packets win, stable by record order — so latencies and the
blocked-packet count are bitwise the numpy stepper's.  How the loop keeps
that rule on the card:

  * Packets are sorted once by (inject, record index), the static
    arbitration priority, so the per-cycle ``lexsort((idx, inject, tag))``
    of the reference becomes one stable sort of the tag.  A packet's rank
    in its tag's group is its sorted slot minus the group's first slot
    (``searchsorted`` of the sorted tags into themselves).
  * A packet's XY route is fixed, so its requested link at hop ``k`` is
    affine in ``k`` on each leg: ``ta + hs * k`` on the horizontal leg,
    ``tb + vs * k`` on the vertical one, with the window offset folded into
    ``ta``/``tb`` (int32 tags where the window x link space fits, int64
    otherwise; no 32-bit refusal).
  * No padding.  The host reads the state every ``CHECK_EVERY`` cycles:
    arrived packets, which never take part in a grant, are compacted away,
    and the loop stops once every packet has arrived (a cycle after the
    drain changes nothing).  The last chunk is clamped to
    ``max_cycles``, so a window that has not drained by then raises the
    reference's RuntimeError.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import spans
from repro_torch.device import resolve_device

__all__ = ["joint_stepper_device", "CHECK_EVERY"]

# Cycles between two reads of the state by the host (drain check and
# compaction of arrived packets).
CHECK_EVERY = 32


def _routes(src, dst, win, w: int, h: int, nl: int, tag_dtype):
    """Per-packet route parameters: (ta, hs, nh, tb, vs, hops).

    The link requested at hop k is ``ta + hs * k`` while ``k < nh`` (the
    horizontal leg) and ``tb + vs * k`` after it, both already offset by
    the packet's window (``win * nl``), in the ``xy`` link layout (east,
    west, south, north blocks)."""
    w_base = (w - 1) * h
    s_base = 2 * (w - 1) * h
    n_base = s_base + w * (h - 1)
    cx, cy = src % w, src // w
    dx, dy = dst % w, dst // w
    hs = torch.sign(dx - cx)
    vs = torch.sign(dy - cy)
    nh = (dx - cx).abs()
    hops = nh + (dy - cy).abs()
    # East link cx -> cx+1 of row cy is cy*(w-1) + cx; west cx -> cx-1 is
    # w_base + cy*(w-1) + cx-1; south cy -> cy+1 of column dx is
    # s_base + dx*(h-1) + cy; north cy -> cy-1 is n_base + dx*(h-1) + cy-1.
    a = cy * (w - 1) + cx + torch.where(hs > 0, 0, w_base - 1)
    b = (dx * (h - 1) + cy + torch.where(vs > 0, s_base, n_base - 1)
         - vs * nh)
    base = win.to(tag_dtype) * nl
    return ((base + a).to(tag_dtype), hs.to(tag_dtype), nh,
            (base + b).to(tag_dtype), vs.to(tag_dtype), hops)


def _upload(dev: torch.device, *arrays: np.ndarray) -> torch.Tensor:
    """The arrays as rows of one integer buffer on ``dev``, in one copy
    (pinned on the card)."""
    top = max((int(a.max()) for a in arrays if a.shape[0]), default=0)
    dtype = torch.int32 if top < 2 ** 31 else torch.int64
    buf = torch.empty((len(arrays), arrays[0].shape[0]), dtype=dtype,
                      pin_memory=dev.type == "cuda")
    host = buf.numpy()
    for row, a in zip(host, arrays):
        row[:] = a
    return buf.to(dev, non_blocking=True)


def joint_stepper_device(
    src: np.ndarray,
    dst: np.ndarray,
    inject: np.ndarray,
    win: np.ndarray,
    w: int,
    h: int,
    nl: int,
    link_capacity: int,
    max_cycles: int,
    device: "torch.device | str" = "cuda",
) -> tuple[np.ndarray, int]:
    """Step the congested windows' packets on ``device``; returns
    (latencies, blocked count) as `replay._joint_stepper` does.

    ``src``/``dst`` are the packets' cores, ``inject`` their injection
    cycles and ``win`` their compact (0..c-1) window ids.
    """
    dev = resolve_device(device)
    n = int(src.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int64), 0
    n_cwin = int(win.max()) + 1
    sentinel = (torch.iinfo(torch.int32).max if n_cwin * nl < 2 ** 31 - 1
                else torch.iinfo(torch.int64).max)
    tag_dtype = torch.int32 if sentinel < 2 ** 31 else torch.int64
    buf = _upload(dev, src, dst, inject, win)
    # Static priority: ascending inject, stable by record order.
    inj, ids = torch.sort(buf[2], stable=True)
    src_t, dst_t, win_t = buf[0][ids], buf[1][ids], buf[3][ids]
    ta, hs, nh, tb, vs, hops = _routes(src_t, dst_t, win_t, w, h, nl, tag_dtype)
    k = torch.zeros_like(hops)
    lat = torch.zeros(n, dtype=torch.int64, device=dev)
    out = torch.zeros(n, dtype=torch.int64, device=dev)
    congestion = torch.zeros((), dtype=torch.int64, device=dev)
    pos = torch.arange(n, device=dev)
    state = [inj, ids, ta, hs, nh, tb, vs, hops, k, lat, pos]
    cycle = reads = 0
    while True:
        inj, ids, ta, hs, nh, tb, vs, hops, k, lat, pos = state
        for _ in range(min(CHECK_EVERY, max_cycles - cycle)):
            active = (inj <= cycle) & (k < hops)
            tag = torch.where(k < nh, ta + hs * k, tb + vs * k)
            tag = torch.where(active, tag, sentinel)
            st, order = torch.sort(tag, stable=True)
            start = torch.searchsorted(st, st)  # first slot of each tag
            go_sorted = ((pos - start) < link_capacity) & (st != sentinel)
            go = torch.empty_like(go_sorted)
            go[order] = go_sorted
            congestion += active.sum() - go_sorted.sum()
            k += go
            lat.masked_fill_(go & (k == hops), cycle + 1)
            cycle += 1
        alive = k < hops
        with spans.span("sneap.replay.stepper.wait"):
            remaining = int(alive.sum())
        reads += 1
        done = ~alive
        out[ids[done]] = lat[done]
        if remaining == 0:
            break
        if cycle >= max_cycles:
            raise RuntimeError("NoC window failed to drain — capacity too low?")
        if remaining < pos.shape[0]:
            state = [t[alive] for t in state[:-1]] + [pos[:remaining]]
    with spans.span("sneap.replay.stepper.wait"):
        out_host, blocked = out.cpu().numpy(), int(congestion)
    spans.add(reads=reads + 2, loop_cycles=cycle)
    return out_host, blocked
