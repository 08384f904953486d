"""XY dimension-order routing on a W x H 2D mesh — link indexing helpers.

Directed link id layout (total ``link_count(W, H)`` links):
  * East  (x,y)->(x+1,y): id =                        y*(W-1) + x
  * West  (x,y)->(x-1,y): id = (W-1)*H              + y*(W-1) + (x-1)
  * South (x,y)->(x,y+1): id = 2*(W-1)*H            + x*(H-1) + y
  * North (x,y)->(x,y-1): id = 2*(W-1)*H + W*(H-1)  + x*(H-1) + (y-1)

XY routing resolves X first, then Y — deadlock-free and static, which is
what makes the paper's analytic hop evaluation (and this module's fully
vectorized route expansion) possible.

The route expanders also accept a per-packet ``order`` flag selecting YX
(Y first, then X) instead: the fault-escape routes of the degradation
model (`repro.runtime.faults`) are dimension-ordered too, just along the
other axis, so every structural fact the engines rely on — static routes,
at most two consecutive link-id runs, minimal hop count — holds for both
orders and the same expansion code serves faulty and fault-free meshes.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "link_count",
    "route_hops",
    "next_link",
    "link_endpoints",
    "link_ids_for_routes",
    "multicast_tree_links",
    "multicast_tree_sizes",
    "routes_blocked",
    "span_to",
    "segment_extrema2",
]


def link_count(w: int, h: int) -> int:
    return 2 * (w - 1) * h + 2 * w * (h - 1)


def route_hops(src: np.ndarray, dst: np.ndarray, w: int) -> np.ndarray:
    sx, sy = src % w, src // w
    dx, dy = dst % w, dst // w
    return np.abs(sx - dx) + np.abs(sy - dy)


def next_link(
    cur: np.ndarray, dst: np.ndarray, w: int, h: int,
    yx: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized single dimension-ordered step: returns (next_core, link_id).

    Entries with cur == dst return (cur, -1).  ``yx`` flags packets that
    route Y-first (the fault-escape order); ``None`` keeps the pure XY
    behaviour bit-for-bit.
    """
    cx, cy = cur % w, cur // w
    dx, dy = dst % w, dst // w
    e_base = 0
    w_base = (w - 1) * h
    s_base = 2 * (w - 1) * h
    n_base = s_base + w * (h - 1)

    if yx is None:
        go_e = cx < dx
        go_w = cx > dx
        go_s = (cx == dx) & (cy < dy)
        go_n = (cx == dx) & (cy > dy)
    else:
        yx = np.asarray(yx, dtype=bool)
        h_turn = ~yx | (cy == dy)  # X moves: first leg of XY, last of YX
        v_turn = yx | (cx == dx)  # Y moves: first leg of YX, last of XY
        go_e = (cx < dx) & h_turn
        go_w = (cx > dx) & h_turn
        go_s = (cy < dy) & v_turn
        go_n = (cy > dy) & v_turn

    nxt = cur.copy()
    link = np.full(cur.shape, -1, dtype=np.int64)
    nxt = np.where(go_e, cur + 1, nxt)
    link = np.where(go_e, e_base + cy * (w - 1) + cx, link)
    nxt = np.where(go_w, cur - 1, nxt)
    link = np.where(go_w, w_base + cy * (w - 1) + (cx - 1), link)
    nxt = np.where(go_s, cur + w, nxt)
    link = np.where(go_s, s_base + cx * (h - 1) + cy, link)
    nxt = np.where(go_n, cur - w, nxt)
    link = np.where(go_n, n_base + cx * (h - 1) + (cy - 1), link)
    return nxt, link


def link_endpoints(ids: np.ndarray, w: int, h: int) -> tuple[np.ndarray, np.ndarray]:
    """Decode directed link ids into (tail, head) core ids (layout inverse).

    The tail is the router that drives the link, the head the router it
    enters — the orientation the tree-fork flit engine forks along.
    """
    ids = np.asarray(ids, dtype=np.int64)
    w_base = (w - 1) * h
    s_base = 2 * (w - 1) * h
    n_base = s_base + w * (h - 1)

    tail = np.empty(ids.shape, dtype=np.int64)
    head = np.empty(ids.shape, dtype=np.int64)

    m = ids < w_base  # East (x,y)->(x+1,y)
    y, x = ids[m] // (w - 1), ids[m] % (w - 1)
    tail[m], head[m] = y * w + x, y * w + x + 1

    m = (ids >= w_base) & (ids < s_base)  # West (x,y)->(x-1,y)
    r = ids[m] - w_base
    y, xm1 = r // (w - 1), r % (w - 1)
    tail[m], head[m] = y * w + xm1 + 1, y * w + xm1

    m = (ids >= s_base) & (ids < n_base)  # South (x,y)->(x,y+1)
    r = ids[m] - s_base
    x, y = r // (h - 1), r % (h - 1)
    tail[m], head[m] = y * w + x, (y + 1) * w + x

    m = ids >= n_base  # North (x,y)->(x,y-1)
    r = ids[m] - n_base
    x, ym1 = r // (h - 1), r % (h - 1)
    tail[m], head[m] = (ym1 + 1) * w + x, ym1 * w + x
    return tail, head


def link_ids_for_routes(
    src: np.ndarray, dst: np.ndarray, w: int, h: int, with_steps: bool = False,
    order: np.ndarray | None = None,
) -> tuple[np.ndarray, ...]:
    """Expand each (src, dst) pair's full XY route into directed link ids.

    Returns (link_ids, packet_index) — flat arrays, one entry per traversal.
    With ``with_steps=True`` also returns the 0-based hop index of each
    traversal along its packet's route (the cycle offset at which an
    unobstructed packet crosses that link), which is what the batched
    replay's contention screen schedules against.  Exploits the fact that
    a dimension-ordered route is at most two *consecutive* runs of link
    ids under the layout above.

    ``order`` flags packets routed YX instead of XY (the fault-escape
    order): the vertical run moves to the source column, the horizontal
    run to the destination row, and the step offsets compose Y-leg-first.
    ``None`` is the pure XY expansion, byte-identical to before.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    sx, sy = src % w, src // w
    dx, dy = dst % w, dst // w
    w_base = (w - 1) * h
    s_base = 2 * (w - 1) * h
    n_base = s_base + w * (h - 1)

    if order is None:
        h_row, v_col = sy, dx  # XY: horizontal on source row, vertical on dest column
        yx = None
    else:
        yx = np.asarray(order, dtype=bool)
        h_row = np.where(yx, dy, sy)
        v_col = np.where(yx, sx, dx)

    # Horizontal run (at row h_row).
    east = dx > sx
    west = dx < sx
    h_len = np.abs(dx - sx)
    h_start = np.where(
        east, h_row * (w - 1) + sx,  # E ids x = sx .. dx-1
        np.where(west, w_base + h_row * (w - 1) + dx, 0),  # W ids (x-1) = dx .. sx-1
    )
    # Vertical run (at column v_col).
    south = dy > sy
    north = dy < sy
    v_len = np.abs(dy - sy)
    v_start = np.where(
        south, s_base + v_col * (h - 1) + sy,  # S ids y = sy .. dy-1
        np.where(north, n_base + v_col * (h - 1) + dy, 0),  # N ids (y-1) = dy .. sy-1
    )

    def expand(starts, lens):
        total = int(lens.sum())
        if total == 0:
            e = np.empty(0, dtype=np.int64)
            return e, e, e
        pkt = np.repeat(np.arange(lens.shape[0]), lens)
        cum = np.concatenate([[0], np.cumsum(lens)])
        within = np.arange(total) - np.repeat(cum[:-1], lens)
        return np.repeat(starts, lens) + within, pkt, within

    h_ids, h_pkt, h_within = expand(h_start, h_len)
    v_ids, v_pkt, v_within = expand(v_start, v_len)
    ids = np.concatenate([h_ids, v_ids])
    pkt = np.concatenate([h_pkt, v_pkt])
    if not with_steps:
        return ids, pkt
    # Id runs ascend eastward/southward but a westbound (northbound) packet
    # crosses its run's ids in descending order — flip `within` there.
    # Under XY the vertical run follows the whole horizontal run; under YX
    # the horizontal run follows the whole vertical run.
    h_step = np.where(west[h_pkt], h_len[h_pkt] - 1 - h_within, h_within)
    v_step = np.where(north[v_pkt], v_len[v_pkt] - 1 - v_within, v_within)
    if yx is None:
        v_step = v_step + h_len[v_pkt]
    else:
        h_step = h_step + np.where(yx[h_pkt], v_len[h_pkt], 0)
        v_step = v_step + np.where(yx[v_pkt], 0, h_len[v_pkt])
    return ids, pkt, np.concatenate([h_step, v_step])


def multicast_tree_links(
    src: np.ndarray,
    dst: np.ndarray,
    group: np.ndarray,
    w: int,
    h: int,
    order: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Directed link ids traversed by each group's XY multicast tree.

    ``group`` labels packets that replicate from one firing (same source
    core): because XY routing is deterministic, the unicast routes of one
    group share their common prefix, and the union of the routes is the
    multicast tree — a branch link is traversed *once* per firing no
    matter how many destinations lie beyond it.  Returns (link_ids,
    group_ids), one entry per distinct (group, link) traversal.

    ``order`` routes flagged packets YX (fault escape).  A group must be
    order-pure (all XY or all YX) for the union to stay a tree entered at
    most once per node — the fault layer splits mixed firings into one
    subgroup per order before calling this.
    """
    ids, pkt = link_ids_for_routes(src, dst, w, h, order=order)
    nl = link_count(w, h)
    key = np.unique(group[pkt].astype(np.int64) * nl + ids)
    return key % nl, key // nl


def routes_blocked(
    src: np.ndarray,
    dst: np.ndarray,
    w: int,
    h: int,
    blocked: np.ndarray,
    order: np.ndarray | None = None,
) -> np.ndarray:
    """Per-packet flag: does the dimension-ordered route cross a blocked link?

    ``blocked`` is an (nl,) boolean mask of unusable links (dead links plus
    every link touching a dead core — see `FaultState.blocked_links`).
    Zero-hop routes (src == dst) are never blocked by links.
    """
    src = np.asarray(src, dtype=np.int64)
    out = np.zeros(src.shape[0], dtype=bool)
    ids, pkt = link_ids_for_routes(src, dst, w, h, order=order)
    hit = blocked[ids]
    if hit.any():
        out[pkt[hit]] = True
    return out


def multicast_tree_sizes(
    src: np.ndarray,
    dst: np.ndarray,
    group: np.ndarray,
    w: int,
    h: int,
    num_groups: int,
) -> np.ndarray:
    """Distinct-link count of each group's XY multicast tree, in closed form.

    ``sizes[g]`` is the number of directed links the tree of group ``g``
    traverses — the per-firing flit-hop count of the tree-fork replay, and
    the geometry the tree-hop placement objective
    (`repro.core.placecost.TreeHopObjective`) scores candidate placements
    with, so the mapper and the simulator share one accounting.  Group ids
    must lie in ``[0, num_groups)``; groups may repeat a source core but a
    group's entries must all share one source (as replicas of one firing
    do).

    Under XY routing every route of a group runs horizontally along the
    source's row, then vertically along its destination's column, so the
    union of the routes is: one horizontal segment on the source row
    spanning the leftmost/rightmost destination columns, plus one vertical
    segment per distinct destination column spanning that column's
    farthest destinations above/below the source row.  Summing those span
    lengths counts exactly ``len(multicast_tree_links(...))`` per group
    (pinned by the engine tests) without expanding any route.
    """
    group = np.asarray(group, dtype=np.int64)
    sizes = np.zeros(num_groups, dtype=np.int64)
    if group.shape[0] == 0:
        return sizes
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    dx = dst % w
    dv = dst // w - src // w  # signed vertical offset from the source row
    dh = dx - src % w  # signed horizontal offset from the source column
    # Both reductions are per-segment (min, max) of a signed offset, so
    # each rides on one plain sort of a shift-packed (segment, offset) key:
    # the first entry of a segment is its min, the last its max.  Segments
    # here average only a few entries, so sort + boundary picks beats
    # ufunc.reduceat's per-segment dispatch by ~10x; shift packing keeps
    # the unpack passes at mask/shift cost (int division is the slow part).
    return (
        sizes
        + _packed_span(group * w + dx, dv, h, num_groups, scale=w)  # vertical
        + _packed_span(group, dh, w, num_groups)  # horizontal, source row
    )


def span_to(origin, lo, hi):
    """Length of the directed-link segment from ``origin`` toward [lo, hi].

    ``max(hi - origin, 0) + max(origin - lo, 0)`` — the closed-form link
    count of one tree segment (a row span measured from the source column,
    or a column span measured from the source row), elementwise.  Computed
    as the identical ``max(hi, origin) - min(lo, origin)`` (equal whenever
    ``origin`` lies inside the dimension, whether or not the interval is
    empty) — one op fewer, and the empty-interval sentinels the aggregate
    tables use (``lo`` = dimension size, ``hi`` = -1) still make the span
    0 without masking.
    """
    return np.maximum(hi, origin) - np.minimum(lo, origin)


def segment_extrema2(
    seg: np.ndarray, val: np.ndarray, vmax: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Occupied-segment (ids, count, min1, min2, max1, max2) of ``val``.

    The top-2 reduction behind the tree-hop objective's incremental
    aggregates (`repro.core.placecost.TreeHopObjective`): knowing the two
    extreme members of every segment makes removing a *non-extreme* member
    free and removing the extreme an O(1) fallback to the runner-up, so a
    single-destination move re-prices a multicast-tree segment without
    rescanning it.  One packed sort (`_packed_span`'s idiom: segments
    contiguous, values ascending inside) yields all four extrema as
    boundary picks.  ``val`` must lie in [0, vmax).

    The reduction is *sparse*: only segments that have members are
    reported, in ascending segment-id order, and the caller scatters into
    (and sentinel-resets) its own tables — the segment space here is the
    (edge, mesh column) grid, mostly empty at large meshes, and never
    materializing the empty cells keeps a rebuild proportional to the
    members touched, not the mesh.  Singleton segments carry the
    ``vmax``/-1 runner-up sentinels `span_to` maps to span 0, so "no
    runner-up" needs no separate masking downstream.
    """
    seg = np.asarray(seg, dtype=np.int64)
    val = np.asarray(val, dtype=np.int64)
    if seg.shape[0] == 0:
        z = np.empty(0, dtype=np.int64)
        return z, z, z, z, z, z
    bits = int(max(vmax - 1, 1)).bit_length()
    key = (seg << bits) | val
    if ((int(seg.max()) + 1) << bits) < np.iinfo(np.int32).max:
        key = np.sort(key.astype(np.int32)).astype(np.int64)
    else:
        key = np.sort(key)
    kseg = key >> bits
    kval = key & ((1 << bits) - 1)
    m = key.shape[0]
    last = np.empty(m, dtype=bool)
    last[-1] = True
    np.not_equal(kseg[1:], kseg[:-1], out=last[:-1])
    first = np.empty(m, dtype=bool)
    first[0] = True
    first[1:] = last[:-1]
    fidx = np.flatnonzero(first)
    lidx = np.flatnonzero(last)
    useg = kseg[fidx]
    count = lidx - fidx + 1
    min1 = kval[fidx]
    max1 = kval[lidx]
    has2 = count > 1
    min2 = np.where(has2, kval[np.minimum(fidx + 1, m - 1)], vmax)
    max2 = np.where(has2, kval[np.maximum(lidx - 1, 0)], -1)
    return useg, count, min1, min2, max1, max2


def _packed_span(seg: np.ndarray, off: np.ndarray, radius: int,
                 num_groups: int, scale: int = 1) -> np.ndarray:
    """Per-group sum over segments of (max(off, 0) - min(off, 0)).

    ``off`` must lie in (-radius, radius); the group of segment ``s`` is
    ``s // scale``.  One sort of ``(seg << bits) | (off + radius)`` orders
    segments contiguously with offsets ascending inside, so each segment's
    min/max are its boundary entries.  Sorts in int32 when the packed key
    fits — ~2x faster for the sizes the mapping engine batches.
    """
    bits = int(2 * radius - 1).bit_length()
    key = (seg << bits) | (off + radius)
    top = (int(seg.max()) + 1) << bits
    if top < np.iinfo(np.int32).max:
        key = np.sort(key.astype(np.int32))
    else:
        key = np.sort(key)
    kseg = key >> bits
    m = key.shape[0]
    last = np.empty(m, dtype=bool)
    last[-1] = True
    np.not_equal(kseg[1:], kseg[:-1], out=last[:-1])
    first = np.empty(m, dtype=bool)
    first[0] = True
    first[1:] = last[:-1]
    mask = (1 << bits) - 1
    span = ((key[last] & mask) - radius).clip(min=0) \
        - ((key[first] & mask) - radius).clip(max=0)
    gid = kseg[last]
    if scale != 1:
        gid = gid // scale
    return np.bincount(gid, weights=span,
                       minlength=num_groups).astype(np.int64)
