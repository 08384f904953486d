"""Mamba-2 (SSD, state-space duality) block: chunked scan + O(1) decode.

Chunked SSD (arXiv:2405.21060 §6): the sequence is split into chunks of Q
tokens; within a chunk the contribution is a small attention-like quadratic
form, across chunks a loop carries the (H, N, P) state.  Decode keeps a
constant-size state — this is why the ssm and hybrid architectures are the
ones that run the long_500k shape.

Layout: x (B, S, H, P) head-split inner activations, B/C (B, S, N) with a
single B/C group, dt (B, S, H), A (H,) negative reals.  ``p`` is the
mixer module holding ``in_proj``, ``conv_w``, ``dt_bias``, ``a_log``,
``d_skip``, ``norm`` and ``out_proj``.

A rank of a mesh of ranks (``mesh``) may hold the planner's blocks:
``in_proj``'s columns, ``out_proj``'s rows (a block of ``d_inner``), and
in its decode cache a block of the state's heads and of the conv tail's
channels; ``conv_w``, ``dt_bias``, ``a_log``, ``d_skip`` and ``norm``
are whole (`_Rank`).  ``in_proj``'s columns pack ``[gate | xs | B | C |
dt]``, so a contiguous block of them is no piece of the mixer: the rank's
product is ``all_gather``ed over ``model`` into the whole projection.
The causal conv runs whole (a decode over a block of the conv tail runs
the block's channels and ``all_gather``s them).  Where ``out_proj``'s row
block covers whole heads (``H`` divides the model axis: mamba2-780m), the
rank runs the scan for those heads only, with the state block, and the
gated RMSNorm over all of ``d_inner`` sums its squares over ``model``
(f32 ``all_reduce``); where it cuts a head (Hymba: 25 heads), the rank
runs every head and keeps its rows' channels.  Either way ``out_proj``'s
product is summed over ``model`` (`layers.row_parallel`).  For training,
where a rank runs its own heads, the whole projection and the whole
weights it reads for its heads pass `Mesh.copy_to`; where it runs every
head, the normed output does before the rank keeps its channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm, row_parallel

__all__ = ["ssd_scan", "ssd_decode_step", "mamba_block", "mamba_decode",
           "init_mamba_cache"]


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums: out[..., i, j] = sum_{j<k<=i} dA[k].

    dA: (..., Q); returns (..., Q, Q) with -inf above the diagonal.
    """
    q = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)
    # out[i, j] = cum[i] - cum[j] (sum over k in (j, i]); mask j > i.
    out = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, out, -torch.inf)


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    a: torch.Tensor,  # (H,) negative
    b_in: torch.Tensor,  # (B, S, N)
    c_in: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: torch.Tensor | None = None,  # (B, H, N, P)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,N,P)). fp32 internals."""
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    s_orig = s
    if s % chunk:
        # Trailing pad: dt=0 => decay 1 and zero state contribution, so
        # causal outputs for the real positions are unaffected.
        pad = chunk - s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
        s += pad
    nc = s // chunk

    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b_in.float().reshape(bsz, nc, chunk, n)
    cf = c_in.float().reshape(bsz, nc, chunk, n)
    dA = dtf * a  # (B,nc,Q,H)

    # Intra-chunk (diagonal) term: attention-like with decay kernel L.
    seg = _segsum(dA.permute(0, 1, 3, 2))  # (B,nc,H,Q,Q)
    ldecay = torch.exp(seg)
    scores = torch.einsum("bcin,bcjn->bcij", cf, bf)  # (B,nc,Q,Q)
    xdt = xf * dtf[..., None]  # (B,nc,Q,H,P)
    y_diag = torch.einsum("bcij,bchij,bcjhp->bcihp", scores, ldecay, xdt)

    # Per-chunk end states: sum_j B_j decay(end, j) xdt_j.
    cum = torch.cumsum(dA, dim=2)  # (B,nc,Q,H)
    total = cum[:, :, -1:, :]  # (B,nc,1,H)
    decay_to_end = torch.exp(total - cum)  # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bf, decay_to_end, xdt)

    # Inter-chunk recurrence: the state entering each chunk.
    chunk_decay = torch.exp(total[:, :, 0, :])  # (B,nc,H)
    st = (torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
          if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1)  # (B,nc,H,N,P)

    # Off-diagonal term: state entering the chunk read out at each position.
    decay_from_start = torch.exp(cum)  # (B,nc,Q,H)
    y_off = torch.einsum("bcin,bcih,bchnp->bcihp", cf, decay_from_start, entering)

    y = (y_diag + y_off).reshape(bsz, s, h, p)[:, :s_orig]
    return y.to(x.dtype), st


def ssd_decode_step(
    x: torch.Tensor,  # (B, 1, H, P)
    dt: torch.Tensor,  # (B, 1, H)
    a: torch.Tensor,  # (H,)
    b_in: torch.Tensor,  # (B, 1, N)
    c_in: torch.Tensor,  # (B, 1, N)
    state: torch.Tensor,  # (B, H, N, P) fp32
) -> tuple[torch.Tensor, torch.Tensor]:
    xf = x[:, 0].float()  # (B,H,P)
    dtf = dt[:, 0].float()  # (B,H)
    bf = b_in[:, 0].float()  # (B,N)
    cf = c_in[:, 0].float()
    dA = torch.exp(dtf * a)  # (B,H)
    upd = torch.einsum("bn,bh,bhp->bhnp", bf, dtf, xf)
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cf, state)
    return y[:, None].to(x.dtype), state


def _split_proj(z: torch.Tensor, cfg):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(z, [di, di, n, n, h], dim=-1)  # gate, xs, B, C, dt


def _causal_conv(u: torch.Tensor, w: torch.Tensor, cache: torch.Tensor | None):
    """Depthwise causal conv1d. u: (B, S, C); w: (K, C).

    Returns (out (B,S,C), new_cache (B, K-1, C)).
    """
    k = w.shape[0]
    if cache is None:
        cache = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    ext = torch.cat([cache, u], dim=1)  # (B, S+K-1, C)
    out = ext[:, 0:u.shape[1]] * w[0]
    for i in range(1, k):
        out = out + ext[:, i:i + u.shape[1]] * w[i]
    new_cache = ext[:, -(k - 1):] if k > 1 else cache
    return F.silu(out), new_cache


class _Rank:
    """What a rank holding ``p``'s blocks runs (the module docstring):
    whether ``in_proj`` holds a block of columns and ``out_proj`` one of
    rows; the rows' channels of ``d_inner``; the heads it scans (its
    rows' heads where they cover whole heads, ``aligned``, else all)."""

    def __init__(self, p, cfg, mesh):
        di, hp, h = cfg.d_inner, cfg.ssm_head_dim, cfg.ssm_heads
        rows = p.out_proj.shape[0]
        self.mesh = mesh
        self.split_in = p.in_proj.shape[1] != 2 * di + 2 * cfg.ssm_state + h
        self.split_out = rows != di
        i = mesh.coord["model"] if self.split_out else 0
        self.channels = slice(i * rows, (i + 1) * rows)
        self.aligned = self.split_out and rows % hp == 0
        self.heads = (slice(i * rows // hp, (i + 1) * rows // hp)
                      if self.aligned else slice(0, h))
        # The whole weights a rank reads for its own heads only.
        self.w = {k: getattr(p, k) for k in ("conv_w", "dt_bias", "a_log",
                                              "d_skip", "norm")}
        if self.aligned:
            self.w = {k: mesh.copy_to(v) for k, v in self.w.items()}


def _rank(p, cfg, mesh):
    return _Rank(p, cfg, mesh) if mesh is not None else None


def _conv(conv_in, conv_w, cache, r):
    """The causal conv of ``conv_in``; where ``cache`` holds a block of the
    conv tail's channels (a rank's decode cache), the block's channels
    with it, ``all_gather``ed over ``model``, and the block's new tail."""
    c = conv_in.shape[-1]
    if cache is None or cache.shape[-1] == c:
        return _causal_conv(conv_in, conv_w, cache)
    n, i = cache.shape[-1], r.mesh.coord["model"]
    blk = slice(i * n, (i + 1) * n)
    out, cache = _causal_conv(conv_in[..., blk], conv_w[:, blk], cache)
    return r.mesh.all_gather(out, "model").movedim(0, -2).flatten(-2), cache


def _mixer_in(p, x, cfg, conv_cache, r=None):
    """in_proj, the causal conv and the dt/A transforms shared by the
    sequence and decode paths; with a `_Rank`, its heads' xs, dt and A
    (module docstring)."""
    n = cfg.ssm_state
    w = r.w if r is not None else {k: getattr(p, k) for k in ("conv_w", "dt_bias",
                                                               "a_log")}
    if r is not None and r.split_in:
        z = r.mesh.copy_to(x) @ p.in_proj
        z = r.mesh.all_gather(z, "model").movedim(0, -2).flatten(-2)
    else:
        z = x @ p.in_proj
    if r is not None and r.aligned:
        z = r.mesh.copy_to(z)
    gate, xs, b_in, c_in, dt = _split_proj(z, cfg)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)
    conv_out, conv_cache = _conv(conv_in, w["conv_w"], conv_cache, r)
    xs, b_in, c_in = torch.split(conv_out, [cfg.d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + w["dt_bias"])
    a = -torch.exp(w["a_log"].float())
    if r is not None and r.aligned:
        gate, xs = gate[..., r.channels], xs[..., r.channels]
        dt, a = dt[..., r.heads], a[r.heads]
    return gate, xs, b_in, c_in, dt, a, conv_cache


def _mixer_out(p, y, xh, gate, cfg, r=None):
    b, s = y.shape[:2]
    if r is None or not r.split_out:
        y = y + xh * p.d_skip.to(xh.dtype)[None, None, :, None]
        y = y.reshape(b, s, cfg.d_inner)
        y = rms_norm(y * F.silu(gate), p.norm, cfg.norm_eps)
        return y @ p.out_proj
    mesh = r.mesh
    d_skip = r.w["d_skip"][r.heads]
    y = y + xh * d_skip.to(xh.dtype)[None, None, :, None]
    y = y.reshape(b, s, -1) * F.silu(gate)
    if not r.aligned:  # every head: keep this rank's rows' channels
        y = rms_norm(y, r.w["norm"], cfg.norm_eps)
        return row_parallel(mesh.copy_to(y)[..., r.channels], p.out_proj, mesh)
    # RMSNorm over all of d_inner: the squares summed over model, in f32.
    yf = y.float()
    sq = mesh.copy_to(mesh.all_reduce(torch.sum(yf * yf, dim=-1, keepdim=True),
                                      "model"))
    y = (yf * torch.rsqrt(sq / cfg.d_inner + cfg.norm_eps)
         * r.w["norm"][r.channels].float()).to(y.dtype)
    return row_parallel(y, p.out_proj, mesh)


def mamba_block(
    p, x: torch.Tensor, cfg,
    init_state: torch.Tensor | None = None,
    conv_cache: torch.Tensor | None = None,
    mesh=None,
) -> tuple[torch.Tensor, dict]:
    """Full Mamba-2 mixer over a sequence. x: (B, S, D).  On a rank
    (``mesh``), the state is that of the heads it runs and the conv tail
    whole (module docstring)."""
    b, s, _ = x.shape
    r = _rank(p, cfg, mesh)
    gate, xs, b_in, c_in, dt, a, conv_cache = _mixer_in(p, x, cfg, conv_cache, r)
    xh = xs.reshape(b, s, -1, cfg.ssm_head_dim)
    y, state = ssd_scan(xh, dt, a, b_in, c_in, cfg.ssm_chunk, init_state)
    return _mixer_out(p, y, xh, gate, cfg, r), {"state": state, "conv": conv_cache}


def mamba_decode(p, x: torch.Tensor, cfg, cache: dict,
                 mesh=None) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, D); cache {state, conv}, updated in
    place; on a rank (``mesh``), its blocks of them (module docstring)."""
    b = x.shape[0]
    r = _rank(p, cfg, mesh)
    gate, xs, b_in, c_in, dt, a, conv = _mixer_in(p, x, cfg, cache["conv"], r)
    xh = xs.reshape(b, 1, -1, cfg.ssm_head_dim)
    y, state = ssd_decode_step(xh, dt, a, b_in, c_in, cache["state"])
    cache["state"].copy_(state)
    cache["conv"].copy_(conv)
    return _mixer_out(p, y, xh, gate, cfg, r), cache


def init_mamba_cache(batch: int, cfg, dtype, device,
                     lead: tuple[int, ...] = ()) -> dict:
    """A {state, conv} cache; ``lead`` prepends stack dims (layers)."""
    return {
        "state": torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_state,
                                     cfg.ssm_head_dim),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1,
                                    cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
    }
