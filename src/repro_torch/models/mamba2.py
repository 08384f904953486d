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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm

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


def _mixer_in(p, x, cfg, conv_cache):
    """in_proj, the causal conv and the dt/A transforms shared by the
    sequence and decode paths."""
    n = cfg.ssm_state
    z = x @ p.in_proj
    gate, xs, b_in, c_in, dt = _split_proj(z, cfg)
    conv_in = torch.cat([xs, b_in, c_in], dim=-1)
    conv_out, conv_cache = _causal_conv(conv_in, p.conv_w, conv_cache)
    xs, b_in, c_in = torch.split(conv_out, [cfg.d_inner, n, n], dim=-1)
    dt = F.softplus(dt.float() + p.dt_bias)
    a = -torch.exp(p.a_log.float())
    return gate, xs, b_in, c_in, dt, a, conv_cache


def _mixer_out(p, y, xh, gate, cfg):
    b, s = y.shape[:2]
    y = y + xh * p.d_skip.to(xh.dtype)[None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner)
    y = rms_norm(y * F.silu(gate), p.norm, cfg.norm_eps)
    return y @ p.out_proj


def mamba_block(
    p, x: torch.Tensor, cfg,
    init_state: torch.Tensor | None = None,
    conv_cache: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict]:
    """Full Mamba-2 mixer over a sequence. x: (B, S, D)."""
    b, s, _ = x.shape
    gate, xs, b_in, c_in, dt, a, conv_cache = _mixer_in(p, x, cfg, conv_cache)
    xh = xs.reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    y, state = ssd_scan(xh, dt, a, b_in, c_in, cfg.ssm_chunk, init_state)
    return _mixer_out(p, y, xh, gate, cfg), {"state": state, "conv": conv_cache}


def mamba_decode(p, x: torch.Tensor, cfg, cache: dict) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, D); cache {state, conv}, updated in
    place."""
    b = x.shape[0]
    gate, xs, b_in, c_in, dt, a, conv = _mixer_in(p, x, cfg, cache["conv"])
    xh = xs.reshape(b, 1, cfg.ssm_heads, cfg.ssm_head_dim)
    y, state = ssd_decode_step(xh, dt, a, b_in, c_in, cache["state"])
    cache["state"].copy_(state)
    cache["conv"].copy_(conv)
    return _mixer_out(p, y, xh, gate, cfg), cache


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
