"""The ``tests/test_attention.py`` and ``tests/test_mamba.py`` cases run
through the port with the reference as oracle: the same numpy-seeded
inputs into both packages' attention (chunked mha, decode, ring-buffer
caches, MLA) and Mamba-2 (SSD scan, decode step, causal conv) functions.
f32 results within rtol 2e-5 / atol 2e-6 of the reference (tighter than
the reference tests' bounds against their naive oracles), cache positions
and ring-buffer contents exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import mamba2 as ref_mamba  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, mamba2, mla  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, b, sq, skv, h, kvh, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, hd)).astype(np.float32)
    return q, k, v


def _close(got, ref, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32),
                               **(tol or TOL))


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2), (6, 1)])
@pytest.mark.parametrize("chunk", [4, 16, 64])
def test_mha_matches_reference(h, kvh, chunk):
    b, s, hd = 2, 33, 16  # odd length exercises padding
    q, k, v = _qkv(0, b, s, s, h, kvh, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    ref = ref_attn.mha(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True,
                       kv_chunk=chunk)
    got = attention.mha(*map(_t, (q, k, v, pos, pos)), causal=True, kv_chunk=chunk)
    _close(got, ref)


def test_mha_sliding_window_masks_whole_chunks():
    """Window 8 under 16-wide chunks: late queries see fully masked chunks
    (NEG_INF scores, weights exp(0) = 1 until the correction clears them)."""
    b, s, h, hd, w = 1, 48, 2, 8, 8
    q, k, v = _qkv(3, b, s, s, h, h, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    ref = ref_attn.mha(*map(jnp.asarray, (q, k, v, pos, pos)), causal=True,
                       window=w, kv_chunk=16)
    got = attention.mha(*map(_t, (q, k, v, pos, pos)), causal=True, window=w,
                        kv_chunk=16)
    assert torch.isfinite(got).all()
    _close(got, ref)


def test_mha_cross_no_causal():
    b, sq, skv, h, hd = 2, 5, 11, 2, 8
    q, k, v = _qkv(6, b, sq, skv, h, h, hd)
    qpos = np.zeros((b, sq), np.int32)
    kpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv))
    ref = ref_attn.mha(*map(jnp.asarray, (q, k, v, qpos, kpos)), causal=False,
                       kv_chunk=4)
    got = attention.mha(*map(_t, (q, k, v, qpos, kpos)), causal=False, kv_chunk=4)
    _close(got, ref)


def test_mha_bf16_scores_in_f32():
    """bf16 operands with f32 score and P.V products, p rounded to bf16
    where the reference rounds it: within one bf16 ulp of the output."""
    b, s, h, kvh, hd = 2, 40, 4, 2, 32
    q, k, v = _qkv(8, b, s, s, h, kvh, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = ref_attn.mha(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos), kv_chunk=16)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention.mha(tq, tk, tv, _t(pos), _t(pos), kv_chunk=16)
    assert got.dtype == torch.bfloat16
    _close(got, ref, rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_matches_reference_and_mha_last_position(window):
    b, s, h, kvh, hd = 2, 12, 4, 2, 8
    q, k, v = _qkv(9, b, s, s, h, kvh, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    cache = attention.init_kv_cache(b, s, kvh, hd, torch.float32, "cpu")
    attention.update_kv_cache(cache, _t(k), _t(v), _t(pos))
    got = attention.decode_attend(_t(q[:, -1:]), cache["k"], cache["v"],
                                  cache["pos"], _t(pos[:, -1:]), window=window)
    rc = ref_attn.update_kv_cache(ref_attn.init_kv_cache(b, s, kvh, hd, jnp.float32),
                                  jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    ref = ref_attn.decode_attend(jnp.asarray(q[:, -1:]), rc["k"], rc["v"], rc["pos"],
                                 jnp.asarray(pos[:, -1:]), window=window)
    _close(got, ref)
    full = attention.mha(*map(_t, (q, k, v, pos, pos)), causal=True, window=window,
                         kv_chunk=4)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, -1].numpy(),
                               rtol=2e-4, atol=2e-5)


def test_ring_cache_keeps_last_window():
    b, kvh, hd, w = 1, 1, 4, 8
    cache = attention.init_kv_cache(b, w, kvh, hd, torch.float32, "cpu")
    rc = ref_attn.init_kv_cache(b, w, kvh, hd, jnp.float32)
    for t in range(20):
        k_new = np.full((b, 1, kvh, hd), float(t), np.float32)
        p = np.full((b, 1), t, np.int32)
        attention.update_kv_cache(cache, _t(k_new), _t(k_new), _t(p))
        rc = ref_attn.update_kv_cache(rc, jnp.asarray(k_new), jnp.asarray(k_new),
                                      jnp.asarray(p))
    assert sorted(cache["pos"][0].tolist()) == list(range(12, 20))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(rc[name]))


def test_prefill_longer_than_ring_cache():
    b, s, kvh, hd, w = 1, 20, 1, 4, 8
    k_all = np.arange(s, dtype=np.float32).reshape(1, s, 1, 1) * np.ones(
        (b, s, kvh, hd), np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    cache = attention.init_kv_cache(b, w, kvh, hd, torch.float32, "cpu")
    attention.update_kv_cache(cache, _t(k_all), _t(k_all), _t(pos))
    rc = ref_attn.update_kv_cache(ref_attn.init_kv_cache(b, w, kvh, hd, jnp.float32),
                                  jnp.asarray(k_all), jnp.asarray(k_all),
                                  jnp.asarray(pos))
    assert sorted(cache["pos"][0].tolist()) == list(range(12, 20))
    for name in ("k", "v", "pos"):
        np.testing.assert_array_equal(cache[name].numpy(), np.asarray(rc[name]))


# --------------------------------------------------------------------- MLA


def test_mla_prefill_and_absorbed_decode_match_reference():
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    rcfg = ref_config("deepseek-v2-lite-16b").reduced()
    model = build_model(cfg, "cpu", seed=0)
    p = model.layers[0].attn
    rp = {k: jnp.asarray(v.detach().numpy()) for k, v in p.named_parameters()}
    b, s = 2, 9
    x = np.random.default_rng(11).standard_normal((b, s + 1, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(s + 1, dtype=np.int32), (b, s + 1))
    with torch.inference_mode():
        out, c = mla.mla_attention(p, _t(x[:, :s]), _t(pos[:, :s]), cfg, kv_chunk=4)
        cache = mla.init_mla_cache(b, s + 1, cfg, torch.float32, "cpu")
        mla.update_mla_cache(cache, c["c_kv"], c["k_pe"], _t(pos[:, :s]))
        dec, cache = mla.mla_decode(p, _t(x[:, s:]), cache, _t(pos[:, s:]), cfg)
    rout, rc = ref_mla.mla_attention(rp, jnp.asarray(x[:, :s]), jnp.asarray(pos[:, :s]),
                                     rcfg, kv_chunk=4)
    rcache = ref_mla.update_mla_cache(ref_mla.init_mla_cache(b, s + 1, rcfg, jnp.float32),
                                      rc["c_kv"], rc["k_pe"], jnp.asarray(pos[:, :s]))
    rdec, rcache = ref_mla.mla_decode(rp, jnp.asarray(x[:, s:]), rcache,
                                      jnp.asarray(pos[:, s:]), rcfg)
    _close(out, rout, rtol=2e-5, atol=2e-5)
    _close(dec, rdec, rtol=2e-5, atol=2e-5)
    for name in ("c_kv", "k_pe"):
        _close(cache[name], rcache[name])
    np.testing.assert_array_equal(cache["pos"].numpy(), np.asarray(rcache["pos"]))


# ------------------------------------------------------------------- Mamba-2


def _ssd_inputs(seed, bsz, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, (bsz, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, h).astype(np.float32)
    b_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    c_in = rng.standard_normal((bsz, s, n)).astype(np.float32)
    return x, dt, a, b_in, c_in


@pytest.mark.parametrize("s,chunk", [(16, 4), (32, 8), (24, 8), (7, 4)])
def test_ssd_scan_matches_reference(s, chunk):
    args = _ssd_inputs(0, 2, s, 3, 4, 5)
    y, final = mamba2.ssd_scan(*map(_t, args), chunk)
    ry, rfinal = ref_mamba.ssd_scan(*map(jnp.asarray, args), chunk)
    _close(y, ry, rtol=2e-5, atol=2e-5)
    _close(final, rfinal, rtol=2e-5, atol=2e-5)


def test_ssd_decode_continues_scan():
    """prefill via ssd_scan then one decode step == the reference's step
    from the reference's state, and == the scan over s+1 tokens."""
    s, chunk = 16, 4
    x, dt, a, b_in, c_in = _ssd_inputs(1, 1, s + 1, 2, 4, 3)
    head = [v[:, :s] for v in (x, dt)] + [a] + [v[:, :s] for v in (b_in, c_in)]
    tail = [v[:, s:] for v in (x, dt)] + [a] + [v[:, s:] for v in (b_in, c_in)]
    _, state = mamba2.ssd_scan(*map(_t, head), chunk)
    y_dec, state2 = mamba2.ssd_decode_step(*map(_t, tail), state)
    _, rstate = ref_mamba.ssd_scan(*map(jnp.asarray, head), chunk)
    ry_dec, rstate2 = ref_mamba.ssd_decode_step(*map(jnp.asarray, tail), rstate)
    _close(y_dec, ry_dec, rtol=2e-5, atol=2e-5)
    _close(state2, rstate2, rtol=2e-5, atol=2e-5)
    y_full, _ = mamba2.ssd_scan(*map(_t, (x, dt, a, b_in, c_in)), chunk)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_full[:, s].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_ssd_state_decays():
    """With zero input, the state decays towards zero (stability)."""
    bsz, s, h, p, n = 1, 8, 1, 2, 2
    x = np.zeros((bsz, s, h, p), np.float32)
    dt = np.full((bsz, s, h), 0.5, np.float32)
    a = np.array([-1.0], np.float32)
    ones = np.ones((bsz, s, n), np.float32)
    state0 = np.ones((bsz, h, n, p), np.float32)
    _, final = mamba2.ssd_scan(*map(_t, (x, dt, a, ones, ones)), 4,
                               init_state=_t(state0))
    _, rfinal = ref_mamba.ssd_scan(*map(jnp.asarray, (x, dt, a, ones, ones)), 4,
                                   init_state=jnp.asarray(state0))
    assert float(final.abs().max()) < 1.0
    _close(final, rfinal)


def test_segsum_and_causal_conv_match_reference():
    rng = np.random.default_rng(5)
    da = -rng.uniform(0.0, 1.0, (2, 3, 8)).astype(np.float32)
    seg = mamba2._segsum(_t(da))
    rseg = np.asarray(ref_mamba._segsum(jnp.asarray(da)))
    np.testing.assert_array_equal(np.isinf(seg.numpy()), np.isinf(rseg))
    _close(seg.nan_to_num(neginf=0.0), np.nan_to_num(rseg, neginf=0.0))
    u = rng.standard_normal((2, 6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for c in (None, cache):
        out, new = mamba2._causal_conv(_t(u), _t(w), None if c is None else _t(c))
        rout, rnew = ref_mamba._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                            None if c is None else jnp.asarray(c))
        _close(out, rout)
        np.testing.assert_array_equal(new.numpy(), np.asarray(rnew))


def test_mamba_block_and_decode_match_reference():
    """The whole mixer (carried weights): sequence then one decode step."""
    rcfg = ref_config("mamba2-780m").reduced()
    cfg = get_config("mamba2-780m").reduced()
    model = build_model(cfg, "cpu", seed=2)
    p = model.layers[0].mamba
    rp = {k: jnp.asarray(v.detach().numpy()) for k, v in p.named_parameters()}
    x = np.random.default_rng(12).standard_normal((2, 21, cfg.d_model)).astype(
        np.float32)
    with torch.inference_mode():
        out, cache = mamba2.mamba_block(p, _t(x[:, :20]), cfg)
        dec, cache = mamba2.mamba_decode(p, _t(x[:, 20:]), cfg, cache)
    rout, rcache = ref_mamba.mamba_block(rp, jnp.asarray(x[:, :20]), rcfg)
    rdec, rcache = ref_mamba.mamba_decode(rp, jnp.asarray(x[:, 20:]), rcfg, rcache)
    _close(out, rout, rtol=2e-5, atol=2e-5)
    _close(dec, rdec, rtol=2e-5, atol=2e-5)
    for name in ("state", "conv"):
        _close(cache[name], rcache[name], rtol=2e-5, atol=2e-5)
