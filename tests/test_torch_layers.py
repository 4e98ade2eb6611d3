"""The port's dense layer library against the JAX package's.

The same numpy inputs go through ``repro.models.layers`` and
``repro_torch.models.layers`` in f32 on the CPU; every output agrees to
1e-5 (sums in another order): norms of both kinds, the per-head RMS norm,
rotary embeddings with full and partial rotation (interleaved pairs),
the chunked ``sdpa`` (one chunk, several chunks, a window, no causal
mask, GQA; a query count that is not a whole number of chunks raises in
both), GQA attention prefill and cached decode at per-slot positions,
full-sequence attention (causal and not), and whisper's cross-attention
over the encoder's KV.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = 1e-5


def _pair(x):
    """numpy -> (jax f32, torch f32)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _tree(params):
    """The reference's parameter dict as the port's dict of tensors."""
    return {k: _tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.normal(size=(2, 5, 24)) * 3 + 1)
    scale, bias = rng.normal(size=24), rng.normal(size=24)
    jp = {"scale": jnp.asarray(scale, jnp.float32)}
    tp = {"scale": torch.tensor(scale, dtype=torch.float32)}
    if kind == "layernorm":
        jp["bias"] = jnp.asarray(bias, jnp.float32)
        tp["bias"] = torch.tensor(bias, dtype=torch.float32)
    _close(TL.apply_norm(tp, tx), JL.apply_norm(jp, jx))


def test_rms_head_norm():
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.normal(size=(2, 5, 4, 16)))
    js, ts = _pair(rng.normal(size=16))
    _close(TL.rms_head_norm(ts, tx), JL.rms_head_norm(js, jx))


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_apply_rope(pct):
    """Interleaved pairs, partial rotation, per-row positions."""
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.normal(size=(2, 6, 3, 32)))
    pos = np.stack([np.arange(6), np.arange(6) + 11]).astype(np.int32)
    want = JL.apply_rope(jx, jnp.asarray(pos), 10_000.0, pct)
    _close(TL.apply_rope(tx, torch.from_numpy(pos), 10_000.0, pct), want)
    # not HF's rotate-half: that layout gives another result
    half = tx.reshape(2, 6, 3, 2, 16).transpose(-1, -2).reshape(2, 6, 3, 32)
    if pct == 1.0:
        got = TL.apply_rope(half, torch.from_numpy(pos), 10_000.0, pct)
        assert not np.allclose(got.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("Sq,chunk,window,causal,H,KV", [
    (32, 1024, 0, True, 4, 4),      # one chunk
    (64, 16, 0, True, 8, 2),        # the chunk loop (the reference scans)
    (32, 1024, 8, True, 4, 2),      # a sliding window
    (48, 16, 0, False, 6, 3),       # no causal mask, chunked
])
def test_sdpa(Sq, chunk, window, causal, H, KV):
    rng = np.random.default_rng(Sq + H)
    jq, tq = _pair(rng.normal(size=(2, Sq, H, 16)))
    jk, tk = _pair(rng.normal(size=(2, Sq, KV, 16)))
    jv, tv = _pair(rng.normal(size=(2, Sq, KV, 16)))
    pos = np.arange(Sq)
    want = JL.sdpa(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                   causal=causal, window=window, chunk=chunk)
    got = TL.sdpa(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos),
                  causal=causal, window=window, chunk=chunk)
    _close(got, want)


def test_sdpa_raises_on_a_ragged_last_chunk():
    """Sq = 1500 over chunks of 1024 (whisper's 1500 frames): the
    reference's reshape fails, and the port raises instead of returning
    only the first 1024 rows."""
    rng = np.random.default_rng(9)
    jq, tq = _pair(rng.normal(size=(1, 1500, 2, 8)))
    pos = np.arange(1500)
    with pytest.raises(TypeError):
        JL.sdpa(jq, jq, jq, jnp.asarray(pos), jnp.asarray(pos),
                causal=False, chunk=1024)
    with pytest.raises(ValueError, match="chunks of 1024"):
        TL.sdpa(tq, tq, tq, torch.from_numpy(pos), torch.from_numpy(pos),
                causal=False, chunk=1024)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_fwd(causal):
    """Full-sequence attention (whisper's encoder takes it non-causal)."""
    jcfg = ref_get_config("whisper-base", reduced=True)
    cfg = from_reference(jcfg)
    jp, _ = JL.init_attention(jcfg, jax.random.PRNGKey(10))
    tp = _tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(11)
    jx, tx = _pair(rng.normal(size=(2, 12, cfg.d_model)))
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    _close(TL.attention_fwd(tp, tx, cfg, torch.from_numpy(pos),
                            causal=causal),
           JL.attention_fwd(jp, jx, jcfg, jnp.asarray(pos), causal=causal))


def test_cross_attention_over_encoder_kv():
    jcfg = ref_get_config("whisper-base", reduced=True)
    cfg = from_reference(jcfg)
    jp, _ = JL.init_attention(jcfg, jax.random.PRNGKey(12))
    tp = _tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(13)
    je, te = _pair(rng.normal(size=(2, 20, cfg.d_model)))
    jx, tx = _pair(rng.normal(size=(2, 5, cfg.d_model)))
    jkv, tkv = JL.encode_kv(jp, je, jcfg), TL.encode_kv(tp, te, cfg)
    for t, j in zip(tkv, jkv):
        _close(t, j)
    _close(TL.cross_attention_fwd(tp, tx, tkv, cfg),
           JL.cross_attention_fwd(jp, jx, jkv, jcfg))


@pytest.mark.parametrize("arch,window", [("qwen2-0.5b", 0),
                                         ("qwen3-4b", 0),
                                         ("stablelm-1.6b", 4)])
def test_attention_prefill_and_decode(arch, window):
    """GQA attention (QKV bias, qk-norm, partial rotary, a window) over a
    prompt, then one decode step at per-slot positions into the cache;
    the port writes the cache in place."""
    jcfg = dataclasses.replace(ref_get_config(arch, reduced=True),
                               attn_window=window)
    cfg = from_reference(jcfg)
    jp, _ = JL.init_attention(jcfg, jax.random.PRNGKey(3))
    if "bq" in jp:      # non-zero biases, so they are exercised
        jp = dict(jp, **{b: jnp.full_like(jp[b], 0.1) for b in
                         ("bq", "bk", "bv")})
    tp = _tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(4)
    B, S, S_max = 2, 10, 16
    jx, tx = _pair(rng.normal(size=(B, S, cfg.d_model)))
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jo, (jk, jv) = JL.attention_prefill(jp, jx, jcfg, jnp.asarray(pos))
    to, (tk, tv) = TL.attention_prefill(tp, tx, cfg, torch.from_numpy(pos))
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)

    jcache = tuple(jnp.zeros((B, S_max) + a.shape[2:]).at[:, :S].set(a)
                   for a in (jk, jv))
    tcache = tuple(torch.zeros((B, S_max) + tuple(a.shape[2:]))
                   for a in (tk, tv))
    tcache[0][:, :S], tcache[1][:, :S] = tk, tv
    slot_pos = np.array([S, S - 3], np.int32)       # slots at their own pos
    jy, ty = _pair(rng.normal(size=(B, 1, cfg.d_model)))
    jd, jc = JL.attention_decode(jp, jy, jcache, jcfg, jnp.asarray(slot_pos))
    td, tc = TL.attention_decode(tp, ty, tcache, cfg,
                                 torch.from_numpy(slot_pos))
    _close(td, jd)
    _close(tc[0], jc[0])
    _close(tc[1], jc[1])
    assert tc[0] is tcache[0]                      # written in place
    # a scalar position broadcasts to every slot
    jd, _ = JL.attention_decode(jp, jy, jc, jcfg, S + 1)
    td, _ = TL.attention_decode(tp, ty, tc, cfg, S + 1)
    _close(td, jd)


def test_mlp_and_embedding():
    jcfg = ref_get_config("stablelm-1.6b", reduced=True)
    cfg = from_reference(jcfg)
    jm, _ = JL.init_mlp(cfg.d_model, cfg.d_ff, jax.random.PRNGKey(5))
    je, _ = JL.init_embedding(jcfg, jax.random.PRNGKey(6))
    tm, te = (_tree(jax.tree.map(np.asarray, p)) for p in (jm, je))
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng.normal(size=(2, 3, cfg.d_model)))
    _close(TL.mlp_fwd(tm, tx), JL.mlp_fwd(jm, jx))
    _close(TL.mlp_hidden(tm, tx), JL.mlp_hidden(jm, jx))
    toks = rng.integers(0, cfg.vocab_size, size=(2, 3)).astype(np.int32)
    _close(TL.embed(te, torch.from_numpy(toks), cfg),
           JL.embed(je, jnp.asarray(toks), jcfg))
    _close(TL.lm_logits(te, tx, cfg), JL.lm_logits(je, jx, jcfg))


def test_port_init_shapes_and_scales():
    """The port's own init draws the reference's shapes and scales (its
    numbers are its generator's, not ``jax.random``'s)."""
    jcfg = ref_get_config("qwen2-0.5b", reduced=True)
    cfg = from_reference(jcfg)
    gen = torch.Generator().manual_seed(0)
    tp = TL.init_attention(cfg, gen, device="cpu")
    jp, _ = JL.init_attention(jcfg, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tp.named_parameters()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    assert abs(float(tp["wq"].std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    te = TL.init_embedding(cfg, gen, device="cpu")
    assert abs(float(te["tok"].std()) - 0.02) < 0.002
