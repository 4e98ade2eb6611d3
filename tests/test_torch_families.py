"""Every non-dense model family of the port against the JAX package's.

For each family's reduced configuration (llama4-scout: MoE with GQA;
deepseek-v2-lite: MoE with MLA; xlstm: mLSTM/sLSTM pairs; zamba2: Mamba2
with one shared attention block; internvl2: the vlm prefix path;
whisper: encoder-decoder) the JAX weights are carried across with
``interop.params_from_reference``; then the port's prefill logits and
caches or states, and four decode steps at per-slot positions, agree
with the JAX package's on the CPU to 1e-4 of the largest magnitude.

Serving: the greedy ``ServeLoop`` gives the JAX ``ServeLoop``'s tokens
exactly, refills included, for llama4, deepseek and xlstm (the MoE
drops tokens by T = B S, so the port is held to the reference at the
same batch, not to solo runs).  For zamba2 the reference's loop splices
a refill's Mamba state into slot 0 (its splice writes axis 1 of every
leaf; the Mamba leaves carry the batch on axis 2), so the port is held
to the reference's first wave and every request, refills included, to
its own batch-1 run of the reference.

Weights: every family's tree crosses key for key, exactly, and a
missing key, an extra key, a wrong shape or a wrong stack count raises.
Init casts each part to the configuration's type as it is built, with
the values a cast of the f32 draws would give.  ``gpu``-marked cases
hold each family's card prefill and decode to the CPU's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.serve import ServeLoop as RefServeLoop  # noqa: E402
from repro.models import get_api as ref_get_api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import from_reference, params_from_reference  # noqa: E402
from repro_torch.launch.serve import ServeLoop, _splice_cache  # noqa: E402
from repro_torch.models import get_api  # noqa: E402

#: relative to the largest magnitude: f32 sums in another order, 2 layers
LOGIT_TOL = 1e-4
FAMILIES = ["llama4-scout-17b-a16e", "deepseek-v2-lite-16b", "xlstm-350m",
            "zamba2-7b", "internvl2-76b", "whisper-base"]
#: the stacked group of each family's reference tree
GROUP = {"xlstm-350m": "pairs", "zamba2-7b": "mamba", "whisper-base": "dec"}


@functools.lru_cache(maxsize=None)
def _reference(arch, seed=0):
    jcfg = ref_get_config(arch, reduced=True)
    jparams, _ = ref_get_api(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams


def _both(arch, seed=0):
    """(reference api, params, cfg) and (port api, model, cfg) on the same
    weights."""
    jcfg, jp = _reference(arch, seed)
    cfg = from_reference(jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                  device="cpu")
    return (ref_get_api(jcfg), jp, jcfg), (get_api(cfg), model, cfg)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def _check_cache(tc, jc):
    tl, jl = _leaves(tc), jax.tree.leaves(jc)
    assert [tuple(t.shape) for t in tl] == [j.shape for j in jl]
    for t, j in zip(tl, jl):
        assert _rel(t, j) <= LOGIT_TOL


def _inputs(cfg, rng, B, S):
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if not cfg.enc_dec:
        return toks, jnp.asarray(toks), torch.from_numpy(toks)
    frames = rng.normal(size=(B, 16, cfg.d_model)).astype(np.float32)
    return (toks, (jnp.asarray(frames), jnp.asarray(toks)),
            (torch.from_numpy(frames), torch.from_numpy(toks)))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_and_decode_match_reference(arch):
    (japi, jp, jcfg), (api, model, cfg) = _both(arch, seed=len(arch))
    rng = np.random.default_rng(1)
    B, S, S_max = 2, 8, 16
    _, jin, tin = _inputs(cfg, rng, B, S)
    jl, jc = japi.prefill(jp, jin, jcfg, S_max)
    tl, tc = api.prefill(model, tin, cfg, S_max)
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size)
    assert _rel(tl, jl) <= LOGIT_TOL
    _check_cache(tc, jc)
    pos = np.array([S, S - 3], np.int32)        # slots at their own pos
    for _ in range(4):
        tok = rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = japi.decode_step(jp, jnp.asarray(tok), jc,
                                  jnp.asarray(pos), jcfg)
        tl, tc = api.decode_step(model, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos), cfg)
        assert _rel(tl, jl) <= LOGIT_TOL
        pos = pos + 1
    _check_cache(tc, jc)


def test_vlm_prefix_embeds_match_reference():
    """internvl2's stub frontend: 6 precomputed patch embeddings before 8
    tokens, then decode steps past them."""
    (japi, jp, jcfg), (api, model, cfg) = _both("internvl2-76b", seed=3)
    rng = np.random.default_rng(2)
    B, P, S, S_max = 2, 6, 8, 20
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pre = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    jl, jc = japi.prefill(jp, jnp.asarray(toks), jcfg, S_max,
                          prefix_embeds=jnp.asarray(pre))
    tl, tc = api.prefill(model, torch.from_numpy(toks), cfg, S_max,
                         prefix_embeds=torch.from_numpy(pre))
    assert _rel(tl, jl) <= LOGIT_TOL
    _check_cache(tc, jc)
    assert not tc[0][:, :, P + S:].any()         # zero past the input
    for step in range(3):
        tok = rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = japi.decode_step(jp, jnp.asarray(tok), jc, P + S + step,
                                  jcfg)
        tl, tc = api.decode_step(model, torch.from_numpy(tok), tc,
                                 P + S + step, cfg)
        assert _rel(tl, jl) <= LOGIT_TOL


def test_whisper_encoder_and_cross_kv():
    """whisper: the decoder's self-attention cache is min(S_max,
    dec_max_len) long and the cross-attention KV is the encoder's."""
    (japi, jp, jcfg), (api, model, cfg) = _both("whisper-base", seed=4)
    _, jin, tin = _inputs(cfg, np.random.default_rng(5), 2, 8)
    jl, jc = japi.prefill(jp, jin, jcfg, 64)
    tl, tc = api.prefill(model, tin, cfg, 64)
    assert tuple(tc[0][0].shape)[2] == cfg.dec_max_len == 32
    assert tuple(tc[1][0].shape)[2] == 16
    assert _rel(tl, jl) <= LOGIT_TOL
    _check_cache(tc, jc)


def _prompts(cfg, n, seed=0, length=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=length) for _ in range(n)]


def _run(loop, prompts):
    for r, p in enumerate(prompts):
        loop.submit(r, p)
    loop.start()
    loop.drain()
    return loop.outputs


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "deepseek-v2-lite-16b", "xlstm-350m"])
def test_serveloop_tokens_match_reference(arch):
    """Batch 2, 4 requests (two refills), greedy: the JAX loop's tokens."""
    (japi, jp, jcfg), (api, model, cfg) = _both(arch)
    prompts = _prompts(cfg, 4)
    ref = _run(RefServeLoop(japi, jcfg, jp, batch=2, prompt_len=8, gen=5),
               prompts)
    port = ServeLoop(api, cfg, model, batch=2, prompt_len=8, gen=5,
                     device="cpu")
    assert _run(port, prompts) == ref
    assert port.prefills == 3 and all(len(v) == 5 for v in ref.values())


def test_zamba2_refills_equal_batch1_runs():
    """zamba2: the first wave equals the JAX loop's; every request,
    refills included, equals its batch-1 run (where the JAX loop's
    refills do not: it splices their Mamba state into slot 0)."""
    (japi, jp, jcfg), (api, model, cfg) = _both("zamba2-7b")
    prompts = _prompts(cfg, 4)
    ref = _run(RefServeLoop(japi, jcfg, jp, batch=2, prompt_len=8, gen=5),
               prompts)
    port = _run(ServeLoop(api, cfg, model, batch=2, prompt_len=8, gen=5,
                          device="cpu"), prompts)
    assert {r: port[r] for r in (0, 1)} == {r: ref[r] for r in (0, 1)}
    for r, prompt in enumerate(prompts):
        solo = _run(RefServeLoop(japi, jcfg, jp, batch=1, prompt_len=8,
                                 gen=5), [prompt])
        assert port[r] == solo[0]


def test_splice_writes_each_leafs_batch_axis():
    """The hybrid's Mamba leaves take the refill on axis 2, its KV on axis
    1; nothing else in the pool moves."""
    cfg = get_config("zamba2-7b", reduced=True)
    api = get_api(cfg)
    from repro_torch.models.transformer import hybrid_init_state
    pool = hybrid_init_state(cfg, 3, 10, torch.float32)
    single = hybrid_init_state(cfg, 1, 10, torch.float32)
    for leaf in _leaves(single):
        leaf.normal_()
    _splice_cache(pool, single, 1, api.batch_axes)
    for p, s, axis in zip(_leaves(pool), _leaves(single),
                          (2, 2, 1, 1)):
        assert torch.equal(p.select(axis, 1), s.select(axis, 0))
        assert not p.select(axis, 0).any() and not p.select(axis, 2).any()


def test_encdec_is_not_a_serveloop_model():
    cfg = get_config("whisper-base", reduced=True)
    api = get_api(cfg)
    model = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ServeLoop(api, cfg, model, batch=2, prompt_len=8, gen=4,
                  device="cpu")


# ----------------------------------------------------------------------
# weights
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", FAMILIES)
def test_state_dict_follows_reference_paths(arch):
    """Every leaf of the reference's tree lands under its path, exactly:
    stacked groups split per layer, the hybrid's shared block once."""
    jcfg, jp = _reference(arch)
    model = params_from_reference(jax.tree.map(np.asarray, jp), jcfg,
                                  device="cpu")
    sd = model.state_dict()
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        keys = [str(p.key) for p in path]
        leaf = np.asarray(leaf, np.float32)
        if keys[0] in ("blocks", "pairs", "mamba", "enc", "dec"):
            for layer in range(leaf.shape[0]):
                got = sd[".".join([keys[0], str(layer)] + keys[1:])]
                np.testing.assert_array_equal(got.float().numpy(),
                                              leaf[layer])
                n += 1
        else:
            np.testing.assert_array_equal(sd[".".join(keys)].float().numpy(),
                                          leaf)
            n += 1
    assert n == len(sd)
    if arch == "zamba2-7b":
        assert "shared.attn.wq" in sd and "mamba.3.mamba.w_in" in sd


@pytest.mark.parametrize("fault", ["missing", "extra", "shape", "stack"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_params_from_reference_raises(arch, fault):
    jcfg, jp = _reference(arch)
    tree = jax.tree.map(np.asarray, jp)
    group = tree[GROUP.get(arch, "blocks")]
    if fault == "missing":
        del tree["ln_f"]
    elif fault == "extra":
        tree["embed"]["bias"] = np.zeros(3, np.float32)
    elif fault == "shape":
        tree["embed"]["tok"] = tree["embed"]["tok"][:, :-1]
    else:
        first = next(iter(group))
        group[first] = jax.tree.map(lambda a: a[:-1], group[first])
    with pytest.raises(ValueError, match={"missing": "missing",
                                          "extra": "extra",
                                          "shape": "shape",
                                          "stack": "stacked"}[fault]):
        params_from_reference(tree, jcfg, device="cpu")


@pytest.mark.parametrize("arch", FAMILIES + ["qwen2-0.5b"])
def test_init_casts_each_part_as_built(arch):
    """A bf16 init holds the f32 init's values cast to bf16, every weight
    in bf16, with the reference's parameter count."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="bfloat16")
    api = get_api(cfg)
    bf = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    f32 = api.init(dataclasses.replace(cfg, dtype="float32"),
                   torch.Generator().manual_seed(0), "cpu")
    for (k, a), (_, b) in zip(bf.state_dict().items(),
                              f32.state_dict().items()):
        assert a.dtype == torch.bfloat16, k
        assert torch.equal(a, b.to(torch.bfloat16)), k
    jcfg, jp = _reference(arch)
    assert sum(p.numel() for p in bf.parameters()) == sum(
        np.asarray(x).size for x in jax.tree.leaves(jp))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILIES)
def test_card_prefill_and_decode_match_cpu(arch):
    """On the card: a prefill of 128 (K4 in f32 where the family reaches
    it; whisper's decoder prompt is 16, its reduced dec_max_len is 32) and
    two decode steps against the CPU path on the same weights, to 1e-4 of
    the largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    cfg = get_config(arch, reduced=True)
    api = get_api(cfg)
    model = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(6)
    S = 16 if cfg.enc_dec else 128
    _, _, tin = _inputs(cfg, rng, 2, S)
    tok = torch.from_numpy(
        rng.integers(1, cfg.vocab_size, size=(2, 1)).astype(np.int32))

    def run(m, dev):
        inp = (tuple(t.to(dev) for t in tin) if cfg.enc_dec
               else tin.to(dev))
        lg, cache = api.prefill(m, inp, cfg, S + 4)
        # copies: decode writes the cache in place
        out = [lg.cpu()] + [c.to("cpu", copy=True) for c in _leaves(cache)]
        for step in range(2):
            lg, cache = api.decode_step(m, tok.to(dev), cache, S + step,
                                        cfg)
            out.append(lg.cpu())
        return out

    want = run(model, "cpu")
    got = run(model.to("cuda"), "cuda")
    for g, w in zip(got, want):
        assert _rel(g, w.numpy()) <= LOGIT_TOL
