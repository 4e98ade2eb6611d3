"""The port's dense LM serving path against the JAX package's.

For every dense reduced configuration the JAX ``init_lm`` weights are
carried across with ``interop.params_from_reference``; then the port's
``lm_prefill`` logits and KV cache, and four ``lm_decode_step``s at
per-slot positions, agree with the JAX package's on the CPU to 1e-4 of
the largest |logit| (f32 sums taken in another order over 2 layers).  The
greedy ``ServeLoop`` gives the JAX ``ServeLoop``'s tokens exactly,
refills included, and keeps the lifecycle contracts of
``tests/test_system.py`` (metrics, mid-batch cancellation, draining and
abandoning shutdown).
"""
import dataclasses

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
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import ServeLoop  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

#: relative to the largest |logit|: f32 sums in another order, 2 layers
LOGIT_TOL = 1e-4
DENSE = ["qwen2-0.5b", "qwen3-4b", "stablelm-1.6b", "command-r-35b"]


def _both(jcfg, seed=0):
    """(reference api, params) and (port api, model, cfg) on the same
    weights."""
    jparams, _ = ref_get_api(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    cfg = from_reference(jcfg)
    model = params_from_reference(jax.tree.map(np.asarray, jparams), cfg,
                                  device="cpu")
    return (ref_get_api(jcfg), jparams), (get_api(cfg), model, cfg)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch", DENSE + ["command-r-35b-fused"])
def test_prefill_and_decode_match_reference(arch):
    jcfg = ref_get_config(arch.replace("-fused", ""), reduced=True)
    if arch.endswith("-fused"):     # the fused parallel block
        jcfg = dataclasses.replace(jcfg, fused_proj=True)
    (japi, jp), (api, model, cfg) = _both(jcfg, seed=len(arch))
    rng = np.random.default_rng(1)
    B, S, S_max = 2, 12, 20
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = japi.prefill(jp, jnp.asarray(toks), jcfg, S_max)
    tl, tc = api.prefill(model, torch.from_numpy(toks), cfg, S_max)
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size)
    assert tuple(tc[0].shape) == (cfg.num_layers, B, S_max,
                                  cfg.num_kv_heads, cfg.head_dim)
    assert _rel(tl, jl) <= LOGIT_TOL
    for t, j in zip(tc, jc):
        assert _rel(t, j) <= LOGIT_TOL
        assert not t[:, :, S:].any()            # zero past the prompt
    pos = np.array([S, S - 4], np.int32)        # slots at their own pos
    for _ in range(4):
        tok = rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        jl, jc = japi.decode_step(jp, jnp.asarray(tok), jc,
                                  jnp.asarray(pos), jcfg)
        tl, tc = api.decode_step(model, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos), cfg)
        assert _rel(tl, jl) <= LOGIT_TOL
        pos = pos + 1
    for t, j in zip(tc, jc):
        assert _rel(t, j) <= LOGIT_TOL


def test_prompt_of_128_matches_reference():
    """A prompt of 128 tokens (the length at which the card's sdpa takes
    the flash kernel; the CPU takes the chunked path)."""
    jcfg = ref_get_config("qwen2-0.5b", reduced=True)
    (japi, jp), (api, model, cfg) = _both(jcfg, seed=3)
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, size=(1, 128)).astype(np.int32)
    jl, _ = japi.prefill(jp, jnp.asarray(toks), jcfg, 129)
    tl, _ = api.prefill(model, torch.from_numpy(toks), cfg, 129)
    assert _rel(tl, jl) <= LOGIT_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_dict_keys_follow_reference_paths(dtype):
    """Weights land under the reference's paths, exactly (bf16 ones
    too, which cross numpy as ml_dtypes arrays)."""
    jcfg = dataclasses.replace(ref_get_config("qwen2-0.5b", reduced=True),
                               dtype=dtype)
    (_, jp), (_, model, cfg) = _both(jcfg, seed=4)
    sd = model.state_dict()
    assert sd["blocks.1.attn.wq"].dtype == getattr(torch, dtype)
    for key, ref in (("blocks.1.attn.wq", jp["blocks"]["attn"]["wq"][1]),
                     ("embed.tok", jp["embed"]["tok"])):
        np.testing.assert_array_equal(sd[key].float().numpy(),
                                      np.asarray(ref, np.float32))
    assert "embed.head" not in sd           # tied embeddings
    leaves = [k for k, _ in jax.tree_util.tree_leaves_with_path(jp)]
    per_layer = sum(str(k[0].key) == "blocks" for k in leaves)
    assert len(sd) == len(leaves) - per_layer + cfg.num_layers * per_layer


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_from_reference_raises(fault):
    jcfg = ref_get_config("qwen2-0.5b", reduced=True)
    jp, _ = ref_get_api(jcfg).init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    if fault == "missing":
        del tree["blocks"]["attn"]["bq"]
    elif fault == "extra":
        tree["ln_f"]["bias"] = np.zeros_like(tree["ln_f"]["scale"])
    else:
        tree["embed"]["tok"] = tree["embed"]["tok"][:, :-1]
    with pytest.raises(ValueError, match={"missing": "missing",
                                          "extra": "extra",
                                          "shape": "shape"}[fault]):
        params_from_reference(tree, jcfg, device="cpu")


def test_unported_families_raise():
    """Every family serves and trains (``get_api`` gives each its
    prefill, decode and ``forward_train``: (hidden (B, S, d), f32 aux) on
    the CPU).  Mesh sharding is ported now: ``input_specs`` and
    ``elastic_mesh`` are held to their contracts in
    ``test_torch_dist.py``."""
    for arch in ("qwen2-0.5b", "llama4-scout-17b-a16e",
                 "deepseek-v2-lite-16b", "xlstm-350m", "zamba2-7b",
                 "internvl2-76b", "whisper-base"):
        cfg = get_config(arch, reduced=True)
        api = get_api(cfg)
        assert callable(api.prefill) and callable(api.decode_step)
        model = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
        toks = torch.randint(0, cfg.vocab_size, (2, 8))
        inputs = (torch.randn(2, 16, cfg.d_model), toks) if cfg.enc_dec \
            else toks
        hidden, aux = api.forward_train(model, inputs, cfg)
        assert tuple(hidden.shape) == (2, 8, cfg.d_model)
        assert bool(torch.isfinite(hidden).all()) and aux.dim() == 0


# ----------------------------------------------------------------------
# ServeLoop
# ----------------------------------------------------------------------
def _loops(requests, batch=2, gen=6, seed=0, **kw):
    """The reference's and the port's ServeLoop on the same weights and
    prompts (qwen2-0.5b reduced, prompt 8)."""
    jcfg = ref_get_config("qwen2-0.5b", reduced=True)
    (japi, jp), (api, model, cfg) = _both(jcfg, seed=seed)
    ref = RefServeLoop(japi, jcfg, jp, batch=batch, prompt_len=8, gen=gen,
                       seed=seed, **kw)
    port = ServeLoop(api, cfg, model, batch=batch, prompt_len=8, gen=gen,
                     seed=seed, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    for r in range(requests):
        prompt = rng.integers(1, cfg.vocab_size, size=8)
        ref.submit(r, prompt)
        port.submit(r, prompt)
    return ref, port


def test_greedy_tokens_match_reference_with_refills():
    ref, port = _loops(5, batch=2, gen=6)
    ref.start()
    ref.drain()
    port.start()
    port.drain()
    assert port.outputs == ref.outputs
    assert all(len(v) == 6 for v in port.outputs.values())
    assert port.decode_steps == ref.decode_steps
    assert port.prefills == 4           # first wave + 3 refills


def test_metrics_under_concurrent_clients():
    metrics.reset()
    _, loop = _loops(5, batch=2)
    depth = metrics.gauge("serve.queue_depth")
    assert depth.value == 5
    loop.start()
    assert depth.value == 3 and loop.active == 2
    loop.drain()
    assert depth.value == 0 and loop.pending == 0 and depth.max == 5
    snap = metrics.snapshot()
    assert snap["serve.request_latency_s"]["count"] == loop.served >= 4
    assert loop.latencies and min(loop.latencies) > 0
    assert snap["serve.tokens"]["value"] == sum(
        len(v) for v in loop.outputs.values())
    res = loop.result()
    assert res["tokens_per_s"] > 0 and res["latency_s"]["count"] == 5


def test_cancellation_mid_batch():
    metrics.reset()
    _, loop = _loops(4, batch=2, gen=6)
    assert loop.cancel(3)            # still queued: dropped outright
    loop.start()
    assert loop.step()
    assert loop.cancel(0)            # mid-batch: slot frees next step
    assert not loop.cancel(99)
    loop.drain()
    assert len(loop.outputs[0]) < 6
    assert len(loop.outputs[3]) == 0
    assert len(loop.outputs[1]) == len(loop.outputs[2]) == 6
    assert loop.served == 2
    assert metrics.snapshot()["serve.request_latency_s"]["count"] == 2
    assert not loop.cancel(1)        # already finished


def test_shutdown_drains_in_flight():
    _, loop = _loops(6, batch=2, gen=6)
    loop.start()
    assert loop.step()
    loop.shutdown(drain=True)
    assert loop.served == 2 and loop.active == 0
    assert len(loop.outputs[0]) == len(loop.outputs[1]) == 6
    assert loop.pending == 4
    assert all(len(loop.outputs[r]) == 0 for r in range(2, 6))
    with pytest.raises(RuntimeError):
        loop.submit(7, np.ones(8, np.int32))


def test_shutdown_abandons_without_drain():
    _, loop = _loops(3, batch=2, gen=6)
    loop.start()
    assert loop.step()
    loop.shutdown(drain=False)
    assert loop.active == 0 and loop.served == 0
    assert not loop.step()
    assert all(len(v) <= 1 for v in loop.outputs.values())


def test_temperature_sampling_same_seed_same_outputs():
    runs = []
    for _ in range(2):
        _, loop = _loops(3, batch=2, gen=5, seed=7, temperature=0.9)
        loop.start()
        loop.drain()
        runs.append(loop.outputs)
    assert runs[0] == runs[1]
    assert all(len(v) == 5 for v in runs[0].values())


def test_device_none_needs_cuda(monkeypatch):
    """The device rule: no device means the CUDA card, and without one
    the loop raises (it never falls back to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b", reduced=True)
    api = get_api(cfg)
    model = api.init(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        ServeLoop(api, cfg, model, batch=2, prompt_len=8, gen=4)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        api.init(cfg, torch.Generator().manual_seed(0), None)


def test_main_runs_reduced_on_cpu(capsys):
    res = serve.main(["--arch", "qwen2-0.5b", "--reduced", "--device",
                      "cpu", "--requests", "3", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4"])
    assert sorted(res["outputs"]) == [0, 1, 2]
    assert all(len(v) == 4 for v in res["outputs"].values())
    assert "[serve] qwen2-0.5b-reduced on cpu" in capsys.readouterr().out
