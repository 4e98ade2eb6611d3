"""The port's cost count (``launch/costanalysis.py``) against the JAX
package's ``launch/hloanalysis.analyze`` of the reference's compiled
single-device step.

Each reduced configuration's train step (batch 8 x seq 64), prefill
(batch 8 x 64, S_max 192) and decode step (batch 8, cache 128): the
reference is lowered and compiled by ``jax.jit`` on the CPU and its HLO
analysed; the port runs the same step once on the CPU under
``CostMode`` at world size 1, with random weights (the counts depend on
the shapes only).

* qwen2-0.5b, qwen3-4b and stablelm-1.6b: the dot FLOPs of all three
  steps are equal, and the dot bytes of the train step.
* deepseek-v2-lite-16b, llama4-scout-17b-a16e, xlstm-350m and
  command-r-35b: the dot FLOPs within 3% (measured gaps below).  The
  train-step gap of command-r (+2^25 FLOPs, +2.03%), deepseek (+2^25,
  +1.73%) and llama4 (+2^26, +2.77%) is the forward attention products
  of both layers (2 x B x H x S^2 x D x 2 = 2^25 at B 8, S 64, 8 x 16
  heads): the reference's compiled step does not replay them in the
  rematerialized forward for these blocks (a parallel block, MoE
  layers), while ``torch.utils.checkpoint`` always replays the whole
  block; xlstm's -0.04% is in its recurrent products.
* The prefill and decode dot bytes are recorded, not asserted: the
  reference's byte proxy reads the HLO after XLA's CPU lowering and
  skips an operand its symbol table cannot resolve
  (``hloanalysis.py:133-140``), so only the train step's bytes are a
  fair check (prefill +7% to +11%, decode -49% to 0%).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.hloanalysis import analyze as ref_analyze  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.costanalysis import analyze  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402

B, S, S_MAX, S_CACHE = 8, 64, 192, 128
EXACT = ("qwen2-0.5b", "qwen3-4b", "stablelm-1.6b")
#: (arch, step) -> the port's dot-FLOP gap to the reference, measured
GAPS = {("deepseek-v2-lite-16b", "train"): 2 ** 25,
        ("llama4-scout-17b-a16e", "train"): 2 ** 26,
        ("command-r-35b", "train"): 2 ** 25,
        ("xlstm-350m", "train"): -262144}


def _reference(arch, kind):
    cfg = ref_get_config(arch, reduced=True)
    params, _ = ref_steps.abstract_params(cfg)
    sds = jax.ShapeDtypeStruct
    if kind == "train":
        batch = {k: sds((B, S), jnp.int32) for k in ("tokens", "targets")}
        lowered = jax.jit(ref_steps.make_train_step(cfg)).lower(
            params, jax.eval_shape(ref_adamw_init, params), batch)
    elif kind == "prefill":
        lowered = jax.jit(ref_steps.make_prefill_step(cfg, S_MAX)).lower(
            params, {"tokens": sds((B, S), jnp.int32)})
    else:
        cache, _ = ref_steps.abstract_cache(cfg, B, S_CACHE)
        lowered = jax.jit(ref_steps.make_decode_step(cfg)).lower(
            params, cache, sds((B, 1), jnp.int32), sds((), jnp.int32))
    return ref_analyze(lowered.compile().as_text())


def _port(arch, kind):
    cfg = get_config(arch, reduced=True)
    model = get_api(cfg).init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)

    def tokens(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                .astype(np.int32))

    if kind == "train":
        return analyze(steps.make_train_step(cfg), model, adamw_init(model),
                       {"tokens": tokens(B, S), "targets": tokens(B, S)})[1]
    if kind == "prefill":
        return analyze(steps.make_prefill_step(cfg, S_MAX), model,
                       {"tokens": tokens(B, S)})[1]
    cache = torch.utils._pytree.tree_map(
        lambda t: torch.zeros(t.shape, dtype=t.dtype),
        steps.abstract_cache(cfg, B, S_CACHE)[0])
    return analyze(steps.make_decode_step(cfg), model, cache, tokens(B, 1),
                   0)[1]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", [*EXACT, "deepseek-v2-lite-16b",
                                  "llama4-scout-17b-a16e", "xlstm-350m",
                                  "command-r-35b"])
def test_world1_count_equals_reference(arch, kind):
    want, got = _reference(arch, kind), _port(arch, kind)
    assert got.total_collective_bytes == 0 and got.collective_count == 0
    assert got.dot_flops > 0 and got.dot_bytes > 0
    if arch in EXACT:
        assert got.dot_flops == want.dot_flops
        if kind == "train":
            assert got.dot_bytes == want.dot_bytes
        return
    assert abs(got.dot_flops - want.dot_flops) <= 0.03 * want.dot_flops
    assert got.dot_flops - want.dot_flops == GAPS.get((arch, kind), 0)


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_slstm_counts_one_step_s_times(kind):
    """On the meta device the sLSTM runs one step and the count takes it
    and its gradient S times (``ssm._CountedSteps``): xlstm's prefill
    and train step of S 64 count on meta exactly what the stepped loop
    counts on the CPU."""
    from repro_torch.launch.dryrun import world1_costs
    cfg = get_config("xlstm-350m", reduced=True)
    meta = world1_costs(cfg, steps.ShapeSpec(f"{kind}_64", kind, S, B))
    stepped = _port("xlstm-350m", kind)
    assert meta.dot_flops == stepped.dot_flops > 0
    assert meta.dot_bytes == stepped.dot_bytes
    assert dict(meta.by_op) == dict(stepped.by_op)


def _meta_peak(monkeypatch, fn, once: bool) -> int:
    """``fn()``'s peak temporary bytes under ``CostMode`` on the meta
    device, the sLSTM run one step for S (``once``) or stepped."""
    from repro_torch.launch.costanalysis import CostMode
    from repro_torch.launch.sharding import ShardedExecution
    from repro_torch.models import ssm
    monkeypatch.setattr(ssm, "STEP_ONCE_ON_META", once)
    with CostMode(track_memory=True) as cm, ShardedExecution():
        fn(cm)
    return cm.costs.peak_temp_bytes


@pytest.mark.parametrize("scope", ["step", "slstm"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_meta_slstm_memory_follows_the_stepped_loop(monkeypatch, kind,
                                                    scope):
    """The memory count of the one-step sLSTM on meta against the
    stepped loop on meta at S 64, for xlstm's whole step and for the
    sLSTM alone (where it sets the peak): equal without autograd; with
    it (the backward), within 15%: the stepped backward's per-position
    full-size gradients of ``pre`` are not built."""
    from repro_torch.launch import dryrun
    from repro_torch.models import ssm
    cfg = get_config("xlstm-350m", reduced=True)
    train = kind == "train"
    if scope == "step":
        shape = steps.ShapeSpec(f"{kind}_64", kind, S, B)

        def fn(cm):
            model, _ = steps.abstract_params(cfg)
            inputs = {"params": model,
                      "batch": steps.abstract_batch(cfg, shape)[0]}
            if train:
                inputs["opt_state"] = adamw_init(model)
            step, args = dryrun._step(cfg, shape, "full", inputs)
            step(*args)
    else:
        def fn(cm):
            p = ssm.init_slstm(cfg, torch.Generator().manual_seed(0),
                               device="meta")
            p = {k: v.requires_grad_(train)
                 for k, v in p._parameters.items()}
            x = torch.empty((B, S, cfg.d_model), device="meta",
                            requires_grad=train)
            cm.exclude([x, *p.values()])
            with torch.set_grad_enabled(train):
                y, _ = ssm.slstm_fwd(p, x, cfg)
                if train:
                    y.sum().backward()
    once = _meta_peak(monkeypatch, fn, True)
    stepped = _meta_peak(monkeypatch, fn, False)
    assert stepped > 0
    if train:
        assert abs(once - stepped) <= 0.15 * stepped
    else:
        assert once == stepped
