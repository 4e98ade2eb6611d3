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
