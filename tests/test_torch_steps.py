"""The port's ``launch/steps.py`` against the JAX package's: the abstract
parameters, caches and batches on the meta device have the reference's
shapes, dtypes and specs for every family kind (dense, MLA, xLSTM, the
hybrid, the vlm prefix, enc-dec), and the prefill and decode step
builders route each kind as the model API does."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_reference  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.steps import (VLM_PATCHES,  # noqa: E402
                                      make_decode_step, make_prefill_step)
from repro_torch.models import get_api  # noqa: E402
from repro_torch.models.transformer import lm_prefill  # noqa: E402
from torch_train_check import batch, both, one_thread  # noqa: E402, F401


def _tensors(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b",
                                  "xlstm-350m", "zamba2-7b",
                                  "internvl2-76b", "whisper-base"])
def test_abstract_shapes_match_reference(arch):
    """``abstract_params``, ``abstract_cache`` and ``abstract_batch`` on
    the meta device: the reference's shapes, dtypes and specs (the
    parameters per layer where the reference stacks them)."""
    jcfg, cfg = ref_get_config(arch, reduced=True), get_config(
        arch, reduced=True)
    shapes, _ = ref_steps.abstract_params(jcfg)
    want = params_from_reference(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes), cfg,
        device="cpu").state_dict()
    got = steps.abstract_params(cfg)[0].state_dict()
    assert got.keys() == want.keys()
    for name, t in got.items():
        assert t.device.type == "meta" and t.shape == want[name].shape
        assert t.dtype == want[name].dtype, name

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [x for t in tree for x in leaves(t)]

    is_spec = lambda x: isinstance(x, JP)  # noqa: E731
    c_shapes, c_specs = ref_steps.abstract_cache(jcfg, 2, 16)
    t_shapes, t_specs = steps.abstract_cache(cfg, 2, 16)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in leaves(t_shapes)] == [
        (s.shape, s.dtype.name) for s in jax.tree.leaves(c_shapes)]
    assert all(t.device.type == "meta" for t in leaves(t_shapes))
    assert [tuple(p) for p in jax.tree.leaves(t_specs, is_leaf=is_spec)] \
        == [tuple(p) for p in jax.tree.leaves(c_specs, is_leaf=is_spec)]
    for name, shape in steps.SHAPES.items():
        if name == "long_500k":
            continue
        cell = ref_steps.SHAPES[name]
        jb, jspec = ref_steps.abstract_batch(jcfg, cell)
        tb, tspec = steps.abstract_batch(cfg, shape)
        assert tb.keys() == jb.keys()
        for k, t in tb.items():
            assert t.device.type == "meta"
            assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == (
                jb[k].shape, jb[k].dtype.name), (name, k)
            assert tuple(tspec[k]) == tuple(jspec[k])
    assert steps.cell_applicable(cfg, steps.SHAPES["long_500k"])[0] == \
        ref_steps.cell_applicable(jcfg, ref_steps.SHAPES["long_500k"])[0]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "internvl2-76b",
                                  "whisper-base"])
def test_step_builders_route_like_the_api(arch):
    """``make_prefill_step`` and ``make_decode_step`` give the model API's
    prefill (the vlm's with its patches, whisper's with its frames) and
    decode step."""
    _, (cfg, model) = both(arch)
    nb = _tensors(batch(cfg, np.random.default_rng(9), S=8, frames=16))
    api = get_api(cfg)
    start = 8 + (VLM_PATCHES if cfg.frontend == "vision_stub" else 0)
    logits, cache = make_prefill_step(cfg, start + 4)(model, nb)
    if cfg.enc_dec:
        want, _ = api.prefill(model, (nb["frames"], nb["dec_tokens"]), cfg,
                              start + 4)
    elif cfg.frontend == "vision_stub":
        want, _ = lm_prefill(model, nb["tokens"], cfg, start + 4,
                             prefix_embeds=nb["patches"])
    else:
        want, _ = api.prefill(model, nb["tokens"], cfg, start + 4)
    assert torch.equal(logits, want)
    token = torch.ones((2, 1), dtype=torch.int32)
    got, _ = make_decode_step(cfg)(model, cache, token, start)
    assert tuple(got.shape) == (2, 1, cfg.vocab_size)
