"""The port's training path against the JAX package's: MoE with GQA and
with MLA, xLSTM, the Mamba2 hybrid, the vlm prefix and the
encoder-decoder.

As ``test_torch_train.py``, for llama4-scout, deepseek-v2-lite, xlstm,
zamba2 (one super-block), internvl2 (256 patch embeddings before 32
tokens, the loss on the text positions only) and whisper (frames and
decoder tokens) in f32 at depth 2: loss within 1e-5 relative, every gradient
within 1e-4 of its leaf's largest magnitude (measured worst: 1.4e-7 on
the loss, 2.3e-5 on a gradient, zamba2's ``dt_bias``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.steps import VLM_PATCHES, make_loss_fn  # noqa: E402
from repro_torch.models import lm_loss_from_hidden  # noqa: E402
from repro_torch.models.transformer import lm_forward_train  # noqa: E402
from torch_train_check import (batch, both,  # noqa: E402, F401
                               check_loss_and_grads, one_thread)

FAMILIES = ["llama4-scout-17b-a16e", "deepseek-v2-lite-16b", "xlstm-350m",
            "zamba2-7b", "internvl2-76b", "whisper-base"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


def _tensors(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def test_vlm_loss_reads_the_text_positions_only():
    _, (cfg, model) = both("internvl2-76b")
    nb = _tensors(batch(cfg, np.random.default_rng(7), S=16))
    with torch.no_grad():
        hidden, aux = lm_forward_train(model, nb["tokens"], cfg,
                                       prefix_embeds=nb["patches"])
        assert tuple(hidden.shape) == (2, VLM_PATCHES + 16, cfg.d_model)
        want = lm_loss_from_hidden(model, hidden[:, VLM_PATCHES:],
                                   nb["targets"], cfg) + 0.01 * aux
        assert float(make_loss_fn(cfg)(model, nb)) == float(want)
    # the patches are inputs too: the loss has a gradient for them
    nb["patches"].requires_grad_(True)
    make_loss_fn(cfg)(model, nb).backward()
    assert float(nb["patches"].grad.abs().max()) > 0


def test_whisper_gradient_reaches_the_encoder_and_frames():
    _, (cfg, model) = both("whisper-base")
    nb = _tensors(batch(cfg, np.random.default_rng(8), S=12, frames=24))
    nb["frames"].requires_grad_(True)
    model.requires_grad_(True)
    loss = make_loss_fn(cfg)(model, nb)
    loss.backward()
    assert float(nb["frames"].grad.abs().max()) > 0
    for name, p in model.named_parameters():
        if name.startswith(("enc.", "ln_enc.")):
            assert float(p.grad.abs().max()) > 0, name

