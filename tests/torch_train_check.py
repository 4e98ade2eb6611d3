"""Shared checks of the port's training path against the JAX package's
(imported by ``test_torch_train*.py``; pytest does not collect it).

The JAX weights of a reduced configuration cross with
``interop.params_from_reference``; one numpy batch, made from a seed,
goes through ``jax.value_and_grad`` of the reference's ``make_loss_fn``
and through the port's loss and ``loss.backward()``.  The reference's
gradients cross the same way, so each is compared under the port's
parameter name.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.steps import VLM_PATCHES
from repro.launch.steps import make_loss_fn as ref_make_loss_fn
from repro.models import get_api as ref_get_api
from repro_torch.interop import from_reference, params_from_reference
from repro_torch.launch.steps import make_loss_fn

#: the loss, relative: f32 sums in another order
LOSS_TOL = 1e-5
#: each gradient, relative to its leaf's largest magnitude
GRAD_TOL = 1e-4
#: a key bias adds the same amount to every score of a query, which the
#: softmax ignores: its gradient is zero but for rounding, and Adam scales
#: that noise up to steps of about lr.  After a step its values are held
#: to 1e-3 of lr (absolute), not to their own magnitude.
NOISE_LEAF = "attn.bk"


def check_param(name: str, got, want, lr: float) -> None:
    """One parameter after training steps against the reference's."""
    if name.endswith(NOISE_LEAF):
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
        assert np.abs(got - np.asarray(want)).max() <= 1e-3 * lr, name
    else:
        assert rel(got, want) <= GRAD_TOL, name


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one CPU thread for the test: the suite runs several
    workers at once, and one thread per core in each of them
    oversubscribes the cores (the train CLI's 25 tiny steps took 75 s
    that way, 1 s alone).  Import it into a test module to apply it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def reference(arch: str, seed: int = 0):
    """(reference cfg at depth 2, its params) for ``arch``'s reduced
    configuration (zamba2: one super-block of its period, 2)."""
    jcfg = ref_get_config(arch, reduced=True)
    jcfg = dataclasses.replace(jcfg, num_layers=2,
                               enc_layers=2 if jcfg.enc_dec else 0)
    jparams, _ = ref_get_api(jcfg).init(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams


def both(arch: str, seed: int = 0):
    """((reference cfg, params), (port cfg, model)) on the same
    weights."""
    jcfg, jp = reference(arch, seed)
    cfg = from_reference(jcfg)
    return (jcfg, jp), (cfg, params_from_reference(
        jax.tree.map(np.asarray, jp), cfg, device="cpu"))


def batch(cfg, rng, B: int = 2, S: int = 32, frames: int = 16) -> dict:
    """A numpy training batch of ``cfg``'s kind: tokens and targets (vlm:
    also ``VLM_PATCHES`` patch embeddings; whisper: frames, decoder
    tokens and targets)."""
    def toks():
        return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    out = {"targets": toks()}
    if cfg.enc_dec:
        out["frames"] = rng.normal(size=(B, frames, cfg.d_model)).astype(
            np.float32)
        out["dec_tokens"] = toks()
    else:
        out["tokens"] = toks()
        if cfg.frontend == "vision_stub":
            out["patches"] = 0.02 * rng.normal(
                size=(B, VLM_PATCHES, cfg.d_model)).astype(np.float32)
    return out


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


def port_grads(model, cfg, np_batch, remat_policy="full") -> tuple:
    """(loss, {name: gradient}) of the port's ``make_loss_fn``."""
    model.requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    loss = make_loss_fn(cfg, remat_policy)(
        model, {k: torch.from_numpy(v) for k, v in np_batch.items()})
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def ref_grads(jcfg, jp, np_batch) -> tuple:
    """(loss, gradient tree as numpy) of the JAX package's
    ``make_loss_fn`` under ``jax.value_and_grad``."""
    loss, g = jax.jit(jax.value_and_grad(ref_make_loss_fn(jcfg)))(
        jp, {k: jnp.asarray(v) for k, v in np_batch.items()})
    return float(loss), jax.tree.map(np.asarray, g)


def check_loss_and_grads(arch: str, seed: int = 0, **batch_kw) -> dict:
    """The port's loss and every gradient against the JAX package's;
    returns the worst relative errors (asserting the bounds)."""
    (jcfg, jp), (cfg, model) = both(arch, seed)
    nb = batch(cfg, np.random.default_rng(seed + 1), **batch_kw)
    want_loss, want = ref_grads(jcfg, jp, nb)
    loss, grads = port_grads(model, cfg, nb)
    want = params_from_reference(want, cfg, device="cpu").state_dict()
    assert grads.keys() == want.keys()
    missing = [n for n, g in grads.items() if g is None]
    assert not missing, f"no gradient reaches {missing}"
    errs = {n: rel(g, want[n]) for n, g in grads.items()}
    worst = max(errs, key=errs.get)
    loss_err = abs(loss - want_loss) / abs(want_loss)
    assert loss_err <= LOSS_TOL, (loss, want_loss)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    return {"loss_rel": loss_err, "grad_rel": errs[worst], "worst": worst}


def port_layout(tree, cfg) -> dict:
    """A reference tree (numpy; parameters, gradients or moments) as
    numpy arrays under the port's parameter names (stacked groups split
    per layer)."""
    return {k: v.numpy() for k, v in params_from_reference(
        tree, cfg, device="cpu").state_dict().items()}


def reference_layout(flat: dict, like, prefix: str = "") -> dict:
    """The inverse of :func:`port_layout`: per-layer arrays stacked back
    into the reference tree ``like``'s structure."""
    out = {}
    for key, val in like.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out[key] = reference_layout(flat, val, path + ".")
        elif path in flat:
            out[key] = flat[path]
        else:
            group, rest = path.split(".", 1)
            out[key] = np.stack([flat[f"{group}.{i}.{rest}"]
                                 for i in range(len(val))])
    return out


def reference_train_step(jcfg, cfg, like, state, np_batch, lr: float):
    """One training step of the JAX package's arithmetic on the port's
    per-layer layout: the gradient of the reference's ``make_loss_fn``
    (on the parameters stacked back), then the reference's
    ``adamw_update`` over per-layer leaves.  ``state`` is (params, mu,
    nu, step) in :func:`port_layout`; returns the next state, the loss
    and the grad norm."""
    from repro.optim import AdamWState as RefState
    from repro.optim import adamw_update as ref_adamw_update
    params, mu, nu, step = state
    loss, g = ref_grads(jcfg, reference_layout(params, like), np_batch)
    new, opt, gnorm = ref_adamw_update(
        port_layout(g, cfg), RefState(mu, nu, jnp.asarray(step, jnp.int32)),
        params, lr=lr)
    as_np = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return ((as_np(new), as_np(opt.mu), as_np(opt.nu), int(opt.step)),
            loss, float(gnorm))
