"""The port's training path against the JAX package's: the dense
families, the train step and the remat policies.

For each dense reduced configuration in f32 at depth 2 (command-r,
qwen2, qwen3, stablelm) the JAX weights cross with
``interop.params_from_reference`` and one numpy batch goes through both
packages' ``make_loss_fn``: the loss agrees to 1e-5 relative and every
gradient to 1e-4 of its leaf's largest magnitude (measured worst: 7.6e-8
on the loss, 2.5e-6 on a gradient, qwen2's ``bq``).  Two
``make_train_step``s taken from one state (the reference's after one
step, carried across with ``opt_state_from_reference``) leave the
parameters and both moments within the same bounds of the reference's
gradient and ``adamw_update`` on the port's per-layer layout (the key
biases, whose gradient is rounding noise, to 1e-3 of lr).  The
reference's own step differs from it only by the weight decay it puts
on its layer-stacked norms and biases, a fault of the reference.  The
remat policies ``"full"``, ``"dots"`` and None give the same gradients.
The other families are in ``test_torch_train_families.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro_torch.interop import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.transformer import REMAT_POLICIES  # noqa: E402
from torch_train_check import (GRAD_TOL, batch, both,  # noqa: E402, F401
                               check_loss_and_grads, check_param,
                               one_thread, port_grads, port_layout,
                               reference_train_step, rel)

FAMILIES = ["command-r-35b", "qwen2-0.5b", "qwen3-4b", "stablelm-1.6b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama4-scout-17b-a16e"])
def test_train_steps_match_reference(arch):
    """Two steps of the port's ``make_train_step`` against the JAX
    package's loss gradient and ``adamw_update`` from one state (the
    reference's after one ``make_train_step``), on the port's per-layer
    layout, where the norms and biases are 1-D and get no decay."""
    (jcfg, jp), (cfg, _) = both(arch)
    rng = np.random.default_rng(3)
    batches = [batch(cfg, rng) for _ in range(3)]
    lr = 1e-3
    jparams, jopt, _ = jax.jit(ref_make_train_step(jcfg, lr=lr))(
        jp, ref_adamw_init(jp),
        {k: jnp.asarray(v) for k, v in batches[0].items()})
    # one state in both packages: the reference's after its first step
    jparams, jopt = jax.tree.map(np.asarray, (jparams, jopt))
    model = params_from_reference(jparams, cfg, device="cpu")
    opt = opt_state_from_reference(jopt, model, cfg, device="cpu")
    assert int(opt.step) == 1
    state = (port_layout(jparams, cfg), port_layout(jopt.mu, cfg),
             port_layout(jopt.nu, cfg), 1)
    step = make_train_step(cfg, lr=lr)
    for nb in batches[1:]:
        state, loss, gnorm = reference_train_step(jcfg, cfg, jp, state, nb,
                                                  lr)
        model, opt, m = step(model, opt,
                             {k: torch.from_numpy(v) for k, v in nb.items()})
        assert rel(m["loss"], loss) <= 1e-5
        assert rel(m["grad_norm"], gnorm) <= GRAD_TOL
    assert int(opt.step) == state[3] == 3
    params = dict(model.named_parameters())
    assert params.keys() == state[0].keys()
    for name, p in params.items():
        check_param(name, p, state[0][name], lr)
    for got, want in zip((opt.mu, opt.nu), state[1:3]):
        assert got.keys() == want.keys()
        for name, t in got.items():
            assert rel(t, want[name]) <= GRAD_TOL, name
    assert all(p.grad is None for p in model.parameters())


def test_reference_step_decays_the_stacked_norms():
    """The JAX package's ``make_train_step`` decays its layer-stacked
    norm scales and biases ((L, d): ``ndim >= 2``) but not ``ln_f``; the
    port's per-layer ones are 1-D and do not decay.  One step from one
    state (the reference's after a first step) differs by exactly that
    decay, lr x 0.1 x p (ROADMAP Queue 3)."""
    (jcfg, jp), (cfg, _) = both("qwen2-0.5b")
    rng = np.random.default_rng(4)
    b0, b1 = batch(cfg, rng), batch(cfg, rng)
    lr = 1e-3
    jstep = jax.jit(ref_make_train_step(jcfg, lr=lr))
    j1 = jstep(jp, ref_adamw_init(jp),
               {k: jnp.asarray(v) for k, v in b0.items()})[:2]
    j2 = jstep(*j1, {k: jnp.asarray(v) for k, v in b1.items()})[0]
    j1 = jax.tree.map(np.asarray, j1)
    model = params_from_reference(j1[0], cfg, device="cpu")
    opt = opt_state_from_reference(j1[1], model, cfg, device="cpu")
    model, _, _ = make_train_step(cfg, lr=lr)(
        model, opt, {k: torch.from_numpy(v) for k, v in b1.items()})
    before = port_layout(j1[0], cfg)
    want = port_layout(jax.tree.map(np.asarray, j2), cfg)
    stacked_1d = set()
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if p.ndim == 1 and name.startswith("blocks."):
            stacked_1d.add(name)
            got = got - lr * 0.1 * before[name]   # the reference's decay
        check_param(name, got, want[name], lr)
    assert "blocks.0.ln1.scale" in stacked_1d and "ln_f.scale" not in \
        stacked_1d


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "llama4-scout-17b-a16e"])
def test_remat_policies_give_the_same_gradients(arch):
    _, (cfg, model) = both(arch)
    nb = batch(cfg, np.random.default_rng(5))
    runs = {policy: port_grads(model, cfg, nb, remat_policy=policy)
            for policy in [None, *REMAT_POLICIES]}
    loss0, g0 = runs.pop(None)
    for policy, (loss, grads) in runs.items():
        assert loss == loss0, policy
        for name, g in grads.items():
            assert rel(g, g0[name].numpy()) <= 1e-6, (policy, name)
    with pytest.raises(ValueError, match="remat policy"):
        port_grads(model, cfg, nb, remat_policy="everything")
