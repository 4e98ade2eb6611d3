"""The port's AdamW against the JAX package's.

``adamw_update`` on one set of leaves (f32 and bf16, 2-D and 1-D) from
one nonzero state, with the global-norm clip active and inactive: the
f32 parameters and both moments within 1e-6 of each leaf's largest
magnitude, the bf16 parameters within one bf16 step of the reference's,
the grad norm within 1e-6; 1-D leaves get no decay.  ``zero1_specs``
gives the reference's specs for every parameter of two models at four
data-axis sizes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.launch.steps import abstract_params as ref_abstract_params  # noqa: E402
from repro.optim import AdamWState as RefState  # noqa: E402
from repro.optim import adamw_update as ref_adamw_update  # noqa: E402
from repro.optim import zero1_specs as ref_zero1_specs  # noqa: E402
from repro_torch.launch.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.optim import (AdamWState, adamw_init,  # noqa: E402
                               adamw_update, zero1_specs)

SHAPES = {"w": ((8, 16), "float32"), "b": ((16,), "float32"),
          "e": ((4, 8), "bfloat16"), "s": ((8,), "bfloat16"),
          "k": ((2, 3, 4), "float32")}


def _leaves(rng, grad_scale):
    params, grads, mu, nu = {}, {}, {}, {}
    for name, (shape, dtype) in SHAPES.items():
        params[name] = rng.normal(size=shape).astype(np.float32)
        grads[name] = (grad_scale * rng.normal(size=shape)).astype(np.float32)
        mu[name] = (0.1 * rng.normal(size=shape)).astype(np.float32)
        nu[name] = (0.01 * rng.random(size=shape)).astype(np.float32)
    return params, grads, mu, nu


def _ref(params, grads, mu, nu, step, lr):
    jp = {n: jnp.asarray(v, SHAPES[n][1]) for n, v in params.items()}
    new, state, gnorm = ref_adamw_update(
        {n: jnp.asarray(v) for n, v in grads.items()},
        RefState(mu=dict(mu), nu=dict(nu), step=jnp.asarray(step, jnp.int32)),
        jp, lr=lr)
    return new, state, gnorm


def _port(params, grads, mu, nu, step, lr):
    tp = {n: torch.nn.Parameter(torch.from_numpy(v.copy()).to(
        getattr(torch, SHAPES[n][1]))) for n, v in params.items()}
    state = AdamWState(mu={n: torch.from_numpy(v.copy()) for n, v in mu.items()},
                       nu={n: torch.from_numpy(v.copy()) for n, v in nu.items()},
                       step=torch.tensor(step, dtype=torch.int32))
    gnorm = adamw_update({n: torch.from_numpy(v) for n, v in grads.items()},
                         state, tp, lr=lr)
    return tp, state, gnorm


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.detach().float().numpy() - want).max()
                 / max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("grad_scale,clipped", [(1.0, True), (0.01, False)])
def test_adamw_update_matches_reference(grad_scale, clipped):
    rng = np.random.default_rng(0)
    params, grads, mu, nu = _leaves(rng, grad_scale)
    lr, step = 3e-3, 4
    jnew, jstate, jnorm = _ref(params, grads, mu, nu, step, lr)
    tnew, tstate, tnorm = _port(params, grads, mu, nu, step, lr)
    assert (float(jnorm) > 1.0) == clipped
    assert abs(float(tnorm) - float(jnorm)) <= 1e-6 * float(jnorm)
    assert int(tstate.step) == int(jstate.step) == step + 1
    for name, (_, dtype) in SHAPES.items():
        got, want = tnew[name], np.asarray(jnew[name], np.float32)
        assert got.dtype == getattr(torch, dtype)
        if dtype == "bfloat16":     # at most one bf16 step apart
            assert (np.abs(got.float().detach().numpy() - want)
                    <= 2.0 ** -7 * np.abs(want)).all(), name
        else:
            assert _rel(got, want) <= 1e-6, name
        assert _rel(tstate.mu[name], jstate.mu[name]) <= 1e-6, name
        assert _rel(tstate.nu[name], jstate.nu[name]) <= 1e-6, name


def test_one_dim_leaves_get_no_decay():
    """With zero gradients and moments the update is the decay alone:
    p (1 - lr wd) for ``ndim >= 2``, unchanged for 1-D leaves, as in the
    reference."""
    rng = np.random.default_rng(1)
    params, _, _, _ = _leaves(rng, 1.0)
    zeros = {n: np.zeros_like(v) for n, v in params.items()}
    lr = 0.1                        # a decay of 1%, above bf16's step
    jnew, _, _ = _ref(params, zeros, zeros, zeros, 0, lr)
    tnew, _, tnorm = _port(params, zeros, zeros, zeros, 0, lr)
    assert float(tnorm) == 0.0
    for name, (shape, dtype) in SHAPES.items():
        start = torch.from_numpy(params[name]).to(getattr(torch, dtype))
        if len(shape) == 1:
            assert torch.equal(tnew[name].detach(), start), name
        else:
            assert not torch.equal(tnew[name].detach(), start), name
        np.testing.assert_allclose(tnew[name].detach().float().numpy(),
                                   np.asarray(jnew[name], np.float32),
                                   rtol=1e-6)


def test_missing_gradient_counts_as_zero():
    model = torch.nn.Linear(4, 3)
    state = adamw_init(model)
    params = dict(model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    adamw_update({"weight": None}, state, params, lr=0.1)
    assert torch.allclose(params["weight"].detach(),
                          before["weight"] * (1 - 0.1 * 0.1))
    assert torch.equal(params["bias"].detach(), before["bias"])
    assert int(state.step) == 1


def _by_path(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in flat}


def _port_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_by_path(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "deepseek-v2-lite-16b"])
def test_zero1_specs_match_reference(arch):
    shapes, specs = ref_abstract_params(ref_get_config(arch, reduced=True))
    is_spec = lambda x: isinstance(x, JP)  # noqa: E731
    port_specs = jax.tree.map(lambda s: P(*s), specs, is_leaf=is_spec)
    port_shapes = jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta"), shapes)
    for size in (1, 2, 4, 16):
        want = _by_path(ref_zero1_specs(specs, shapes, data_size=size),
                        is_leaf=is_spec)
        got = _port_by_path(zero1_specs(port_specs, port_shapes,
                                        data_size=size))
        assert got.keys() == want.keys()
        for key, spec in got.items():
            assert isinstance(spec, P)
            assert tuple(spec) == tuple(want[key]), (size, key)
