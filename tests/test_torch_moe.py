"""The port's MoE layer against the JAX package's.

The same numpy weights and inputs go through ``repro.models.layers``'s
``moe_fwd`` and the port's in f32 on the CPU; the output and the
load-balancing loss agree to 1e-5: for both MoE configurations (top-6 of
64 with two shared experts, top-1 of 16 with one), with a router of all
zeros (every probability tied: the lower expert index wins, as
``lax.top_k``), with a capacity that drops tokens, and through an MoE
decoder block.  ``gpu``-marked cases hold the card's ``moe_fwd`` to the
CPU's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = 1e-5
MOE = ["deepseek-v2-lite-16b", "llama4-scout-17b-a16e"]


def _tree(params):
    """The reference's parameter dict as the port's dict of tensors."""
    return {k: _tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in params.items()}


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol


def _case(jcfg, seed, T=(2, 12)):
    jp, _ = JL.init_moe(jcfg, jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).normal(
        size=T + (jcfg.d_model,)).astype(np.float32)
    return jp, _tree(jax.tree.map(np.asarray, jp)), x


def _kept(top_e, E, C):
    """(token, choice) pairs the capacity keeps: min(count, C) per
    expert."""
    counts = np.bincount(np.asarray(top_e).reshape(-1), minlength=E)
    return int(np.minimum(counts, C).sum())


@pytest.mark.parametrize("arch", MOE)
def test_moe_fwd_matches_reference(arch):
    jcfg = ref_get_config(arch, reduced=True)
    jp, tp, x = _case(jcfg, seed=len(arch))
    want, want_aux = JL.moe_fwd(jp, jnp.asarray(x), jcfg)
    got, aux = TL.moe_fwd(tp, torch.from_numpy(x), from_reference(jcfg))
    _close(got, want)
    _close(aux, want_aux)


def test_all_tie_router_keeps_lower_expert_first():
    """A router of zeros ties every expert: both pick experts 0..k-1 for
    every token, and the capacity keeps the first C tokens of each."""
    jcfg = ref_get_config("deepseek-v2-lite-16b", reduced=True)
    jp, _, x = _case(jcfg, seed=3)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = _tree(jax.tree.map(np.asarray, jp))
    want, want_aux = JL.moe_fwd(jp, jnp.asarray(x), jcfg)
    got, aux = TL.moe_fwd(tp, torch.from_numpy(x), from_reference(jcfg))
    _close(got, want)
    _close(aux, want_aux)
    probs = torch.full((5, 8), 0.125)
    _, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(
        top_e[:, :3].numpy(), np.asarray(jax.lax.top_k(
            jnp.full((5, 8), 0.125), 3)[1]))


def test_capacity_drops_tokens():
    """At capacity factor 0.5 fewer (token, choice) pairs are kept than
    routed; the dropped ones add nothing, in both packages alike."""
    jcfg = ref_get_config("deepseek-v2-lite-16b", reduced=True)
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=0.5))
    jp, tp, x = _case(jcfg, seed=5, T=(2, 16))
    m = jcfg.moe
    T = x.shape[0] * x.shape[1]
    C = int(np.ceil(T * m.top_k / m.num_experts * m.capacity_factor))
    probs = jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jp["router"])
    top_e = jax.lax.top_k(probs, m.top_k)[1]
    assert _kept(top_e, m.num_experts, C) < T * m.top_k
    want, want_aux = JL.moe_fwd(jp, jnp.asarray(x), jcfg)
    got, aux = TL.moe_fwd(tp, torch.from_numpy(x), from_reference(jcfg))
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", MOE)
def test_moe_block_returns_aux(arch):
    """An MoE decoder block (GQA or MLA attention) in prefill: the output,
    the cache and the auxiliary loss, as the reference's."""
    jcfg = ref_get_config(arch, reduced=True)
    cfg = from_reference(jcfg)
    jp, _ = JT.init_block(jcfg, jax.random.PRNGKey(7))
    tp = _tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 10, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10), (2, 10)).astype(np.int32)
    jx, jc, jaux = JT.block_fwd(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                mode="prefill")
    tx, tc, aux = TT.block_fwd(tp, torch.from_numpy(x), cfg,
                               torch.from_numpy(pos), mode="prefill")
    _close(tx, jx)
    for t, j in zip(tc, jc):
        _close(t, j)
    _close(aux, jaux)


def test_port_init_moe_shapes():
    jcfg = ref_get_config("deepseek-v2-lite-16b", reduced=True)
    tp = TL.init_moe(from_reference(jcfg), torch.Generator().manual_seed(0),
                     device="cpu")
    jp, _ = JL.init_moe(jcfg, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == {
        ".".join(str(p.key) for p in path): tuple(v.shape)
        for path, v in jax.tree_util.tree_leaves_with_path(jp)}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE)
def test_card_moe_matches_cpu(arch):
    """On the card: ``moe_fwd`` in f32 against the CPU's on the same
    weights, to 1e-5 of the largest magnitude (the card's scatter-add
    sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    jcfg = ref_get_config(arch, reduced=True)
    _, tp, x = _case(jcfg, seed=11, T=(4, 64))
    cfg = from_reference(jcfg)
    want, want_aux = TL.moe_fwd(tp, torch.from_numpy(x), cfg)
    card = _to(tp, "cuda")
    got, aux = TL.moe_fwd(card, torch.from_numpy(x).cuda(), cfg)
    _close(got, want.numpy())
    _close(aux, want_aux.numpy())
