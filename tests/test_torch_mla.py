"""The port's MLA (DeepSeek-V2's compressed-KV attention) against the JAX
package's.

The same numpy weights and inputs go through ``repro.models.layers``'s
``mla_fwd`` and the port's in f32 on the CPU, to 1e-5: a prefill (the
output and its (c_kv, k_rope)), then decode steps into an S_max cache at
per-slot positions and at one scalar position; the port writes the cache
in place.  The MLA branch of ``lm_init_cache`` has the reference's
shapes.  A ``gpu``-marked case holds the card's ``mla_fwd`` to the
CPU's.
"""
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
ARCH = "deepseek-v2-lite-16b"


def _tree(params):
    return {k: _tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in params.items()}


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().cpu().numpy()
    assert float(np.abs(got - want).max()) <= tol * float(
        np.abs(want).max())


def _case(seed=0, B=2, S=10):
    jcfg = ref_get_config(ARCH, reduced=True)
    jp, _ = JL.init_mla(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    return jcfg, from_reference(jcfg), jp, _tree(
        jax.tree.map(np.asarray, jp)), x, pos


def test_mla_prefill_matches_reference():
    jcfg, cfg, jp, tp, x, pos = _case(seed=1)
    jo, (jc, jr) = JL.mla_fwd(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    to, (tc, tr) = TL.mla_fwd(tp, torch.from_numpy(x), cfg,
                              torch.from_numpy(pos))
    assert tuple(tc.shape) == (2, 10, cfg.mla.kv_lora_rank)
    assert tuple(tr.shape) == (2, 10, cfg.mla.qk_rope_head_dim)
    _close(to, jo)
    _close(tc, jc)
    _close(tr, jr)


def test_mla_decode_at_per_slot_positions():
    """Decode into a cache of S_max, each slot at its own position, then a
    scalar position for every slot; (c_kv, k_rope) written in place."""
    jcfg, cfg, jp, tp, x, pos = _case(seed=2)
    B, S, S_max = 2, 10, 16
    _, (jc, jr) = JL.mla_fwd(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    _, (tc, tr) = TL.mla_fwd(tp, torch.from_numpy(x), cfg,
                             torch.from_numpy(pos))
    jcache = tuple(jnp.zeros((B, S_max) + a.shape[2:]).at[:, :S].set(a)
                   for a in (jc, jr))
    tcache = tuple(torch.zeros((B, S_max) + tuple(a.shape[2:]))
                   for a in (tc, tr))
    tcache[0][:, :S], tcache[1][:, :S] = tc, tr
    rng = np.random.default_rng(3)
    slot_pos = np.array([S, S - 3], np.int32)
    for step in range(3):
        y = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
        jo, jcache = JL.mla_fwd(jp, jnp.asarray(y), jcfg, None, cache=jcache,
                                pos=jnp.asarray(slot_pos))
        to, got = TL.mla_fwd(tp, torch.from_numpy(y), cfg, None,
                             cache=tcache, pos=torch.from_numpy(slot_pos))
        assert got[0] is tcache[0] and got[1] is tcache[1]   # in place
        _close(to, jo)
        _close(tcache[0], jcache[0])
        _close(tcache[1], jcache[1])
        slot_pos = slot_pos + 1
    y = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    jo, _ = JL.mla_fwd(jp, jnp.asarray(y), jcfg, None, cache=jcache,
                       pos=S + 4)
    to, _ = TL.mla_fwd(tp, torch.from_numpy(y), cfg, None, cache=tcache,
                       pos=S + 4)
    _close(to, jo)


def test_mla_cache_shapes_follow_reference():
    jcfg = ref_get_config(ARCH, reduced=True)
    want = JT.lm_init_cache(jcfg, 3, 7, jnp.float32)
    got = TT.lm_init_cache(from_reference(jcfg), 3, 7, torch.float32)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]


def test_port_init_mla_shapes():
    jcfg, cfg, jp, _, _, _ = _case()
    tp = TL.init_mla(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}


@pytest.mark.gpu
def test_card_mla_matches_cpu():
    """On the card: MLA prefill and one decode step in f32 against the
    CPU's on the same weights, to 1e-5 of the largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _, cfg, _, tp, x, pos = _case(seed=4, B=4, S=64)
    card = {k: v.cuda() for k, v in tp.items()}
    want, wc = TL.mla_fwd(tp, torch.from_numpy(x), cfg,
                          torch.from_numpy(pos))
    got, gc = TL.mla_fwd(card, torch.from_numpy(x).cuda(), cfg,
                         torch.from_numpy(pos).cuda())
    _close(got, want.numpy())
    for g, w in zip(gc, wc):
        _close(g, w.numpy())
    y = torch.randn((4, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    cache = tuple(torch.cat([c, torch.zeros_like(c[:, :4])], 1) for c in wc)
    card_cache = tuple(c.cuda() for c in cache)
    want, _ = TL.mla_fwd(tp, y, cfg, None, cache=cache, pos=64)
    got, _ = TL.mla_fwd(card, y.cuda(), cfg, None, cache=card_cache, pos=64)
    _close(got, want.numpy())
