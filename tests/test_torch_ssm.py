"""The port's recurrent blocks (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm``.

The same numpy weights and inputs go through both in f32 on the CPU, to
1e-5 of the largest magnitude: the chunked gated linear recurrence (one
chunk and several), its decode step, the causal depthwise conv with and
without a cache, the Mamba2 dimensions, and Mamba2, mLSTM and sLSTM each
as a prefill whose state feeds decode steps.  A sequence that is not a
whole number of chunks raises in both.  The port's own consistency: a
prefill of S tokens then one decode step gives a prefill of S + 1
tokens' last output.  ``gpu``-marked cases hold the card's blocks to the
CPU's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402

TOL = 1e-5
#: (block, configuration whose widths it takes)
BLOCKS = [("mamba2", "zamba2-7b"), ("mlstm", "xlstm-350m"),
          ("slstm", "xlstm-350m")]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _tree(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().cpu().float().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * max(
        float(np.abs(want).max()), 1e-30)


def _close_tree(got, want):
    if isinstance(got, torch.Tensor):
        _close(got, want)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_tree(g, w)


def _recurrence_inputs(rng, B=2, S=8, H=3, Dk=4, Dv=5):
    a = rng.uniform(0.5, 1.0, size=(B, S, H))
    q, k = rng.normal(size=(2, B, S, H, Dk))
    v = rng.normal(size=(B, S, H, Dv))
    h0 = rng.normal(size=(B, H, Dv, Dk)) * 0.1
    return [np.asarray(t, np.float32) for t in (a, q, k, v, h0)]


@pytest.mark.parametrize("S,chunk", [(8, 128), (32, 8)])
def test_chunked_recurrence(S, chunk):
    args = _recurrence_inputs(np.random.default_rng(S), S=S)
    jy, jh = JS.chunked_recurrence(*map(jnp.asarray, args), chunk=chunk)
    ty, th = TS.chunked_recurrence(*map(_t, args), chunk=chunk)
    _close(ty, jy)
    _close(th, jh)


def test_chunked_recurrence_raises_on_a_ragged_sequence():
    """S = 12 is not a whole number of chunks of 8: the reference's
    reshape raises, and so does the port (it never drops the tail)."""
    args = _recurrence_inputs(np.random.default_rng(0), S=12)
    with pytest.raises(TypeError):
        JS.chunked_recurrence(*map(jnp.asarray, args), chunk=8)
    with pytest.raises(ValueError, match="chunks"):
        TS.chunked_recurrence(*map(_t, args), chunk=8)


def test_recurrence_step():
    rng = np.random.default_rng(1)
    a, q, k, v, h = _recurrence_inputs(rng, S=1)
    args = (a[:, 0], q[:, 0], k[:, 0], v[:, 0], h)
    jy, jh = JS.recurrence_step(*map(jnp.asarray, args))
    ty, th = TS.recurrence_step(*map(_t, args))
    _close(ty, jy)
    _close(th, jh)


@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv(cached):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 5)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    cache = rng.normal(size=(2, 3, 5)).astype(np.float32) if cached else None
    jo, jc = JS.causal_conv(jnp.asarray(x), jnp.asarray(w),
                            None if cache is None else jnp.asarray(cache))
    to, tc = TS.causal_conv(_t(x), _t(w), None if cache is None else _t(cache))
    _close(to, jo)
    _close(tc, jc)


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-350m"])
def test_mamba_dims(arch):
    for reduced in (False, True):
        jcfg = ref_get_config(arch, reduced=reduced)
        assert TS._mamba_dims(from_reference(jcfg)) == JS._mamba_dims(jcfg)


def _block(kind, arch, seed):
    jcfg = ref_get_config(arch, reduced=True)
    jp, _ = getattr(JS, f"init_{kind}")(jcfg, jax.random.PRNGKey(seed))
    return (jcfg, from_reference(jcfg), jp, getattr(JS, f"{kind}_fwd"),
            _tree(jax.tree.map(np.asarray, jp)), getattr(TS, f"{kind}_fwd"))


def _jax_tree(state):
    return jax.tree.map(jnp.asarray, state)


@pytest.mark.parametrize("kind,arch", BLOCKS)
def test_prefill_state_feeds_decode_steps(kind, arch):
    """A prefill of 8 positions, then 3 decode steps from its state: every
    output and state as the reference's."""
    jcfg, cfg, jp, jfwd, tp, tfwd = _block(kind, arch, seed=len(kind))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    jy, jst = jfwd(jp, jnp.asarray(x), jcfg)
    ty, tst = tfwd(tp, _t(x), cfg)
    _close(ty, jy)
    _close_tree(tst, jst)
    for _ in range(3):
        y = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jfwd(jp, jnp.asarray(y), jcfg, jst)
        ty, tst = tfwd(tp, _t(y), cfg, tst)
        _close(ty, jy)
        _close_tree(tst, jst)


@pytest.mark.parametrize("kind,arch", BLOCKS)
def test_decode_step_continues_the_prefill(kind, arch):
    """The port's own consistency: prefill of 7 positions and one decode
    step give the last output of a prefill of 8 (the chunked form and the
    recurrent step are one recurrence)."""
    _, cfg, _, _, tp, tfwd = _block(kind, arch, seed=5)
    x = _t(np.random.default_rng(4).normal(size=(2, 8, cfg.d_model)))
    full, _ = tfwd(tp, x, cfg)
    _, st = tfwd(tp, x[:, :7], cfg)
    last, _ = tfwd(tp, x[:, 7:], cfg, st)
    _close(last, full[:, 7:].numpy())


def test_slstm_state_dtypes():
    """sLSTM keeps ``h`` in the activations' type and ``c, n, m`` in f32,
    as the reference does (bf16 at full size)."""
    _, cfg, _, _, tp, _ = _block("slstm", "xlstm-350m", seed=6)
    x = torch.randn((1, 3, cfg.d_model)).to(torch.bfloat16)
    bf = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    y, (h, c, n, m) = TS.slstm_fwd(bf, x, cfg)
    assert y.dtype == h.dtype == torch.bfloat16
    assert c.dtype == n.dtype == m.dtype == torch.float32


@pytest.mark.gpu
@pytest.mark.parametrize("kind,arch", BLOCKS)
def test_card_blocks_match_cpu(kind, arch):
    """On the card: each block's prefill of 256 positions and one decode
    step in f32 against the CPU's, to 1e-5 of the largest magnitude."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    _, cfg, _, _, tp, tfwd = _block(kind, arch, seed=7)
    x = _t(np.random.default_rng(8).normal(size=(4, 257, cfg.d_model)))
    card = {k: v.cuda() for k, v in tp.items()}
    want, wst = tfwd(tp, x[:, :256], cfg)
    got, gst = tfwd(card, x[:, :256].cuda(), cfg)
    _close(got, want.numpy())
    want, _ = tfwd(tp, x[:, 256:], cfg, wst)
    got, _ = tfwd(card, x[:, 256:].cuda(), cfg, gst)
    _close(got, want.numpy())
