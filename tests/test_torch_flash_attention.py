"""The flash-attention kernel K4 against the JAX package's.

On CPU tensors ``repro_torch.kernels.flash_attention.flash_attention``
runs its plain PyTorch version (the online-softmax recurrence of the
reference's ``_flash_kernel``); it must match the JAX package's
interpret-mode Pallas ``flash_attention`` over the grid of
``tests/test_flash_attention.py`` (f32 1e-5, bf16 3e-2), with GQA and
without the causal mask, its ``flash_attention_ref`` and the port's
chunked ``sdpa`` at the reference's own tolerances (1e-5, 2e-5).  It
raises where the reference asserts, and CPU tensors never launch the
kernel.  The CUDA kernel itself is held to the plain version by the
``gpu``-marked tests below and by ``chip_smoke.py``.

The gradient: ``flash_attention_backward``, the backward of the
kernel's autograd Function, equals autograd through
``flash_attention_plain`` and through the chunked ``sdpa`` on the same
inputs (f32, GQA, S 128 and 256, 1e-5 of each gradient's largest
magnitude), and the Function wires it in (its launch replaced by the
plain forward, detached as the kernel's output is).  On the card, K4's
dq, dk and dv are held to autograd through its plain version.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import \
    flash_attention as ref_flash  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention_ref as ref_flash_ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain, flash_attention_ref)
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.models.layers import sdpa  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _case(B, S, H, KV, D, dtype, seed):
    """The same q, k, v in both frameworks (numpy from a seed, rounded
    through the JAX dtype)."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    jx = [jnp.asarray(rng.normal(size=(B, S, h, D)), jdt)
          for h in (H, KV, KV)]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32))).to(tdt)
          for x in jx]
    return jx, tx


def _oracle(q, k, v, causal=True):
    """The port's ``flash_attention_ref`` over (B*H, S, D), KV heads
    repeated as the reference's ``jnp.repeat`` (query head h reads KV
    head h // rep)."""
    B, S, H, D = q.shape
    rep = H // k.shape[2]

    def bh(x):
        return x.repeat_interleave(rep, 2).transpose(1, 2).reshape(
            B * H, S, D)
    out = flash_attention_ref(bh(q), bh(k), bh(v), causal=causal)
    return out.reshape(B, H, S, D).transpose(1, 2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("S,bq,bk", [(128, 64, 64), (128, 32, 64),
                                     (256, 128, 32)])
def test_matches_reference_interpret_mode(S, bq, bk, dtype):
    tol = DTYPES[dtype][2]
    (jq, jk, jv), (tq, tk, tv) = _case(2, S, 4, 4, 64, dtype, S + bq + bk)
    want = np.asarray(ref_flash(jq, jk, jv, bq=bq, bk=bk))
    before = ops.flash_attention.launches
    got = flash_attention(tq, tk, tv, bq=bq, bk=bk)
    assert ops.flash_attention.launches == before   # CPU: plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.numpy(), _oracle(tq, tk, tv).numpy(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_gqa_head_repetition(causal):
    """8 query heads over 2 KV heads: head h reads KV head h // 4
    (``repeat_interleave``, not ``repeat``)."""
    (jq, jk, jv), (tq, tk, tv) = _case(1, 128, 8, 2, 32, "float32", 5)
    want = np.asarray(ref_flash(jq, jk, jv, bq=64, bk=64, causal=causal))
    got = flash_attention(tq, tk, tv, bq=64, bk=64, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    wrong = flash_attention(tq, tk.repeat(1, 1, 4, 1), tv.repeat(1, 1, 4, 1),
                            bq=64, bk=64, causal=causal)
    assert not np.allclose(wrong.numpy(), want, atol=1e-3)


def test_oracles_agree():
    """The port's ``flash_attention_ref`` is the reference's, and the
    plain recurrence matches it, causal and not."""
    (jq, jk, jv), (tq, tk, tv) = _case(1, 64, 3, 3, 16, "float32", 9)
    for causal in (True, False):
        want = np.asarray(ref_flash_ref(jq[0].transpose(1, 0, 2),
                                        jk[0].transpose(1, 0, 2),
                                        jv[0].transpose(1, 0, 2),
                                        causal=causal))
        got = flash_attention_ref(tq[0].transpose(0, 1),
                                  tk[0].transpose(0, 1),
                                  tv[0].transpose(0, 1), causal=causal)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        plain = flash_attention_plain(tq, tk, tv, bq=32, bk=16,
                                      causal=causal)
        np.testing.assert_allclose(plain.numpy(),
                                   _oracle(tq, tk, tv, causal).numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_matches_model_sdpa():
    """The kernel's plain version agrees with the model's chunked sdpa
    (the path it replaces on the card), two chunks of 64."""
    _, (tq, tk, tv) = _case(2, 128, 4, 4, 32, "float32", 11)
    pos = torch.arange(128)
    model_out = sdpa(tq, tk, tv, pos, pos, causal=True, chunk=64)
    out = flash_attention(tq, tk, tv, bq=64, bk=64)
    np.testing.assert_allclose(out.numpy(), model_out.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("S,bq,bk", [(96, 64, 64), (128, 128, 48)])
def test_untiled_lengths_raise(S, bq, bk):
    _, (tq, tk, tv) = _case(1, S, 2, 2, 16, "float32", 1)
    with pytest.raises(ValueError, match="do not divide"):
        flash_attention(tq, tk, tv, bq=bq, bk=bk)
    # the tiles clamp to S, as the reference's min(bq, S)
    out = flash_attention(tq[:, :48], tk[:, :48], tv[:, :48], bq=128,
                          bk=128)
    assert tuple(out.shape) == (1, 48, 2, 16)


def test_heads_must_group():
    _, (tq, tk, tv) = _case(1, 32, 6, 4, 16, "float32", 2)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(tq, tk, tv)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [72, 80, 96, 112, 256])
def test_matches_reference_at_other_head_dims(D, causal):
    """Head dims the kernel takes since it widened (phi-2's 80,
    phi-3-mini's 96, gemma-7b's 256 and two between widths): the plain
    version against the JAX package's interpret-mode kernel, GQA 4 over
    2, at its f32 tolerance."""
    (jq, jk, jv), (tq, tk, tv) = _case(1, 128, 4, 2, D, "float32", D)
    want = np.asarray(ref_flash(jq, jk, jv, bq=64, bk=64, causal=causal))
    got = flash_attention(tq, tk, tv, bq=64, bk=64, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("D,width", [(8, 16), (16, 16), (17, 32),
                                     (48, 48), (72, 80), (100, 112),
                                     (129, 160), (200, 256), (256, 256)])
def test_head_dims_run_the_next_width(D, width):
    """A head dim runs the first compiled width at least as wide; f32
    has no width 80 (65 to 96 run 96)."""
    assert ops.width(D) == width and width in ops.WIDTHS
    f32 = ops.width(D, torch.float32)
    assert f32 == (96 if width == 80 else width) and f32 in ops.F32_WIDTHS


@pytest.mark.parametrize("D", [0, 264, 512])
def test_head_dims_past_the_widths_raise(D):
    """Head dims above 256 (and 0) have no kernel: raises before any
    launch, here on the CPU through the width it would take."""
    with pytest.raises(ValueError, match="head dims"):
        ops.width(D)
    with pytest.raises(ValueError, match="head dims"):
        ops.kernel_info(torch.bfloat16, D)


def _grads(fn, xs, dout):
    """(dq, dk, dv) of ``(fn(*xs) * dout).sum()`` by autograd."""
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    (fn(*xs) * dout).sum().backward()
    return [x.grad for x in xs]


def _grad_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()
                     / w.float().abs().max()) for g, w in zip(got, want))


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("H,KV", [(4, 2), (4, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_matches_autograd(S, H, KV, causal):
    _, xs = _case(2, S, H, KV, 32, "float32", S + H + KV)
    dout = torch.from_numpy(np.random.default_rng(S).normal(
        size=(2, S, H, 32)).astype(np.float32))
    got = ops.flash_attention_backward(*xs, dout, causal=causal, chunk=96)
    assert [g.dtype for g in got] == [torch.float32] * 3
    assert [tuple(g.shape) for g in got] == [tuple(x.shape) for x in xs]
    plain = _grads(lambda q, k, v: flash_attention_plain(
        q, k, v, bq=64, bk=64, causal=causal), xs, dout)
    assert _grad_err(got, plain) <= 1e-5
    pos = torch.arange(S)
    chunked = _grads(lambda q, k, v: sdpa(q, k, v, pos, pos, causal=causal,
                                          chunk=64), xs, dout)
    assert _grad_err(got, chunked) <= 1e-5


def test_function_carries_the_gradient(monkeypatch):
    """The registered operator around the launch
    (``torch.ops.repro_torch.flash_attention``): its forward is the
    launch (here the plain version, detached as the kernel's output
    is), its backward ``flash_attention_backward``."""
    monkeypatch.setattr(ops, "_launch", lambda q, k, v, causal: (
        flash_attention_plain(q, k, v, causal=causal).detach()))
    _, xs = _case(1, 128, 4, 2, 16, "float32", 5)
    dout = torch.randn((1, 128, 4, 16), generator=torch.Generator()
                       .manual_seed(0))
    got = _grads(lambda q, k, v: torch.ops.repro_torch.flash_attention(
        q, k, v, True), xs, dout)
    want = _grads(flash_attention_plain, xs, dout)
    assert _grad_err(got, want) <= 1e-5


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("S,tile", [(256, 128), (96, 32), (192, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_cuda_kernel_matches_plain_version(D, dtype, causal, S, tile):
    """On the card: K4 against its plain version at 14 query heads over 2
    KV heads (f32 1e-5 of the largest magnitude; bf16 atol = rtol =
    3e-2), each launch counted; S = 96 and 192 are not multiples of the
    kernel's 64-key tiles, so its last key and query tiles are ragged."""
    dev = _cuda_or_skip()
    _, (tq, tk, tv) = _case(2, S, 14, 2, D, dtype, D + S)
    tq, tk, tv = (x.to(dev) for x in (tq, tk, tv))
    kw = dict(bq=tile, bk=tile, causal=causal)
    before = ops.flash_attention.launches
    got = flash_attention(tq, tk, tv, **kw)
    want = flash_attention_plain(tq, tk, tv, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    if dtype == "float32":
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-5
    else:
        torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    assert ops.LIBRARY.src.name == "flash_attention.cu"


@pytest.mark.gpu
def test_sdpa_dispatches_to_kernel_on_cuda():
    """On the card, causal self-attention with Sq % 128 == 0 goes to K4
    and agrees with the chunked path on the CPU; Sq = 64 does not."""
    dev = _cuda_or_skip()
    _, (tq, tk, tv) = _case(1, 128, 14, 2, 64, "float32", 3)
    pos = torch.arange(128)
    want = sdpa(tq, tk, tv, pos, pos)
    before = ops.flash_attention.launches
    got = sdpa(tq.to(dev), tk.to(dev), tv.to(dev), pos.to(dev), pos.to(dev))
    assert ops.flash_attention.launches == before + 1
    err = float((got.cpu() - want).abs().max() / want.abs().max())
    assert err <= 1e-5
    sdpa(tq[:, :64].to(dev), tk[:, :64].to(dev), tv[:, :64].to(dev),
         pos[:64].to(dev), pos[:64].to(dev))
    assert ops.flash_attention.launches == before + 1


def _on_card(dev, B, S, H, KV, D, seed):
    _, (tq, tk, tv) = _case(B, S, H, KV, D, "bfloat16", seed)
    return tuple(x.to(dev) for x in (tq, tk, tv))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,D,causal", [
    (1, 512, 14, 2, 64, True),      # the serving loop's refill prefill
    (1, 512, 14, 2, 64, False),
    (2, 192, 4, 4, 64, True),       # GQA rep 1
    (2, 96, 14, 2, 32, True),       # GQA rep 7, ragged
    (1, 192, 7, 1, 16, False),
    (1, 320, 32, 8, 128, True),     # qwen3-4b's heads, ragged at 64
])
def test_cuda_bf16_kernel_shapes(B, S, H, KV, D, causal):
    """On the card: the bf16 tensor-core variant against the plain
    version (atol = rtol = 3e-2) at the shapes its design risks: one
    batch row, lengths that are not multiples of 64, head dims 16 to 128,
    one and seven query heads per KV head."""
    dev = _cuda_or_skip()
    tq, tk, tv = _on_card(dev, B, S, H, KV, D, S + D + H)
    tile = 64 if S % 64 == 0 else 32
    kw = dict(bq=tile, bk=tile, causal=causal)
    before = ops.flash_attention.launches
    got = flash_attention(tq, tk, tv, **kw)
    want = flash_attention_plain(tq, tk, tv, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert "tensor cores" in ops.kernel_info(torch.bfloat16, D)["variant"]
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [8, 16, 24, 32, 48, 64, 72, 80, 96, 112,
                               128, 136, 160, 192, 200, 256])
def test_cuda_head_dims(D, causal, dtype):
    """On the card: every compiled width, and head dims between them
    (the next width, its missing columns read as zeros), against the
    plain version (f32 1e-5 of the largest magnitude; bf16 atol = rtol =
    3e-2), GQA 6 over 2, S 192 (ragged at 64 keys), one launch each, a
    repeat launch the same bits, no local memory in the variant."""
    dev = _cuda_or_skip()
    _, (tq, tk, tv) = _case(1, 192, 6, 2, D, dtype, D + 1)
    tq, tk, tv = (x.to(dev) for x in (tq, tk, tv))
    kw = dict(bq=64, bk=64, causal=causal)
    before = ops.flash_attention.launches
    got, again = flash_attention(tq, tk, tv, **kw), flash_attention(
        tq, tk, tv, **kw)
    want = flash_attention_plain(tq, tk, tv, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 2
    assert torch.equal(got, again)
    if dtype == "float32":
        assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    else:
        torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    info = ops.kernel_info(DTYPES[dtype][1], D, causal)
    assert info["width"] == ops.width(D, DTYPES[dtype][1])
    assert info["local_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_bf16_fused_qkv_views(causal):
    """On the card: q, k and v as strided views of one fused
    (B, S, H + 2 KV, D) projection, read in place, agree with the plain
    version on contiguous copies."""
    dev = _cuda_or_skip()
    B, S, H, KV, D = 2, 192, 14, 2, 64
    rng = np.random.default_rng(21)
    fused = torch.from_numpy(rng.normal(size=(B, S, H + 2 * KV, D))).to(
        torch.bfloat16).to(dev)
    q, k, v = fused[:, :, :H], fused[:, :, H:H + KV], fused[:, :, H + KV:]
    assert not q.is_contiguous() and not k.is_contiguous()
    got = flash_attention(q, k, v, bq=64, bk=64, causal=causal)
    want = flash_attention_plain(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bq=64, bk=64,
                                 causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.gpu
def test_cuda_bf16_inputs_it_cannot_take_raise():
    """On the card: a bf16 view whose start is not 16-byte aligned, or
    whose strides are not multiples of 8 elements, raises before any
    launch, as does a head dim above 256; an aligned view of the same
    storage runs."""
    dev = _cuda_or_skip()
    base = torch.randn((1, 128, 2, 80), device=dev).to(torch.bfloat16)
    odd = torch.randn((1, 128, 2, 68), device=dev).to(torch.bfloat16)
    before = ops.flash_attention.launches
    for bad in (base[..., 1:65], odd[..., :64]):
        with pytest.raises(ValueError, match="16 bytes at a time"):
            flash_attention(bad, bad, bad)
    x264 = torch.zeros((1, 128, 2, 264), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(x264, x264, x264)
    assert ops.flash_attention.launches == before
    good = base[..., 8:72]
    got = flash_attention(good, good, good)
    want = flash_attention_plain(good, good, good)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("H,KV", [(14, 2), (8, 8)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 512])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cuda_kernel_gradient_matches_plain(dtype, D, S, causal, H, KV):
    """On the card: an input that requires grad gets a K4 output with a
    gradient; dq, dk and dv equal autograd through the plain version on
    the same inputs (f32: 1e-5 of each gradient's largest magnitude;
    bf16: the plain version in f32 on the bf16 inputs, 1e-2, the
    rounding of dq, dk and dv to bf16)."""
    dev = _cuda_or_skip()
    _, xs = _case(2, S, H, KV, D, dtype, D + S + H)
    xs = [x.to(dev).requires_grad_(True) for x in xs]
    dout = torch.randn((2, S, H, D), device=dev,
                       generator=torch.Generator(dev).manual_seed(S))
    before = ops.flash_attention.launches
    out = flash_attention(*xs, causal=causal)
    assert out.grad_fn is not None
    (out * dout).sum().backward()
    assert ops.flash_attention.launches == before + 1
    got = [x.grad for x in xs]
    assert [g.dtype for g in got] == [x.dtype for x in xs]
    ref = [x.detach().float() for x in xs]
    want = _grads(lambda q, k, v: flash_attention_plain(q, k, v,
                                                        causal=causal),
                  ref, dout)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert _grad_err(got, want) <= (1e-5 if dtype == "float32" else 1e-2)
