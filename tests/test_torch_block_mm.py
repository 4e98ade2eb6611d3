"""The block-sparse kernels' plain versions against the JAX package's.

On CPU tensors ``repro_torch.kernels.block_mm``'s ``skip_mm`` (K1) and
``gated_mm`` (K2) run their plain PyTorch versions; they must match the
JAX package's interpret-mode Pallas ``skip_mm`` / ``gated_mm`` and its
``block_mm_ref`` at the shapes and tolerances of
``tests/test_kernels.py`` (f32 1e-4, bf16 0.3), with ``block_indices``
identical.  CPU tensors never launch a kernel.  The CUDA kernels
themselves are held to the plain versions by the ``gpu``-marked test
below and by ``chip_smoke.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.block_mm.ops import block_indices as ref_block_indices  # noqa: E402
from repro.kernels.block_mm.ops import block_mm_ref as ref_block_mm_ref  # noqa: E402
from repro.kernels.block_mm.ops import gated_mm as ref_gated_mm  # noqa: E402
from repro.kernels.block_mm.ops import skip_mm as ref_skip_mm  # noqa: E402
from repro_torch.kernels.block_mm import ops  # noqa: E402
from repro_torch.kernels.block_mm import (block_indices, block_list,  # noqa: E402
                                          block_mm_ref, column_pointers,
                                          gated_mm, gated_mm_plain, skip_mm,
                                          skip_mm_plain)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.3)}


def _case(seed, density, M=32, K=128, N=128, bk=32, bn=32):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = (rng.random((K // bk, N // bn)) < density).astype(np.int32)
    mask[0, 0] = 1
    return a, w, mask


def _torch(x, jdt, tdt):
    """The same values in both frameworks: round through JAX's dtype."""
    return torch.from_numpy(np.array(jnp.asarray(x, jdt).astype(
        jnp.float32))).to(tdt)


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_kernels_match_reference_interpret_mode(density, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    bk = bn = 32
    a, w, mask = _case(int(density * 10), density)
    ja, jw, jm = jnp.asarray(a, jdt), jnp.asarray(w, jdt), jnp.asarray(mask)
    jwm = jw * jnp.repeat(jnp.repeat(jm.astype(jw.dtype), bk, 0), bn, 1)
    ki, ji = ref_block_indices(mask)
    want_g = np.asarray(ref_gated_mm(ja, jw, jm, bm=32, bk=bk, bn=bn))
    want_s = np.asarray(ref_skip_mm(ja, jwm, jnp.asarray(ki),
                                    jnp.asarray(ji), bm=32, bk=bk, bn=bn))
    want_r = np.asarray(ref_block_mm_ref(ja, jw, jm, bk, bn))

    ta, tw, twm = _torch(a, jdt, tdt), _torch(w, jdt, tdt), _torch(
        np.asarray(jwm.astype(jnp.float32)), jdt, tdt)
    pk, pj = block_indices(mask)
    launches = (skip_mm.launches, gated_mm.launches)
    got_g = gated_mm(ta, tw, mask, bm=32, bk=bk, bn=bn)
    got_s = skip_mm(ta, twm, pk, pj, bm=32, bk=bk, bn=bn)
    got_r = block_mm_ref(ta, tw, torch.from_numpy(mask), bk, bn)
    assert (skip_mm.launches, gated_mm.launches) == launches   # CPU: none
    for got, want in ((got_g, want_g), (got_s, want_s), (got_r, want_r),
                      (got_g, want_r), (got_s, want_r)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(8, 4), (5, 7), (1, 1), (3, 6)])
def test_block_indices_identical(shape):
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    for density in (0.0, 0.3, 1.0):
        mask = (rng.random(shape) < density).astype(np.int32)
        ki, ji = block_indices(mask)
        rk, rj = ref_block_indices(mask)
        np.testing.assert_array_equal(ki, rk)
        np.testing.assert_array_equal(ji, rj)
        assert ki.dtype == rk.dtype and ji.dtype == rj.dtype
        colptr = column_pointers(ki, ji, *shape)
        assert colptr[-1] == len(ki) and np.all(np.diff(colptr) >= 1)


def test_skip_grid_is_shorter():
    """SKIP's work scales with the nonzero blocks, GATE's with all."""
    mask = np.zeros((8, 4), np.int32)
    mask[0, :] = 1
    ki, ji = block_indices(mask)
    assert len(ki) == 4
    np.testing.assert_array_equal(column_pointers(ki, ji, 8, 4),
                                  [0, 1, 2, 3, 4])


def test_column_pointers_reject_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="sorted"):
        column_pointers([0, 0], [1, 0], 1, 2)
    with pytest.raises(ValueError, match="every column"):
        column_pointers([0], [0], 1, 2)
    with pytest.raises(ValueError, match="out of range"):
        column_pointers([3], [0], 2, 1)


def test_tiles_that_do_not_divide_raise():
    a = torch.zeros(24, 64)
    w = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="do not divide"):
        gated_mm(a, w, np.ones((2, 2)), bm=16, bk=32, bn=32)
    with pytest.raises(ValueError, match="do not divide"):
        skip_mm(torch.zeros(16, 48), torch.zeros(48, 64),
                *block_indices(np.ones((1, 2))), bm=16, bk=32, bn=32)


def test_block_list_is_checked_once_and_reused():
    a, w, mask = _case(1, 0.4, M=8, K=64, N=96, bk=32, bn=32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    ki, ji = block_indices(mask)
    blocks = block_list(ki, ji, mask.shape, "cpu")
    assert blocks.index is None and blocks.shape == mask.shape
    torch.testing.assert_close(skip_mm(ta, tw, blocks, bm=8, bk=32, bn=32),
                               skip_mm(ta, tw, ki, ji, bm=8, bk=32, bn=32))
    with pytest.raises(TypeError):
        skip_mm(ta, tw, blocks, ji, bm=8, bk=32, bn=32)
    with pytest.raises(ValueError, match="every column"):
        block_list(ki[ji != 0], ji[ji != 0], mask.shape, "cpu")


def test_plain_versions_are_the_cpu_path():
    a, w, mask = _case(0, 0.5, M=8, K=64, N=64, bk=32, bn=32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    ki, ji = block_indices(mask)
    wm = tw * torch.from_numpy(mask).repeat_interleave(32, 0) \
        .repeat_interleave(32, 1)
    torch.testing.assert_close(skip_mm(ta, wm, ki, ji, bm=8, bk=32, bn=32),
                               skip_mm_plain(ta, wm, ki, ji, bm=8, bk=32,
                                             bn=32))
    torch.testing.assert_close(gated_mm(ta, tw, mask, bm=8, bk=32, bn=32),
                               gated_mm_plain(ta, tw, mask, bm=8, bk=32,
                                              bn=32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bm", [8, 64, 128])
def test_cuda_kernels_match_plain_versions(dtype, bm):
    """On the card: K1 and K2 against their plain versions (f32 1e-5 of
    the largest magnitude; bf16 0.3), and each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    _, tdt, _ = DTYPES[dtype]
    a, w, mask = _case(bm, 0.3, M=128, K=512, N=512, bk=64, bn=64)
    dev = torch.device("cuda")
    ta, tw = (torch.from_numpy(x).to(dev, tdt) for x in (a, w))
    m = torch.from_numpy(mask).to(dev)
    wm = tw * m.repeat_interleave(64, 0).repeat_interleave(64, 1).to(tdt)
    ki, ji = block_indices(mask)
    blocks = block_list(ki, ji, mask.shape, dev)
    before = (skip_mm.launches, gated_mm.launches)
    pairs = ((skip_mm(ta, wm, blocks, bm=bm, bk=64, bn=64),
              skip_mm_plain(ta, wm, ki, ji, bm=bm, bk=64, bn=64)),
             (gated_mm(ta, tw, m, bm=bm, bk=64, bn=64),
              gated_mm_plain(ta, tw, m, bm=bm, bk=64, bn=64)))
    torch.cuda.synchronize()
    assert (skip_mm.launches, gated_mm.launches) == (before[0] + 1,
                                                     before[1] + 1)
    for got, want in pairs:
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= (1e-5 if dtype == "float32" else 0.3)
    assert ops.BUILD_DIR.name == "repro_torch"
