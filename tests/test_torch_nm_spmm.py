"""The N:M structured-sparse matmul K3 against the JAX package's.

On CPU tensors ``repro_torch.kernels.nm_spmm.nm_spmm`` runs its plain
PyTorch version; it must match the JAX package's interpret-mode Pallas
``nm_spmm`` and its ``nm_spmm_ref`` at the shapes and tolerances of
``tests/test_kernels.py`` (f32 1e-4, bf16 0.25), with int8 and with
bit-packed offsets.  It raises where the reference asserts, and CPU
tensors never launch the kernel.  The CUDA kernel itself is held to the
plain version by the ``gpu``-marked test below and by ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.nm_spmm.ops import nm_spmm as ref_nm_spmm  # noqa: E402
from repro.kernels.nm_spmm.ops import nm_spmm_ref as ref_nm_spmm_ref  # noqa: E402
from repro.sparsity.nm import nm_prune_dense as ref_prune  # noqa: E402
from repro.sparsity.nm import pack_nm as ref_pack_nm  # noqa: E402
from repro.sparsity.nm import pack_offsets as ref_pack_offsets  # noqa: E402
from repro_torch.kernels.nm_spmm import (NM_PAIRS, nm_spmm,  # noqa: E402
                                         nm_spmm_plain, nm_spmm_ref)
from repro_torch.kernels.nm_spmm import ops  # noqa: E402
from repro_torch.sparsity import (nm_prune_dense, pack_nm,  # noqa: E402
                                  pack_offsets)

PAIRS = [(2, 4), (1, 4), (2, 6), (2, 8), (4, 8)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 0.25)}


def _case(n, m, M, K, N, dtype, seed, packed=False):
    """The same packed operands in both frameworks (numpy from a seed,
    pruned and packed by the JAX package, rounded through its dtype)."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.normal(size=(M, K)), jdt)
    w = ref_prune(jnp.asarray(rng.normal(size=(K, N)), jnp.float32), n, m)
    wv, wi = ref_pack_nm(w, n, m)
    wv = wv.astype(jdt)
    wk = ref_pack_offsets(wi, m) if packed else wi

    def t(x, dt=None):
        x = np.array(x.astype(jnp.float32) if dt else x)
        return torch.from_numpy(x).to(dt) if dt else torch.from_numpy(x)
    return (a, wv, wi, wk), (t(a, tdt), t(wv, tdt), t(wi), t(wk))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,m", PAIRS)
def test_matches_reference_interpret_mode(n, m, dtype):
    tol = DTYPES[dtype][2]
    M, K, N = 32, 12 * m, 64
    (a, wv, wi, _), (ta, tv, ti, _) = _case(n, m, M, K, N, dtype, 7 * m + n)
    want = np.asarray(ref_nm_spmm(a, wv, wi, n=n, m=m, bm=32, bk=3 * m,
                                  bn=32))
    want_ref = np.asarray(ref_nm_spmm_ref(a, wv, wi, n, m))
    before = nm_spmm.launches
    got = nm_spmm(ta, tv, ti, n=n, m=m, bm=32, bk=3 * m, bn=32)
    assert nm_spmm.launches == before            # CPU: no launch
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    got_ref = nm_spmm_ref(ta, tv, ti, n, m)
    for g, w in ((got, want), (got, want_ref), (got_ref, want_ref)):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=tol)


@pytest.mark.parametrize("bm,bk,bn", [(16, 8, 32), (32, 16, 16),
                                      (64, 32, 64)])
def test_block_shape_sweep(bm, bk, bn):
    n, m = 2, 4
    (a, wv, wi, _), (ta, tv, ti, _) = _case(n, m, 64, 64, 64, "float32",
                                            bm + bk + bn)
    want = np.asarray(ref_nm_spmm(a, wv, wi, n=n, m=m, bm=bm, bk=bk,
                                  bn=bn))
    got = nm_spmm(ta, tv, ti, n=n, m=m, bm=bm, bk=bk, bn=bn)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,m", PAIRS)
def test_packed_offsets_match_reference(n, m, dtype):
    tol = DTYPES[dtype][2]
    M, K, N = 32, 16 * m, 64
    (a, wv, wi, wk), (ta, tv, ti, tk) = _case(n, m, M, K, N, dtype,
                                              3 * m + n, packed=True)
    want = np.asarray(ref_nm_spmm(a, wv, wk, n=n, m=m, bm=32, bk=4 * m,
                                  bn=32, packed=True))
    np.testing.assert_array_equal(pack_offsets(ti, m).numpy(),
                                  np.asarray(wk))
    got = nm_spmm(ta, tv, tk, n=n, m=m, bm=32, bk=4 * m, bn=32,
                  packed=True)
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(
        got.numpy(), nm_spmm(ta, tv, ti, n=n, m=m, bm=32, bk=4 * m,
                             bn=32).numpy(), atol=1e-6, rtol=1e-6)


def test_port_packing_feeds_the_kernel():
    """The port's own pruning and packing, end to end on the CPU."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 96)).astype(np.float32))
    w_nm = nm_prune_dense(w, 2, 4)
    vals, idx = pack_nm(w_nm, 2, 4)
    for packed, offs in ((False, idx), (True, pack_offsets(idx, 4))):
        got = nm_spmm(a, vals, offs, n=2, m=4, bm=16, bk=32, bn=32,
                      packed=packed)
        torch.testing.assert_close(got, a @ w_nm, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(bk=6), "do not fit"),                  # bk % m
    (dict(bk=24), "do not fit"),                 # K % bk
    (dict(bm=12), "do not fit"),                 # M % bm
    (dict(bn=24), "do not fit"),                 # N % bn
    (dict(bk=4, packed=True), "fill bytes"),     # bkc % per
    (dict(m=8), "inconsistent"),                 # Kc * m != K * n
])
def test_reference_asserts_raise(kw, match):
    (_, _, _, _), (ta, tv, ti, _) = _case(2, 4, 32, 64, 64, "float32", 1)
    kw = dict(dict(n=2, m=4, bm=32, bk=16, bn=32), **kw)
    if kw.get("packed"):
        ti = pack_offsets(ti, 4)
    with pytest.raises(ValueError, match=match):
        nm_spmm(ta, tv, ti, **kw)


def test_idx_shape_is_checked():
    (_, _, _, _), (ta, tv, ti, _) = _case(2, 4, 32, 64, 64, "float32", 2)
    with pytest.raises(ValueError, match="w_idx"):
        nm_spmm(ta, tv, ti, n=2, m=4, bm=32, bk=16, bn=32, packed=True)
    assert NM_PAIRS == tuple(PAIRS)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,m", PAIRS)
@pytest.mark.parametrize("bm,bn", [(8, 64), (64, 32), (128, 128)])
def test_cuda_kernel_matches_plain_version(bm, bn, n, m, dtype, packed):
    """On the card: K3 against its plain version (f32 1e-5 of the
    largest magnitude; bf16 0.25), each launch counted, with a K whose
    last step holds fewer groups than the others."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    M, K, N = 128, 20 * m, 256
    _, (ta, tv, ti, tk) = _case(n, m, M, K, N, dtype, bm + n + m,
                                packed=True)
    dev = torch.device("cuda")
    ta, tv, ti, tk = (x.to(dev) for x in (ta, tv, ti, tk))
    offs = tk if packed else ti
    kw = dict(n=n, m=m, bm=bm, bk=4 * m, bn=bn, packed=packed)
    before = nm_spmm.launches
    got = nm_spmm(ta, tv, offs, **kw)
    want = nm_spmm_plain(ta, tv, offs, **kw)
    torch.cuda.synchronize()
    assert nm_spmm.launches == before + 1
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= (1e-5 if dtype == "float32" else 0.25)
    assert ops.LIBRARY.src.name == "nm_spmm.cu"
