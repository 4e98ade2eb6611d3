"""The N:M structured-sparse matmul K3 against the JAX package's.

On CPU tensors ``repro_torch.kernels.nm_spmm.nm_spmm`` runs its plain
PyTorch version; it must match the JAX package's interpret-mode Pallas
``nm_spmm`` and its ``nm_spmm_ref`` at the shapes and tolerances of
``tests/test_kernels.py`` (f32 1e-4, bf16 0.25), with int8 and with
bit-packed offsets.  It raises where the reference asserts, and CPU
tensors never launch the kernel.  The kernel's plan (``ops.plan``: path,
K split, tiles) is a pure function of the shape and is checked here.
The CUDA kernel itself is held to the plain version by the
``gpu``-marked tests below and by ``chip_smoke.py``.
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
from repro_torch.kernels.nm_spmm import ops, study  # noqa: E402
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
    """On the card: K3 against its plain version, held to 1e-5 of the
    largest magnitude in f32 and bf16 alike (both sides multiply the same
    inputs in f32 and sum in f32), each launch counted, with a K whose
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
    print(f"[K3 card] {dtype} {n}:{m} bm={bm} bn={bn} packed={packed} "
          f"rel err {err:.3e}")
    assert err <= CARD_TOL
    assert ops.LIBRARY.src.name == "nm_spmm.cu"


# ---------------------------------------------------------------------
# The kernel's plan (ops.plan): a pure function of the shape, checked
# here on the CPU; the launches that follow it are checked on the card.
CHIP_CELLS = {"ffn_gate_up": (8, 896, 9728), "lm_head": (8, 896, 151936),
              "ffn_down": (128, 4864, 896)}


def test_plan_fills_the_card_at_the_chip_cells():
    """Two waves of blocks on 132 SMs at ffn_gate_up (it had 1.15), at
    least one at ffn_down on the tensor cores, and lm_head's grid
    without a split."""
    gate = ops.plan(*CHIP_CELLS["ffn_gate_up"], 2, 4, torch.float32)
    assert gate.path == "narrow" and gate.waves(132) >= 2
    assert gate.grid == (8, 1, 38) and gate.slice_groups == 28
    down = ops.plan(*CHIP_CELLS["ffn_down"], 2, 4, torch.bfloat16)
    assert down.path == "wide" and down.waves(132) >= 1
    assert down.grid == (16, 1, 14) and down.tile == (128, 64)
    assert down.kernel == "wide128" and down.slice_groups == 80
    head = ops.plan(*CHIP_CELLS["lm_head"], 2, 4, torch.float32)
    assert head.path == "narrow" and head.grid == (1, 1, 594)
    assert head.waves(132) >= 2 and head.slice_groups == 224


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m", PAIRS)
def test_plan_slices_hold_whole_groups_and_bytes(n, m, dtype, packed):
    """Every K-slice but the last holds the same whole number of stages,
    so whole m-groups and whole bytes of packed offsets; the last is not
    empty; the split stays within one cluster (16)."""
    per = 8 // ops.offsets_bits(m)
    for M in (8, 32, 64, 128):
        for groups in (1, 3, 20, 101, 224, 1216, 4000):
            if packed and (groups * n) % per:
                continue
            K = groups * m
            p = ops.plan(M, K, 896, n, m, dtype, sms=132)
            assert p.stage_groups == ops.stage_groups(p.path, n, m)
            assert p.slice_groups % p.stage_groups == 0
            assert (p.slice_groups * n) % per == 0
            assert 1 <= p.split <= ops.MAX_SPLIT
            assert (p.split - 1) * p.slice_groups < groups \
                <= p.split * p.slice_groups
            assert p.grid[0] == p.split and p.kernel in ops.KERNELS


@pytest.mark.parametrize("M", [8, 16, 32, 64, 128, 512])
def test_plan_f32_never_takes_the_tensor_cores(M):
    for K, N in ((896, 9728), (4864, 896), (80, 256)):
        assert ops.plan(M, K, N, 2, 4, torch.float32).path == "narrow"
    wide = ops.plan(M, 4864, 896, 2, 4, torch.bfloat16).path
    assert wide == ("wide" if M > ops.NARROW_MAX_M else "narrow")


def test_plan_raises_where_the_kernel_cannot_go():
    """N not a multiple of 16 columns (the kernel reads 16 bytes of
    neighbouring columns) and unknown patterns raise; bf16 with K % 8
    (A's rows not 16-byte aligned) stays on the narrow path."""
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.plan(8, 896, 40, 2, 4, torch.float32)
    with pytest.raises(ValueError, match="no N:M kernel"):
        ops.plan(8, 896, 64, 3, 4, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.plan(12, 896, 64, 2, 4, torch.float32)
    assert ops.plan(128, 12, 64, 2, 6, torch.bfloat16).path == "narrow"


def test_plan_split_follows_the_sm_count():
    small = ops.plan(8, 896, 9728, 2, 4, torch.float32, sms=16)
    assert small.split == 1 and small.blocks >= 2 * 16
    # 16 slices aimed at; slices of whole 4-group stages give 14 of 16
    big = ops.plan(8, 896, 9728, 2, 4, torch.float32, sms=264)
    assert (big.split, big.slice_groups) == (14, 16)
    # the card's 132: 8 slices of 28 groups, 304 blocks
    card = ops.plan(8, 896, 9728, 2, 4, torch.float32, sms=132)
    assert (card.split, card.slice_groups, card.blocks) == (8, 28, 304)


def test_study_variants_are_cut_from_the_kernel_source():
    """``study.py``'s variants still fit the kernel's source: every
    substitution occurs as often as it names, and every variant but the
    unchanged one differs from the source."""
    srcs = study.variant_sources()
    assert srcs["base"] == ops.LIBRARY.src.read_text()
    assert set(srcs) == set(study.VARIANTS)
    assert all(text != srcs["base"] for name, text in srcs.items()
               if name != "base")
    # its other splits are cut as the plan cuts its own
    for M, K, N in CHIP_CELLS.values():
        p = ops.plan(M, K, N, 2, 4, torch.float32)
        assert study._slices(p, K // 4, p.split) == (p.split,
                                                      p.slice_groups)


# ---------------------------------------------------------------------
# On the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _card_case(M, K, N, n, m, dtype, seed):
    """A, packed N:M weights (values, int8 and packed offsets) made on the
    card by the port's own pruning and packing."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((M, K), generator=gen, device=dev)
    w = nm_prune_dense(torch.randn((K, N), generator=gen, device=dev), n, m)
    vals, idx = pack_nm(w, n, m)
    return a.to(dtype), vals.to(dtype), idx, pack_offsets(idx, m)


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


#: K3 against its plain version, relative to the largest magnitude, for
#: f32 and bf16 alike: both sides multiply the same inputs in f32 (a
#: product of two bf16 is exact in f32) and sum in f32, so only the order
#: of the sums differs
CARD_TOL = 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cell", sorted(CHIP_CELLS))
def test_cuda_chip_cells_full_size(cell, dtype, packed):
    """The chip_smoke cells at full size, 2:4: K3 against its plain
    version (1e-5 of the largest magnitude, f32 and bf16), one launch
    counted, on the path the plan names."""
    M, K, N = CHIP_CELLS[cell]
    a, vals, idx, pk = _card_case(M, K, N, 2, 4, dtype, 11)
    offs = pk if packed else idx
    kw = dict(n=2, m=4, bm=64, bk=64, bn=64, packed=packed)
    before = nm_spmm.launches
    got = nm_spmm(a, vals, offs, **kw)
    torch.cuda.synchronize()
    assert nm_spmm.launches == before + 1
    want = nm_spmm_plain(a, vals, offs, **kw)
    assert _rel_err(got, want) <= CARD_TOL
    want_path = "wide" if dtype == torch.bfloat16 and M > 32 else "narrow"
    assert ops.plan(M, K, N, 2, 4, dtype).path == want_path


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("M,groups,dtype", [
    (8, 102, torch.float32), (8, 102, torch.bfloat16),
    (16, 1218, torch.float32), (64, 50, torch.bfloat16),
    (128, 1218, torch.bfloat16), (40, 34, torch.bfloat16)])
def test_cuda_ragged_k(M, groups, dtype, packed):
    """K whose last slice and last stage hold fewer groups than the
    others (and a bf16 M of 40, a partial 64-row tile)."""
    n, m, N = 2, 4, 384
    K = groups * m
    p = ops.plan(M, K, N, n, m, dtype)
    assert groups % p.slice_groups or groups % p.stage_groups
    a, vals, idx, pk = _card_case(M, K, N, n, m, dtype, groups)
    offs = pk if packed else idx
    kw = dict(n=n, m=m, bm=8, bk=K, bn=128, packed=packed)
    got = nm_spmm(a, vals, offs, **kw)
    want = nm_spmm_plain(a, vals, offs, **kw)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= CARD_TOL


@pytest.mark.gpu
def test_cuda_columns_not_a_multiple_of_16_raise():
    """N must be a multiple of 16 columns: through the wrapper no legal
    bn allows another N (ValueError), and the C interface returns
    cudaErrorInvalidValue (1) for N = 40 without launching."""
    a, vals, idx, _ = _card_case(8, 64, 48, 2, 4, torch.float32, 1)
    with pytest.raises(ValueError):
        nm_spmm(a, vals, idx, n=2, m=4, bm=8, bk=64, bn=64)
    out = torch.empty((8, 40), device=a.device)
    v40 = vals[:, :40].contiguous()
    i40 = idx[:, :40].contiguous()
    err = ops.LIBRARY.lib().nm_spmm(
        a.data_ptr(), v40.data_ptr(), i40.data_ptr(), out.data_ptr(), 8, 64,
        40, 2, 4, 0, 0, 0, 1, 16, torch.cuda.current_stream().cuda_stream)
    assert err == 1


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("cell,dtype", [("ffn_gate_up", torch.float32),
                                        ("ffn_down", torch.bfloat16),
                                        ("ffn_gate_up", torch.bfloat16)])
def test_cuda_repeat_launches_are_bit_identical(cell, dtype, packed):
    """The split-K partials are summed in a fixed order: two launches on
    the same inputs give the same bits."""
    M, K, N = CHIP_CELLS[cell]
    a, vals, idx, pk = _card_case(M, K, N, 2, 4, dtype, 5)
    offs = pk if packed else idx
    assert ops.plan(M, K, N, 2, 4, dtype).split > 1
    first = nm_spmm(a, vals, offs, n=2, m=4, bm=64, bk=64, bn=64,
                    packed=packed)
    again = nm_spmm(a, vals, offs, n=2, m=4, bm=64, bk=64, bn=64,
                    packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n,m", PAIRS)
def test_cuda_each_path_is_reached(n, m, packed):
    """Narrow at M = 8 (f32 and bf16), wide at bf16 M = 64 and 128: the
    plan names the path, the library's variant has the plan's stage, no
    registers spill to local memory, and each call counts one launch."""
    _cuda()
    for M, dtype, path in ((8, torch.float32, "narrow"),
                           (8, torch.bfloat16, "narrow"),
                           (64, torch.bfloat16, "wide"),
                           (128, torch.bfloat16, "wide")):
        K, N = 48 * m, 256
        p = ops.plan(M, K, N, n, m, dtype)
        assert p.path == path
        info = ops.kernel_info(p.kernel, dtype, n, m, packed)
        assert info["stage_groups"] == p.stage_groups
        assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1
        a, vals, idx, pk = _card_case(M, K, N, n, m, dtype, M + n + m)
        offs = pk if packed else idx
        before = nm_spmm.launches
        got = nm_spmm(a, vals, offs, n=n, m=m, bm=8, bk=K, bn=64,
                      packed=packed)
        want = nm_spmm_plain(a, vals, offs, n=n, m=m, bm=8, bk=K, bn=64,
                             packed=packed)
        torch.cuda.synchronize()
        assert nm_spmm.launches == before + 1
        assert _rel_err(got, want) <= CARD_TOL
