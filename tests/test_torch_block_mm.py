"""The block-sparse kernels' plain versions against the JAX package's.

On CPU tensors ``repro_torch.kernels.block_mm``'s ``skip_mm`` (K1) and
``gated_mm`` (K2) run their plain PyTorch versions; they must match the
JAX package's interpret-mode Pallas ``skip_mm`` / ``gated_mm`` and its
``block_mm_ref`` at the shapes and tolerances of
``tests/test_kernels.py`` (f32 1e-4, bf16 0.3), with ``block_indices``
identical.  CPU tensors never launch a kernel.  The kernels' plan
(``ops.plan``: path, tiles, K split) is a pure function of the shape and
of the block list's longest run, and is checked here.  The CUDA kernels
themselves are held to the plain versions by the ``gpu``-marked tests
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
from repro_torch.fleet.validate import block_cell_inputs  # noqa: E402
from repro_torch.kernels import splitk  # noqa: E402
from repro_torch.kernels.block_mm import study  # noqa: E402
from repro_torch.kernels.nm_spmm import ops as nm_ops  # noqa: E402

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


#: the chip_smoke cells: qwen2-0.5b decode at batch 8 (f32) and the
#: ffn_down shape at 128 rows (bf16), blocks of 64 at density 0.25
CHIP_CELLS = {"ffn_gate_up": (8, 896, 9728, torch.float32),
              "lm_head": (8, 896, 151936, torch.float32),
              "ffn_down": (128, 4864, 896, torch.bfloat16)}


def _cell_lists(M, K, N):
    """The chip cells' full and nonzero block lists, as validate_fleet
    draws them (host data only)."""
    x = block_cell_inputs(M, K, N, density=0.25, bs=64, seed=0,
                          device="cpu")
    return x, {name: block_list(*x[name], x["mask"].shape, "cpu")
               for name in ("full", "nonzero")}


def test_plan_fills_the_card_at_the_chip_cells():
    """About two waves of blocks on 132 SMs at ffn_gate_up (the first
    kernels had 1.15) and ffn_down, on the narrow path in f32 and the
    wide one in bf16; lm_head's 2374 column tiles without a split."""
    M, K, N, dt = CHIP_CELLS["ffn_gate_up"]
    _, lists = _cell_lists(M, K, N)
    gate = ops.plan(M, K, N, 8, 64, 64, dt, 132)
    assert gate.path == "narrow" and gate.kernel == "narrow"
    assert gate.grid == (2, 1, 152) and gate.slice_blocks == 7
    assert gate.waves(132) >= 2 and gate.tile == (8, 64)
    full = ops.plan(M, K, N, 8, 64, 64, dt, 132, lists["full"].max_run)
    assert full == gate
    skip = ops.plan(M, K, N, 8, 64, 64, dt, 132, lists["nonzero"].max_run)
    assert (skip.split, skip.slice_blocks) == (2, 5)
    M, K, N, dt = CHIP_CELLS["lm_head"]
    head = ops.plan(M, K, N, 8, 64, 64, dt, 132)
    assert head.grid == (1, 1, 2374) and head.slice_blocks == 14
    M, K, N, dt = CHIP_CELLS["ffn_down"]
    _, lists = _cell_lists(M, K, N)
    down = ops.plan(M, K, N, 64, 64, 64, dt, 132)
    assert down.path == "wide" and down.kernel == "wide128"
    assert down.grid == (16, 1, 14) and down.tile == (128, 64)
    assert down.slice_blocks == 5 and down.waves(132) >= 1.5
    skip = ops.plan(M, K, N, 64, 64, 64, dt, 132, lists["nonzero"].max_run)
    assert (skip.split, skip.slice_blocks) == (16, 2)


def test_plan_split_follows_the_sm_count():
    M, K, N, dt = CHIP_CELLS["ffn_gate_up"]
    small = ops.plan(M, K, N, 8, 64, 64, dt, sms=16)
    assert small.split == 1 and small.blocks >= 2 * 16
    card = ops.plan(M, K, N, 8, 64, 64, dt, sms=132)
    assert (card.split, card.blocks) == (2, 304)
    big = ops.plan(M, K, N, 8, 64, 64, dt, sms=528)
    assert (big.split, big.slice_blocks) == (8, 2)


@pytest.mark.parametrize("run,split,slice_blocks", [
    (1, 1, 1), (2, 2, 1), (3, 2, 2), (5, 4, 2), (26, 16, 2),
    (76, 16, 5)])
def test_plan_split_follows_the_run_length(run, split, slice_blocks):
    """K1's split comes from its own list's longest run: never more
    slices than that run has blocks, so a short nonzero list does not
    take the full list's split (ffn_down's grid asks for 16)."""
    M, K, N, dt = CHIP_CELLS["ffn_down"]
    p = ops.plan(M, K, N, 64, 64, 64, dt, 132, run)
    assert (p.split, p.slice_blocks) == (split, slice_blocks)
    assert p.grid == (split, 1, 14)


def test_block_list_keeps_its_longest_run():
    mask = np.zeros((6, 4), np.int32)
    mask[:, 1] = 1             # a full column
    mask[2, 2] = 1             # one block; columns 0 and 3 get dummies
    ki, ji = block_indices(mask)
    blocks = block_list(ki, ji, mask.shape, "cpu")
    assert blocks.max_run == 6
    one = block_list(*block_indices(np.eye(4, dtype=np.int32)), (4, 4),
                     "cpu")
    assert one.max_run == 1
    # a list may name a block twice (both count); its run is 2
    twice = block_list([0, 0], [0, 0], (1, 1), "cpu")
    assert twice.max_run == 2 and ops.plan(8, 32, 32, 8, 32, 32,
                                           torch.float32, 132, 2).split == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_takes_every_tile_the_wrapper_took(dtype):
    """Every (bm, bk, bn) the kernels took before has a plan: slices of
    whole blocks that cover the run (the last not empty for the longest
    column), a tile that never spans two column blocks, a power-of-two
    split within one cluster."""
    for bm in ops._KERNEL_BM:
        for bk in (32, 64, 96, 128, 256):
            for bn in ops._KERNEL_BN:
                for M in {bm, 2 * bm, 128}:
                    K, N = 3 * bk, 4 * bn
                    for run in (None, 1, 2, 3):
                        p = ops.plan(M, K, N, bm, bk, bn, dtype, 132, run)
                        r = K // bk if run is None else run
                        assert 1 <= p.split <= min(ops.MAX_SPLIT, r)
                        assert p.split & (p.split - 1) == 0
                        assert (p.split - 1) * p.slice_blocks < r \
                            <= p.split * p.slice_blocks
                        assert bn % p.tile[1] == 0
                        assert p.grid[2] * p.tile[1] == N
                        assert p.grid[1] * p.tile[0] >= M
                        assert p.kernel in ops.KERNELS


@pytest.mark.parametrize("bm,bk,bn", [(12, 64, 64), (8, 48, 64),
                                      (8, 64, 16), (256, 64, 64),
                                      (8, 16, 32)])
def test_plan_raises_where_the_kernels_cannot_go(bm, bk, bn):
    """What ``_check_cuda`` refuses, the plan refuses too."""
    with pytest.raises(ValueError, match="the kernel takes"):
        ops.plan(768, 768, 768, bm, bk, bn, torch.float32)
    with pytest.raises(ValueError, match="the kernel takes"):
        ops.plan(24, 64, 64, 16, 32, 32, torch.float32)   # M % bm


@pytest.mark.parametrize("tiles,sms,aim", [
    (152, 132, 2), (14, 132, 16), (2374, 132, 1), (152, 16, 1),
    (152, 528, 8), (1, 132, 16), (264, 132, 1), (263, 132, 2)])
def test_split_policy_is_shared_with_k3(tiles, sms, aim):
    """K1/K2 and K3 plan their split from one policy
    (``splitk.split_aim``: the first power of two of slices that gives two
    waves, at most 16), and their plans share its fields."""
    assert splitk.split_aim(tiles, sms) == aim
    assert issubclass(ops.Plan, splitk.SplitPlan)
    assert issubclass(nm_ops.Plan, splitk.SplitPlan)
    assert ops.sm_count is nm_ops.sm_count is splitk.sm_count
    # a run long enough, and a row of 64 column tiles of 64 (N = 4096)
    p = ops.plan(8, 64 * 32, 64 * tiles, 8, 64, 64, torch.float32, sms)
    assert p.split == aim and p.grid[2] == tiles
    # K3 aims at the same split where whole stages allow it
    q = nm_ops.plan(8, 4 * 256, 256 * tiles, 2, 4, torch.float32, sms)
    assert q.split == aim and q.grid[2] == tiles


@pytest.mark.parametrize("cell", list(CHIP_CELLS))
def test_study_cuts_splits_as_the_plan_does(cell):
    """``study.py`` launches the plan's split and the others it times
    with the slices the plan would give them, on the chip cells."""
    M, K, N, dt = CHIP_CELLS[cell]
    assert (cell, M, K, N, dt) in study.CELLS
    _, lists = _cell_lists(M, K, N)
    for run in (lists["nonzero"].max_run, lists["full"].max_run, K // 64,
                1, 3, 5):
        p = ops.plan(M, K, N, min(64, M), 64, 64, dt, 132, run)
        assert study.slices(run, p.split) == (p.split, p.slice_blocks)
        for aim in study.SPLITS:
            split, cap = study.slices(run, aim)
            assert split <= min(aim, run) and split & (split - 1) == 0
            assert run <= split * cap < run + split
    rows = [{"cell": cell, "op": "skip", "split": s, "plan_split": 2,
             "ms": ms} for s, ms in ((1, 3.0), (2, 2.0), (4, 1.0))]
    assert study.best_splits(rows) == {f"{cell}/skip": {
        "plan_split": 2, "plan_ms": 2.0, "best_split": 4, "best_ms": 1.0}}


@pytest.mark.parametrize("M", [8, 16, 32, 40, 64, 128, 512])
def test_plan_f32_never_takes_the_tensor_cores(M):
    assert ops.plan(M, 896, 9728, 8, 64, 64, torch.float32).path \
        == "narrow"
    p = ops.plan(M, 4864, 896, 8, 64, 64, torch.bfloat16)
    assert p.path == ("wide" if M > ops.NARROW_MAX_M else "narrow")
    assert p.kernel == ("narrow" if M <= 32 else "wide128")


# ---------------------------------------------------------------------
# On the card

#: K1/K2 against their plain versions, relative to the largest
#: magnitude, for f32 and bf16 alike: both sides multiply the same inputs
#: in f32 (a product of two bf16 is exact in f32) and sum in f32, so only
#: the order of the sums differs
CARD_TOL = 1e-5


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _card_case(M, K, N, mask, dtype, bk, bn, seed):
    """A, W and W with its masked blocks zeroed, on the card."""
    dev = _cuda()
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    keep = torch.from_numpy(mask).repeat_interleave(bk, 0) \
        .repeat_interleave(bn, 1).to(w.dtype)
    return (a.to(dev, dtype), w.to(dev, dtype), (w * keep).to(dev, dtype),
            torch.from_numpy(mask).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bm", [8, 64, 128])
def test_cuda_kernels_match_plain_versions(dtype, bm):
    """On the card: K1 and K2 against their plain versions (1e-5 of the
    largest magnitude, f32 and bf16), and each launch counted."""
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
        assert err <= CARD_TOL
    assert ops.BUILD_DIR.name == "repro_torch"


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["skip", "full", "gate"])
@pytest.mark.parametrize("cell", sorted(CHIP_CELLS))
def test_cuda_chip_cells_full_size(cell, which):
    """The chip_smoke cells at full size: K1 on the nonzero and on the
    full list, K2 on the mask, against the plain versions at 1e-5 of the
    largest magnitude, one launch counted, on the path and split the
    plan names (split > 1 at ffn_gate_up and ffn_down)."""
    dev = _cuda()
    M, K, N, dt = CHIP_CELLS[cell]
    x, lists = _cell_lists(M, K, N)
    a, w, wm = (x[k].to(dev, dt) for k in ("a", "w", "wm"))
    mask = torch.as_tensor(x["mask"].astype(np.int32), device=dev)
    kw = dict(bm=64, bk=64, bn=64)
    if which == "gate":
        run, wrapper = None, gated_mm
        got = gated_mm(a, w, mask, **kw)
        want = gated_mm_plain(a, w, mask, **kw)
    else:
        lst = lists["nonzero" if which == "skip" else "full"]
        run, wrapper, w_in = lst.max_run, skip_mm, wm if which == "skip" \
            else w
        before = skip_mm.launches
        got = skip_mm(a, w_in, block_list(lst.kidx, lst.jidx, lst.shape,
                                          dev), **kw)
        assert skip_mm.launches == before + 1
        want = skip_mm_plain(a, w_in, lst.kidx, lst.jidx, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches > 0
    assert _rel_err(got, want) <= CARD_TOL
    p = ops.plan(M, K, N, min(64, M), 64, 64, dt, ops.sm_count(dev), run)
    assert p.path == ("wide" if dt == torch.bfloat16 else "narrow")
    assert (p.split > 1) == (cell != "lm_head")


@pytest.mark.gpu
@pytest.mark.parametrize("M,dtype", [(8, torch.float32),
                                     (16, torch.bfloat16),
                                     (40, torch.bfloat16),
                                     (128, torch.bfloat16)])
@pytest.mark.parametrize("bn", [32, 64])
def test_cuda_uneven_runs(M, dtype, bn):
    """Columns whose runs differ inside one launch: an empty column (its
    dummy (0, j) entry over a zeroed W block), a column with every k
    block, a column of one block (shorter than the split, so most of its
    slices are empty) and random ones; K1 and K2 against their plain
    versions, narrow and wide (M = 40: a partial 128-row tile)."""
    bk, nbk, nbn = 64, 14, 8
    K, N = bk * nbk, bn * nbn
    mask = (np.random.default_rng(M + bn).random((nbk, nbn)) < 0.3
            ).astype(np.int32)
    mask[:, 0] = 0
    mask[:, 1] = 1
    mask[:, 2] = 0
    mask[5, 2] = 1
    a, w, wm, m = _card_case(M, K, N, mask, dtype, bk, bn, M)
    ki, ji = block_indices(mask)
    blocks = block_list(ki, ji, mask.shape, a.device)
    assert blocks.max_run == nbk
    p = ops.plan(M, K, N, 8, bk, bn, dtype, ops.sm_count(a.device),
                 blocks.max_run)
    assert p.split > 1 and p.tile[1] == bn
    kw = dict(bm=8, bk=bk, bn=bn)
    got_s = skip_mm(a, wm, blocks, **kw)
    got_g = gated_mm(a, w, m, **kw)
    want = skip_mm_plain(a, wm, ki, ji, **kw)
    torch.cuda.synchronize()
    assert _rel_err(got_s, want) <= CARD_TOL
    assert _rel_err(got_g, want) <= CARD_TOL
    assert torch.equal(got_s[:, :bn], torch.zeros_like(got_s[:, :bn]))
    assert torch.equal(got_g[:, :bn], torch.zeros_like(got_g[:, :bn]))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["ffn_gate_up", "ffn_down"])
def test_cuda_repeat_launches_are_bit_identical(cell):
    """The split-K partials are summed in a fixed order: two launches on
    the same inputs give the same bits, K1 and K2."""
    dev = _cuda()
    M, K, N, dt = CHIP_CELLS[cell]
    x, lists = _cell_lists(M, K, N)
    a, w, wm = (x[k].to(dev, dt) for k in ("a", "w", "wm"))
    mask = torch.as_tensor(x["mask"].astype(np.int32), device=dev)
    nz = lists["nonzero"]
    blocks = block_list(nz.kidx, nz.jidx, nz.shape, dev)
    kw = dict(bm=64, bk=64, bn=64)
    assert ops.plan(M, K, N, min(64, M), 64, 64, dt, ops.sm_count(dev),
                    nz.max_run).split > 1
    for fn in (lambda: skip_mm(a, wm, blocks, **kw),
               lambda: gated_mm(a, w, mask, **kw)):
        first, again = fn(), fn()
        torch.cuda.synchronize()
        assert torch.equal(first, again)


@pytest.mark.gpu
@pytest.mark.parametrize("gate", [False, True])
def test_cuda_each_variant_has_no_local_memory(gate):
    """Every variant the library holds: no registers spilled to local
    memory, at least one block resident per SM, 32-row stages; and each
    path reached through the wrapper, one launch per call."""
    dev = _cuda()
    for kernel, dtype in (("narrow", torch.float32),
                          ("narrow", torch.bfloat16),
                          ("wide128", torch.bfloat16)):
        for tn in (32, 64):
            info = ops.kernel_info(kernel, tn, dtype, gate)
            assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1
            assert info["stage_rows"] == ops.STAGE_ROWS
    for M, dtype, kernel in ((8, torch.float32, "narrow"),
                             (32, torch.bfloat16, "narrow"),
                             (64, torch.bfloat16, "wide128"),
                             (128, torch.bfloat16, "wide128")):
        mask = np.ones((4, 4), np.int32)
        a, w, _, m = _card_case(M, 256, 256, mask, dtype, 64, 64, M)
        assert ops.plan(M, 256, 256, 8, 64, 64, dtype).kernel == kernel
        wrapper = gated_mm if gate else skip_mm
        before = wrapper.launches
        got = (gated_mm(a, w, m, bm=8, bk=64, bn=64) if gate else
               skip_mm(a, w, *block_indices(mask), bm=8, bk=64, bn=64))
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert _rel_err(got, a.float() @ w.float()) <= CARD_TOL
    assert dev.type == "cuda"


@pytest.mark.gpu
def test_cuda_views_at_an_odd_offset_are_still_taken():
    """A contiguous view that does not start 16-byte aligned is copied
    to fresh storage before the launch, not refused."""
    dev = _cuda()
    flat = torch.randn(8 * 64 + 1, device=dev)
    a = flat[1:].view(8, 64)
    assert a.data_ptr() % 16
    w = torch.randn(64, 64, device=dev)
    mask = np.ones((1, 1), np.int32)
    got = skip_mm(a, w, *block_indices(mask), bm=8, bk=64, bn=64)
    got_g = gated_mm(a, w, mask, bm=8, bk=64, bn=64)
    torch.cuda.synchronize()
    want = a @ w
    assert _rel_err(got, want) <= CARD_TOL
    assert _rel_err(got_g, want) <= CARD_TOL
