"""The first two slices of the port as a whole, at a small size.

Slice 1: the port's mapspace search (batched engine on ``device="cpu"``)
finds the same winner as the JAX package's scalar search on a
permutation-constrained matmul under ``scnn_like(three_level_arch())``;
the port's block-arm predictions equal the JAX package's scalar oracle
on ``edge_mapping``; and the port's block-cell measurement draws the
same blocks as the JAX package's for the same seed.

Slice 2: the N:M path on a reduced config — ``validate_fleet`` with all
five arms picks the reference's cells, its block predictions and
advisor verdicts equal the JAX package's scalar oracle, and its N:M
measurements equal the JAX package's ``_measure_nm_cell``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Sparseloop as RefSparseloop  # noqa: E402
from repro.core import matmul as ref_matmul  # noqa: E402
from repro.core import presets as ref_presets  # noqa: E402
from repro.core.mapper import MapspaceConstraints as RefCons  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.advisor import tpu_mapping as ref_tpu_mapping  # noqa: E402
from repro.core.mapper import search as ref_search  # noqa: E402
from repro.fleet import extract as ref_extract  # noqa: E402
from repro.fleet import sweep as ref_sweep  # noqa: E402
from repro.fleet import validate as ref_validate  # noqa: E402
from repro_torch.core import compile_stats  # noqa: E402
from repro_torch.core.batched import clear_caches  # noqa: E402
from repro_torch.core.mapper import MapspaceConstraints, search  # noqa: E402
from repro_torch.fleet import validate  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

PERMS = {0: ("n", "k", "m"), 1: ("m", "n", "k"), 2: ("m", "n", "k")}
LAYERS = ((16, 24, 16, 0.4, 0.55), (8, 36, 32, 0.3, 0.45))


def test_search_matches_reference_scalar_search():
    """Whole mapspace of two small layers, one program for both."""
    ref_design = ref_presets.scnn_like(ref_presets.three_level_arch())
    design = from_reference(ref_design)
    clear_caches()
    with compile_stats.track() as st:
        for M, K, N, da, db in LAYERS:
            dens = {"A": ("uniform", da), "B": ("uniform", db)}
            ref_wl = ref_matmul(M, K, N, densities=dens)
            cons = dict(seed=0, spatial={1: {"n": 8}}, permutations=PERMS,
                        budget=10 ** 6)
            want = ref_search(ref_design, ref_wl, RefCons(**cons),
                              use_batched=False)
            got = search(design, from_reference(ref_wl),
                         MapspaceConstraints(**cons), device="cpu")
            assert got.best_nest == from_reference(want.best_nest)
            assert got.best.edp == pytest.approx(want.best.edp, rel=1e-9)
            assert (got.evaluated, got.valid) == (want.evaluated,
                                                  want.valid)
            assert got.evaluated > 500
    assert st.programs == 1 and st.program_shares == len(LAYERS) - 1
    assert st.scalar_evals == 0


def test_predict_block_matches_reference_scalar_oracle():
    cells = [(8, 512, 512), (8, 896, 1024)]
    got = validate._predict_block(cells, density=0.25, device="cpu")
    designs = {"dense": ref_presets.dense_design(
                   ref_presets.two_level_arch()),
               "skip": ref_validate.block_skip_design(),
               "gate": ref_validate.block_gate_design()}
    for name, des in designs.items():
        assert from_reference(des) == {
            "dense": from_reference(des),
            "skip": validate.block_skip_design(),
            "gate": validate.block_gate_design()}[name]
        for i, (M, K, N) in enumerate(cells):
            d = None if name == "dense" else {"B": ("uniform", 0.25)}
            ev = RefSparseloop(des).evaluate(
                ref_matmul(M, K, N, densities=d),
                ref_validate.edge_mapping(M, K, N), check_capacity=False)
            assert got[name][i] == pytest.approx(ev.cycles, rel=1e-6)
    # the model's claims: skip saves time, gate does not
    assert got["dense"][0] / got["skip"][0] > validate.WIN_THRESHOLD
    assert got["dense"][0] / got["gate"][0] < validate.WIN_THRESHOLD


def test_measure_block_cell_draws_the_reference_blocks():
    cell = validate.kernel_cell(8, 512, 512, bs=64)
    assert cell == ref_validate.kernel_cell(8, 512, 512, bs=64)
    got = validate._measure_block_cell(*cell, density=0.25, bs=64, reps=1,
                                       device="cpu")
    want = ref_validate._measure_block_cell(*cell, density=0.25, bs=64,
                                            reps=1)
    assert (got["nnzb"], got["blocks"]) == (want["nnzb"], want["blocks"])
    assert got["err"] <= 1e-4 and want["err"] <= 1e-4
    rows = validate.block_rows("cfg", "layer", cell, got, 4.0, 1.0, 4.0)
    assert [r.arm for r in rows] == list(validate.BLOCK_ARMS)
    assert "3/3 rows agree" in validate.agreement_summary(rows) or \
        "DISAGREE" in validate.agreement_summary(rows)
    for k in ("skip-time", "gate-time", "skip-vs-gate"):
        assert k in validate.ALL_ARMS


def test_block_cell_inputs_match_reference_draws():
    x = validate.block_cell_inputs(8, 128, 256, density=0.3, bs=64,
                                   seed=5, device="cpu")
    rng = np.random.default_rng(5)
    a = rng.standard_normal((8, 128)).astype(np.float32)
    w = rng.standard_normal((128, 256)).astype(np.float32)
    mask = rng.random((2, 4)) < 0.3
    mask[0, :] = True
    np.testing.assert_array_equal(x["a"].numpy(), a)
    np.testing.assert_array_equal(x["w"].numpy(), w)
    np.testing.assert_array_equal(x["mask"], mask)
    wm = (w.reshape(2, 64, 4, 64) * mask[:, None, :, None]).reshape(128, 256)
    np.testing.assert_array_equal(x["wm"].numpy(), wm)


def _ref_cells(name, *, reduced, batch=8, seq_len=256, bs=64, min_dim=128):
    """The cells the reference's ``validate_fleet`` picks: the top two
    weight matmuls by FLOPs at decode, padded by ``kernel_cell``."""
    net = ref_extract.extract_network(ref_get_config(name, reduced=reduced),
                                      "decode", seq_len=seq_len, batch=batch)
    top = sorted(net.weight_matmuls(), key=lambda e: e.flops,
                 reverse=True)[:2]
    return [(e.name, ref_validate.kernel_cell(e.M, e.K, e.N, bs=bs,
                                              min_dim=min_dim))
            for e in top]


def test_nm_slice_validate_fleet_all_arms_matches_reference():
    rows = validate.validate_fleet(("qwen2-0.5b",), reduced=True,
                                   arms=validate.ALL_ARMS, reps=1,
                                   min_dim=128, device="cpu")
    cells = _ref_cells("qwen2-0.5b", reduced=True)
    assert len(rows) == 5 * len(cells) == 10
    assert [(r.layer, (r.M, r.K, r.N)) for r in rows[::5]] == cells
    assert [r.arm for r in rows[:5]] == list(validate.ALL_ARMS)
    preds = validate._predict_block([c for _, c in cells], density=0.25,
                                    device="cpu")
    dense_opt, nm_opt = ref_sweep.default_options(((2, 4),))
    for r in rows:
        i = [c for _, c in cells].index((r.M, r.K, r.N))
        if r.arm == "skip-time":
            assert r.predicted == preds["dense"][i] / preds["skip"][i]
        elif r.arm == "nm-traffic":
            # the advisor's verdict (decode-like shard, tp=1) against the
            # reference's scalar oracle on the layer's unsharded shape
            e = next(e for e in ref_extract.extract_network(
                ref_get_config("qwen2-0.5b", reduced=True), "prefill",
                seq_len=8, batch=1).weight_matmuls() if e.name == r.layer)
            nest = ref_tpu_mapping(*e.shape)
            nest = type(nest)(loops=tuple(lp for lp in nest.loops
                                          if lp.bound > 1),
                              num_levels=nest.num_levels)
            d, s_ = (RefSparseloop(o.design).evaluate(
                ref_matmul(*e.shape, densities=o.densities), nest,
                check_capacity=False).cycles for o in (dense_opt, nm_opt))
            want = d / s_ if s_ * ref_sweep.WIN_MARGIN < d else 1.0
            assert r.predicted == pytest.approx(want, rel=1e-6)
            assert r.measured == 1 / 0.53125 and r.agree
        elif r.arm == "nm-correct":
            want = ref_validate._measure_nm_cell(r.M, r.K, r.N, n=2, m=4,
                                                 reps=1)
            assert r.measured < 1e-5 and want["err"] < 1e-5 and r.agree
    # the block arms' model side agrees with the scalar oracle already
    # (test_predict_block_matches_reference_scalar_oracle); here the
    # summary reports every arm
    summary = validate.agreement_summary(rows)
    for arm in validate.ALL_ARMS:
        assert arm in summary
