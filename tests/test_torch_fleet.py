"""The port's fleet path against the JAX package's, on the CPU.

Four groups:

* **configs** — all 20 configs (10 architectures, full and reduced)
  equal to the reference's field by field, with equal ``param_count``;
* **extraction and sharding** — ``extract_network`` / ``shard_entries``
  entries equal to the reference's for every config x phase x reduced,
  unsharded and under three meshes, and ``resolve_spec`` equal on a
  table of specs (the JAX extractor runs here);
* **sweep, advisor and compile accounting** — ``fleet_sweep`` and
  ``advise`` on ``device="cpu"`` within 1e-6 of the reference's
  *scalar* oracle (the JAX batched engine does not import under the
  installed jax), and the program count within ``compile_bound``;
* **deterministic arms** — ``validate_fleet(..., arms=
  DETERMINISTIC_ARMS, device="cpu")`` agrees on every row, and its
  bytes ratio and kernel error match the JAX package's
  ``_measure_nm_cell`` on the same cells.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.advisor import tpu_mapping as ref_tpu_mapping  # noqa: E402
from repro.core.engine import Sparseloop as RefSparseloop  # noqa: E402
from repro.core.workload import matmul as ref_matmul  # noqa: E402
from repro.fleet import extract as ref_extract  # noqa: E402
from repro.fleet import sweep as ref_sweep  # noqa: E402
from repro.fleet import validate as ref_validate  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.core import compile_stats  # noqa: E402
from repro_torch.core.advisor import (LayerAdvice, advise,  # noqa: E402
                                      describe, fleet_report)
from repro_torch.fleet import extract, sweep  # noqa: E402
from repro_torch.fleet.validate import (DETERMINISTIC_ARMS,  # noqa: E402
                                        validate_fleet)
from repro_torch.interop import from_reference  # noqa: E402
from repro_torch.launch.mesh import dp_size, production_mesh_shape  # noqa: E402
from repro_torch.launch.sharding import P, resolve_spec  # noqa: E402

ALL_CONFIGS = [(name, reduced) for name in ARCH_NAMES
               for reduced in (False, True)]
IDS = [f"{n}{'-reduced' if r else ''}" for n, r in ALL_CONFIGS]
MESHES = {
    "production": ((("data", 16), ("model", 16))),
    "multi-pod": ((("pod", 2), ("data", 16), ("model", 16))),
    "odd": ((("data", 3), ("model", 7))),
}
REL = 1e-6


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,reduced", ALL_CONFIGS, ids=IDS)
def test_config_equals_reference(name, reduced):
    assert ARCH_NAMES == REF_ARCH_NAMES
    ref = ref_get_config(name, reduced=reduced)
    got = get_config(name, reduced=reduced)
    assert got == from_reference(ref)
    for f in dataclasses.fields(ref):
        want = getattr(ref, f.name)
        have = getattr(got, f.name)
        if dataclasses.is_dataclass(want):
            assert dataclasses.asdict(have) == dataclasses.asdict(want)
        else:
            assert have == want, f.name
    assert got.param_count() == ref.param_count()
    assert (got.q_dim, got.kv_dim, got.sub_quadratic) == (
        ref.q_dim, ref.kv_dim, ref.sub_quadratic)
    for layer in range(got.num_layers):
        assert got.block_kind(layer) == ref.block_kind(layer)
        assert got.is_moe_layer(layer) == ref.is_moe_layer(layer)


# ----------------------------------------------------------------------
# extraction and sharding
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name,reduced", ALL_CONFIGS, ids=IDS)
def test_extraction_equals_reference(name, reduced):
    cfg = get_config(name, reduced=reduced)
    ref_cfg = ref_get_config(name, reduced=reduced)
    for phase in ("prefill", "decode"):
        for kw in (dict(), dict(seq_len=32, batch=2)):
            want = ref_extract.extract_network(ref_cfg, phase, **kw)
            got = extract.extract_network(cfg, phase, **kw)
            assert got == from_reference(want)
            assert (got.total_params, got.total_flops) == (
                want.total_params, want.total_flops)
            for axes in MESHES.values():
                assert extract.shard_entries(
                    got, extract.MeshSpec(axes)) == from_reference(
                    ref_extract.shard_entries(
                        want, ref_extract.MeshSpec(axes)))
    prefill = extract.extract_network(cfg, "prefill", seq_len=32, batch=2)
    assert prefill.total_params == cfg.param_count()


def test_extract_fleet_and_mesh_equal_reference():
    mesh = extract.production_mesh_spec()
    assert mesh == from_reference(ref_extract.production_mesh_spec())
    assert mesh.axes == production_mesh_shape() and mesh.size == 256
    assert dp_size(mesh) == 16
    assert dp_size(extract.production_mesh_spec(multi_pod=True)) == 32
    got = extract.extract_fleet(ARCH_NAMES, mesh=mesh)
    want = ref_extract.extract_fleet(REF_ARCH_NAMES,
                                     mesh=ref_extract.production_mesh_spec())
    assert got == from_reference(want)
    flat = [e for net in got for e in net.matmuls]
    # the full-width fleet under the production mesh, prefill + decode
    assert len(flat) == 178
    assert len(sweep.dedupe_shapes(flat)[0]) == 142
    with pytest.raises(KeyError):
        get_config("no-such-arch")


SPECS = [(), ("data",), ("model",), (None, "model"), ("data", "model"),
         ("model", None), (("data", "model"),), ("data", None, "model"),
         (("pod", "data"), "model"), (None, None)]
SHAPES = [(48,), (12, 8), (7, 16), (32, 21, 9), (256, 512, 64)]


@pytest.mark.parametrize("mesh", sorted(MESHES) + ["pods-small"])
def test_resolve_spec_equals_reference(mesh):
    axes = MESHES.get(mesh, (("pod", 2), ("data", 3), ("model", 4)))
    port_mesh, ref_mesh = (extract.MeshSpec(axes),
                           ref_extract.MeshSpec(axes))
    names = {a for a, _ in axes}
    for spec in SPECS:
        used = {a for e in spec if e for a in (e if isinstance(e, tuple)
                                              else (e,))}
        if not used <= names:
            continue
        for shape in SHAPES:
            got = resolve_spec(P(*spec), shape, port_mesh)
            want = ref_sharding.resolve_spec(RefP(*spec), shape, ref_mesh)
            assert isinstance(got, P)
            assert tuple(got) == tuple(want), (spec, shape)
    assert resolve_spec(None, (4,), port_mesh) == P()


# ----------------------------------------------------------------------
# sweep, advisor, compile accounting
# ----------------------------------------------------------------------
def _scalar(design, densities, M, K, N) -> dict:
    """The reference's scalar oracle on ``tpu_mapping(M, K, N)`` with its
    unit-bound loops dropped.  That is the batched engines' lowering
    contract (``core/batched.py``: a bound-1 slot is treated exactly as
    an absent loop, and ``NestTemplate.nest_with`` drops it), which the
    JAX package's batched engine follows too: the scalar oracle on the
    nest *with* its unit loops counts them in the reuse prefix and reads
    up to a few percent higher on some shapes (ROADMAP, Queue 3)."""
    nest = ref_tpu_mapping(M, K, N)
    nest = dataclasses.replace(
        nest, loops=tuple(lp for lp in nest.loops if lp.bound > 1))
    ev = RefSparseloop(design).evaluate(
        ref_matmul(M, K, N, densities=densities), nest,
        check_capacity=False)
    return {"cycles": ev.cycles, "energy_pj": ev.energy_pj, "edp": ev.edp}


def _close(got: dict, want: dict) -> None:
    for k in ("cycles", "energy_pj", "edp"):
        assert got[k] == pytest.approx(want[k], rel=REL), k


def test_options_equal_reference():
    for got, want in zip(sweep.default_options(((2, 4), (2, 8), (4, 8))),
                         ref_sweep.default_options(((2, 4), (2, 8),
                                                    (4, 8)))):
        assert got.design == from_reference(want.design)
        assert (got.name, got.densities, got.weights_only) == (
            want.name, want.densities, want.weights_only)


def test_full_fleet_sweep_matches_scalar_oracle():
    """Every row and option of the full-width sweep (10 configs,
    prefill + decode, production mesh) within 1e-6 of the oracle."""
    ref_opts = {o.name: o for o in ref_sweep.default_options()}
    with compile_stats.track() as st:
        rep = sweep.fleet_sweep(ARCH_NAMES, device="cpu")
    assert (rep.total_entries, rep.unique_shapes) == (178, 142)
    assert st.programs <= rep.compile_bound == len(rep.option_names)
    assert st.compiles <= rep.compile_bound and st.scalar_evals == 0
    cache: dict = {}
    for r in rep.rows:
        for name, got in r.options.items():
            key = (name, r.M, r.K, r.N)
            if key not in cache:
                o = ref_opts[name]
                cache[key] = _scalar(o.design, o.densities, r.M, r.K, r.N)
            _close(got, cache[key])
        # attention (activation x activation) rows are evaluated dense only
        nm = [v["cycles"] for k, v in r.options.items() if k != "dense"]
        compress = bool(nm) and min(nm) * sweep.WIN_MARGIN < r.dense_cycles
        assert r.verdict == ("compress" if compress else "dense")
        assert r.speedup >= 1.0


def test_reduced_sweep_compile_accounting():
    names = ("qwen3-4b", "qwen3-4b")
    with compile_stats.track() as st:
        rep = sweep.fleet_sweep(names, reduced=True, seq_len=32, batch=2,
                                device="cpu")
    assert st.programs <= rep.compile_bound == len(rep.option_names)
    assert st.compiles <= rep.compile_bound
    assert st.scalar_evals == 0 and st.dedup_evals > 0
    assert rep.total_entries == len(rep.rows)
    assert rep.unique_shapes <= rep.total_entries
    for r in rep.rows:
        assert r.options["dense"]["cycles"] == r.dense_cycles
        if r.verdict == "compress":
            assert r.best_cycles * sweep.WIN_MARGIN < r.dense_cycles
    assert f"(bound {rep.compile_bound})" in rep.summary()
    assert rep.to_json()["total_entries"] == rep.total_entries


def test_compile_bound_is_layer_count_independent():
    opts = sweep.default_options()
    few = extract.extract_network(get_config("qwen3-4b", reduced=True),
                                  "prefill", seq_len=16, batch=1).matmuls
    many = [e for name in ARCH_NAMES[:4] for e in extract.extract_network(
        get_config(name, reduced=True), "prefill", seq_len=16,
        batch=1).matmuls]
    assert (sweep.compile_bound(opts, few) == sweep.compile_bound(opts, many)
            == len(opts))


def test_crossover_matches_scalar_oracle():
    grid = (8, 64, 512)
    rep = fleet_report(("qwen3-4b",), reduced=True, phases=("decode",),
                       batch=16, crossover=True, crossover_grid=grid,
                       device="cpu")
    assert rep.crossover
    ref_opts = {o.name: o for o in ref_sweep.default_options()}
    dense = ref_opts["dense"]
    for kn, per_opt in rep.crossover.items():
        K, N = map(int, kn.split("x"))
        for name, last_win in per_opt.items():
            o = ref_opts[name]
            wins = [m for m in grid
                    if _scalar(o.design, o.densities, m, K, N)["cycles"]
                    * sweep.WIN_MARGIN
                    < _scalar(dense.design, None, m, K, N)["cycles"]]
            assert last_win == (wins[-1] if wins else None)


def test_advise_matches_scalar_oracle():
    cfg = get_config("qwen3-4b")
    ref_opts = ref_sweep.default_options()
    with compile_stats.track() as st:
        adv = advise(cfg, tokens_per_device=8, tp=16, device="cpu")
    assert st.scalar_evals == 0 and st.programs <= len(ref_opts)
    assert adv and all(isinstance(a, LayerAdvice) for a in adv)
    assert {"attn_qkv", "ffn_gate_up", "lm_head"} <= {a.layer for a in adv}
    bound = {"dense": 1.0, "nm-2:4": 1.0 / 0.5625,
             "nm-2:8": 1.0 / (0.25 * (1 + 3 / 32))}
    for a in adv:
        want = [_scalar(o.design, o.densities, a.M, a.K, a.N)
                for o in ref_opts]
        assert a.dense_cycles == pytest.approx(want[0]["cycles"], rel=REL)
        best = ("dense", want[0]["cycles"])
        for o, w in zip(ref_opts[1:], want[1:]):
            if w["cycles"] * sweep.WIN_MARGIN < best[1]:
                best = (o.name, w["cycles"])
        assert a.best_name == best[0]
        assert a.best_cycles == pytest.approx(best[1], rel=REL)
        assert 1.0 <= a.speedup <= bound[a.best_name] + 0.01
        assert a.dense_bottleneck in ("compute", "HBM")
    assert describe(adv).count("\n") == len(adv)


# ----------------------------------------------------------------------
# deterministic arms
# ----------------------------------------------------------------------
def test_validate_deterministic_arms_match_reference():
    rows = validate_fleet(("qwen3-4b", "xlstm-350m"),
                          arms=DETERMINISTIC_ARMS, reps=1, min_dim=128,
                          max_cells_per_config=1, device="cpu")
    assert rows and {r.arm for r in rows} == set(DETERMINISTIC_ARMS)
    bad = [r for r in rows if not r.agree]
    assert not bad, [r.as_dict() for r in bad]
    for r in rows:
        want = ref_validate._measure_nm_cell(r.M, r.K, r.N, n=2, m=4,
                                             reps=1)
        if r.arm == "nm-traffic":
            # 2:4 f32 packs to 0.53125x the dense bytes
            assert r.measured == 1.0 / want["bytes_ratio"] == 1 / 0.53125
            assert f"bytes_ratio={want['bytes_ratio']:.4f}" in r.detail
        else:
            assert r.measured < 1e-5 and want["err"] < 1e-5
            assert r.measured == pytest.approx(want["err"], abs=1e-6)
