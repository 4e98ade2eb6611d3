"""The configuration file's vocabulary (``harness/config.py``): what the
two cells' files build is what they built before densities and preset
arguments could be stated; a structured operand on a preset that builds
its own architecture reaches both sides and is judged; a file that
states something malformed is refused at load, naming where; and a
density kind is found by name in ``reference/kinds/``."""
import json
import math

import numpy as np
import pytest

from portbench.harness import judge, mappings
from portbench.harness.cell import run_cell
from portbench.harness.config import ROOT, Config
from portbench.reference import density as refdensity

CELL_CONFIGS = ("scnn-resnet50", "eyeriss-v2saf-mobilenet")
SEED = 2 ** 31 + 2929
SMALL = {"pop_size": 128, "generations": 4, "chunk": 2, "judge_share": 1.0,
         "judge_searches": 3, "judge_rows": 16}


def _as_before(raw, core, presets):
    """The design and workloads as the harness built them when every
    density was a number and every preset took the file's architecture."""
    spec = raw["design"]["arch"]
    levels = tuple(core.StorageLevel(
        lv["name"], math.inf if lv["capacity_words"] is None
        else float(lv["capacity_words"]),
        float(lv["bandwidth_words_per_cycle"]), float(lv["read_energy_pj"]),
        float(lv["write_energy_pj"]), float(lv["gated_energy_pj"]))
        for lv in spec["levels"])
    comp = spec["compute"]
    arch = core.Architecture(name=spec["name"], levels=levels,
                             compute=core.ComputeLevel(
                                 comp["name"], int(comp["instances"]),
                                 float(comp["mac_energy_pj"]),
                                 float(comp["gated_energy_pj"]),
                                 float(comp["throughput"])))
    design = getattr(presets, raw["design"]["preset"])(arch)
    workloads = [core.matmul(lay["M"], lay["K"], lay["N"], densities={
        t: ("uniform", float(d)) for t, d in lay["density"].items()},
        name=lay["name"]) for lay in raw["layers"]]
    return design, workloads


@pytest.mark.parametrize("side", ("program", "reference"))
@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_the_cells_build_what_they_built_before(name, side):
    if side == "program":
        from repro_torch import core
        from repro_torch.core import presets
    else:
        from portbench import reference as core
        presets = core.presets
    raw = json.loads((ROOT / "configs" / f"{name}.json").read_text())
    cfg = Config.load(name)
    design, workloads = _as_before(raw, core, presets)
    assert getattr(cfg, f"{side}_design")() == design
    build = getattr(cfg, f"{side}_workload")
    assert [build(lay) for lay in cfg.layers] == workloads


def test_each_kind_becomes_the_workloads_spec(stc_raw, write_config):
    raw = stc_raw
    raw["layers"][0]["density"] = {
        "A": {"kind": "banded", "half_band": 3}, "B": 0.25,
        "Z": {"kind": "uniform", "density": 1}}
    cfg = Config.load_file(write_config(raw).path)
    assert cfg.layers[0].densities == {
        "A": ("banded", {"half_band": 3, "rows": 2048, "cols": 1408}),
        "B": ("uniform", 0.25), "Z": ("uniform", 1.0)}
    assert cfg.layers[1].densities == {
        "A": ("structured", {"n": 2, "m": 4}), "B": ("dense", None)}
    wl = cfg.program_workload(cfg.layers[1])
    assert wl.densities == cfg.reference_workload(cfg.layers[1]).densities
    # the preset's SAFs and name, on the file's architecture
    for design in (cfg.program_design(), cfg.reference_design()):
        assert design.name == "stc-2:4-CP"
        assert design.level_names == ["RF", "SMEM", "HBM"]
        assert design.arch.compute.instances == 256


def test_the_stc_configuration_runs_and_is_correct(stc):
    """2:4 weights skipped at the RF, through the fused search on the
    CPU: the structured kind in the captured step, judged."""
    line, notes = run_cell(stc.cell, SEED, 1.0, False, device="cpu",
                           bench=stc.bench, overrides=SMALL)
    assert line["correct"], line["checks"]
    assert notes["rows_judged"] > 0 and notes["generations_judged"] > 0
    assert line["checks"]["metric_gap"]["value"] < 1e-12


def test_a_density_read_otherwise_by_the_reference_is_not_correct(
        stc, monkeypatch):
    """The program reads 2:4 weights, the reference uniform 0.5."""
    real = Config.reference_workload

    def uniform(self, layer):
        wl = real(self, layer)
        wl.densities["A"] = ("uniform", 0.5)
        return wl
    monkeypatch.setattr(Config, "reference_workload", uniform)
    line, _ = run_cell(stc.cell, SEED, 1.0, False, device="cpu",
                       bench=stc.bench, overrides=SMALL)
    assert not line["correct"]
    assert (line["checks"]["metric_gap"]["value"]
            > line["checks"]["metric_gap"]["limit"])


MALFORMED = {
    "unknown key": {"kind": "structured", "n": 2, "m": 4, "axis": 1},
    "missing n": {"kind": "structured", "m": 4},
    "missing m": {"kind": "structured", "n": 2},
    "n equal to m": {"kind": "structured", "n": 4, "m": 4},
    "n above m": {"kind": "structured", "n": 5, "m": 4},
    "n not whole": {"kind": "structured", "n": 1.5, "m": 4},
    "density 0": {"kind": "uniform", "density": 0},
    "density above 1": {"kind": "uniform", "density": 1.5},
    "number 0": 0.0,
    "number negative": -0.2,
    "number above 1": 1.01,
    "not a number": "0.5",
    "no kind": {"density": 0.5},
    "unknown kind": {"kind": "causal_band", "half_band": 8},
    "actual data": {"kind": "actual", "data": [[1, 0]]},
    "dense with a density": {"kind": "dense", "density": 1.0},
    "banded with rows": {"kind": "banded", "half_band": 2, "rows": 8},
    "banded negative": {"kind": "banded", "half_band": -1},
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_a_malformed_density_raises_at_load(case, stc_raw, write_config):
    stc_raw["layers"][1]["density"]["B"] = MALFORMED[case]
    path = write_config(stc_raw).path
    with pytest.raises(ValueError) as err:
        Config.load_file(path)
    msg = str(err.value)
    assert str(path) in msg and "'mla_kv_a_proj'" in msg and "'B'" in msg


def test_a_density_of_no_tensor_raises_at_load(stc_raw, write_config):
    stc_raw["layers"][0]["density"]["C"] = 0.5
    with pytest.raises(ValueError, match="moe_expert_down.*'C'"):
        Config.load_file(write_config(stc_raw).path)


REFUSED = {
    # (preset, preset_args, the argument the message names)
    # only the preset's own architecture: the file's arch states it
    "smem_bw": ("stc_like", {"n": 2, "m": 4, "smem_bw": 32.0}, "smem_bw"),
    "dstc smem_bw": ("dstc_like", {"smem_bw": 64.0}, "smem_bw"),
    "not an argument": ("stc_like", {"k": 4}, "k"),
    "arch": ("stc_like", {"arch": "sm-tc"}, "arch"),
    "arch of scnn": ("scnn_like", {"arch": None}, "arch"),
    # the TPU's levels (HBM, VMEM) are not all the file's
    "levels not the file's": ("tpu_nm_design", {"n": 2, "m": 4}, "VMEM"),
    "no preset": ("stc", {}, "stc"),
    "an architecture": ("tc_arch", {"name": "x"}, "tc_arch"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_refused_preset_argument_raises_at_load(case, stc_raw,
                                                 write_config):
    preset, args, named = REFUSED[case]
    stc_raw["design"]["preset"], stc_raw["design"]["preset_args"] = \
        preset, args
    path = write_config(stc_raw).path
    with pytest.raises(ValueError) as err:
        Config.load_file(path)
    msg = str(err.value)
    assert str(path) in msg and "design.preset" in msg and repr(named) in msg


def test_a_preset_on_levels_the_file_has_not_raises(write_config):
    """stc_like's SAFs name SMEM and RF; SCNN's file has DRAM, GLB and
    SPad."""
    raw = json.loads((ROOT / "configs" / "scnn-resnet50.json").read_text())
    raw["design"]["preset"] = "stc_like"
    with pytest.raises(ValueError, match="RF.*SMEM"):
        Config.load_file(write_config(raw).path)


UNIFORM_AGAIN = '''
import math


def _log_comb(n, k):
    if k < 0 or k > n or n < 0:
        return -math.inf
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


class Uniform:
    def __init__(self, tensor_size, density):
        self.tensor_size, self.density = tensor_size, density
        self.nnz = round(density * tensor_size)

    def expected_density(self, tile_size):
        return self.density

    def prob_empty(self, tile_size):
        S, N, T = self.tensor_size, self.nnz, min(tile_size, self.tensor_size)
        lp = _log_comb(S - N, T) - _log_comb(S, T)
        return math.exp(lp) if lp > -700 else 0.0

    def max_nnz(self, tile_size):
        return min(tile_size, self.nnz)


def model(params, tensor_size):
    return Uniform(tensor_size, float(params["density"]))
'''


def test_a_kind_found_by_name_answers_as_the_kind_it_copies(
        tmp_path, write_config, monkeypatch):
    """``kinds/uniform_again.py`` re-implements ``uniform``: the
    reference's answers on SCNN's file, with each operand's density
    stated through it, are the uniform ones; the program, which has no
    such kind, refuses it."""
    kinds = tmp_path / "kinds"
    kinds.mkdir()
    (kinds / "uniform_again.py").write_text(UNIFORM_AGAIN)
    monkeypatch.setattr(refdensity, "KINDS", kinds)
    raw = json.loads((ROOT / "configs" / "scnn-resnet50.json").read_text())
    for lay in raw["layers"]:
        lay["density"] = {t: {"kind": "uniform_again", "density": d}
                          for t, d in lay["density"].items()}
    named = Config.load_file(write_config(raw).path)
    assert named.layers[0].densities["A"] == (
        "uniform_again", {"density": 0.4, "rows": 3136, "cols": 576})
    cfg = Config.load("scnn-resnet50")
    want, got = judge.Reference(cfg), judge.Reference(named)
    design = cfg.reference_design()
    valid = 0
    for li, layer in enumerate(cfg.layers):
        ms = mappings.draw(cfg.reference_workload(layer).rank_bounds,
                           design.arch.num_levels, cfg.spatial(design), 24,
                           np.random.default_rng(300 + li))
        for c in range(len(ms)):
            loops = mappings.loops(ms, c)
            assert got.evaluate(li, loops) == want.evaluate(li, loops)
            valid += want.evaluate(li, loops)[0]
    assert valid > 0
    with pytest.raises(ValueError, match="uniform_again"):
        from repro_torch.core import LoopNest, Sparseloop
        Sparseloop(named.program_design(), device="cpu").evaluate(
            named.program_workload(named.layers[0]),
            LoopNest((), design.arch.num_levels))
