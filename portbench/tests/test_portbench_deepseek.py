"""DeepSeek-V2-Lite's prefill on STC-flexible-RLE (``configs/
deepseek-v2-lite-stc.json``): its shapes are the port's
``extract_network``'s, weights first, with layer 0's dense FFN from the
published config; it runs correct on the CPU, its causal ``attn_av``
judged, and its control and planted faults in ``attn_av``'s operand P
(read as uniform 0.5 or dense by the reference) do not.  A causal
density the file states malformed is refused at load, naming where."""
import json
import subprocess
import sys

import pytest

from portbench.harness import judge
from portbench.harness.cell import run_cell
from portbench.harness.config import ROOT, Config
from portbench.reference import density as refdensity

SEED = 2 ** 31 + 2929
SMALL = {"pop_size": 128, "generations": 4, "chunk": 2, "judge_share": 1.0,
         "judge_searches": 3, "judge_rows": 16}

MALFORMED = {
    "causal without window": {"kind": "causal"},
    "causal window 0": {"kind": "causal", "window": 0},
    "causal window not whole": {"kind": "causal", "window": 2.5},
    "causal with rows": {"kind": "causal", "window": 4, "rows": 8},
    "causal unknown key": {"kind": "causal", "window": 4, "side": "upper"},
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_a_malformed_causal_density_raises_at_load(case, stc_raw,
                                                    write_config):
    stc_raw["layers"][1]["density"]["A"] = MALFORMED[case]
    path = write_config(stc_raw).path
    with pytest.raises(ValueError) as err:
        Config.load_file(path)
    msg = str(err.value)
    assert str(path) in msg and "'mla_kv_a_proj'" in msg and "'A'" in msg


DEEPSEEK = "deepseek-v2-lite-stc"

#: ``extract_network``'s prefill GEMMs (activations first: tokens x in x
#: out), printed by a process of their own: importing the extraction
#: loads the kernel builder, which a benchmark run refuses afterwards
EXTRACT = """
import json
from repro_torch.configs.deepseek_v2_lite_16b import CONFIG
from repro_torch.fleet.extract import extract_network
net = extract_network(CONFIG, "prefill", seq_len=4096, batch=1)
print(json.dumps([[e.name, e.M, e.K, e.N, e.param_instances]
                  for e in net.matmuls]))
"""


def _deepseek_raw():
    return json.loads((ROOT / "configs" / f"{DEEPSEEK}.json").read_text())


def test_the_deepseek_shapes_are_the_ports_prefill_weights_first():
    out = subprocess.run([sys.executable, "-c", EXTRACT], cwd=ROOT.parent,
                         capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT.parent / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    want = {}
    for name, m, k, n, weights in json.loads(out.stdout.splitlines()[-1]):
        # a weight's GEMM is written W (out x in) times X^T (in x tokens);
        # attention's keeps its operands (Q or P first)
        want[name] = (n, k, m) if weights else (m, k, n)
    raw = _deepseek_raw()
    h, ffn = raw["hidden_size"], raw["intermediate_size"]
    tokens = raw["published"]["prefill"]["seq_len"]
    # layer 0 (first_k_dense_replace 1): gate and up fused, then down
    assert raw["first_k_dense_replace"] == 1
    want["ffn_gate_up"] = (2 * ffn, h, tokens)
    want["ffn_down"] = (h, ffn, tokens)
    # balanced routing: each routed expert sees tokens x top-k / experts
    per_expert = (tokens * raw["num_experts_per_tok"]
                  // raw["n_routed_experts"])
    assert want["moe_expert_down"][2] == per_expert == 384
    cfg = Config.load(DEEPSEEK)
    assert {lay.name: (lay.M, lay.K, lay.N) for lay in cfg.layers} == want
    assert len(cfg.layers) == 14


def test_the_deepseek_operands_are_as_stated():
    """2:4 weights on every projection, expert and FFN, the router and
    head dense, activations dense, and attn_av's P causal over its 4096
    keys; the design is STC-flexible-RLE on the file's hierarchy."""
    cfg = Config.load(DEEPSEEK)
    nm, dense = ("structured", {"n": 2, "m": 4}), ("dense", None)
    for lay in cfg.layers:
        assert lay.densities["B"] == dense
        if lay.name == "attn_av":
            assert lay.densities["A"] == ("causal", {
                "window": 4096, "rows": 4096, "cols": 4096})
        elif lay.name in ("attn_qk", "moe_router", "lm_head"):
            assert lay.densities["A"] == dense
        else:
            assert lay.densities["A"] == nm
    for design in (cfg.program_design(), cfg.reference_design()):
        assert design.name == "stc-2:4-RLE"
        assert design.level_names == ["RF", "SMEM", "HBM"]
    assert cfg.spatial(cfg.reference_design()) == {1: {"m": 16, "n": 16}}
    assert cfg.check_capacity and cfg.precision == "float64"


@pytest.fixture
def attn_av(write_config):
    """The file with ``attn_av`` alone, in a benchmark of its own: a CPU
    run judges the causal layer in every search."""
    raw = _deepseek_raw()
    raw["name"] = "deepseek-attn-av"
    raw["layers"] = [lay for lay in raw["layers"] if lay["name"] == "attn_av"]
    return write_config(raw)


def test_the_deepseek_cell_runs_and_is_correct():
    """The whole file through the cell, on the CPU at SMALL."""
    line, notes = run_cell(f"{DEEPSEEK}.fused-es", SEED, 1.0, False,
                           device="cpu", overrides=SMALL)
    assert line["correct"], line["checks"]
    assert notes["rows_judged"] > 0 and notes["generations_judged"] > 0
    assert line["checks"]["metric_gap"]["value"] < 1e-12


def test_the_causal_layer_runs_is_correct_and_its_control_fails(
        attn_av, monkeypatch):
    """attn_av alone: correct with gaps at float64's rounding; the same
    rows and generations with the float32 reference's answers fail."""
    from portbench.harness import cell as cellmod
    seen = {}
    real = judge.readings

    def keep(rows, cfg, **kw):
        seen.update(rows=rows, cfg=cfg, gens=kw.get("gens", ()))
        return real(rows, cfg, **kw)
    monkeypatch.setattr(cellmod.judge, "readings", keep)
    line, notes = run_cell(attn_av.cell, SEED, 1.0, False, device="cpu",
                           bench=attn_av.bench, overrides=SMALL)
    assert line["correct"], line["checks"]
    assert notes["rows_judged"] > 0 and notes["generations_judged"] > 0
    assert line["checks"]["metric_gap"]["value"] < 1e-12
    ctl_rows, ctl_gens = judge.control(seen["rows"], seen["gens"],
                                       seen["cfg"])
    ok, checks = judge.verdict(real(ctl_rows, seen["cfg"], gens=ctl_gens))
    assert not ok, checks


@pytest.mark.parametrize("read_as", ["uniform", "dense"])
def test_a_causal_map_read_otherwise_by_the_reference_is_not_correct(
        attn_av, read_as, monkeypatch):
    """The program reads P causal; the reference reads it as uniform at
    the map's own density (0.5) or as dense."""
    real = Config.reference_workload

    def other(self, layer):
        wl = real(self, layer)
        wl.densities["A"] = (("uniform", 0.5) if read_as == "uniform"
                             else ("dense", None))
        return wl
    monkeypatch.setattr(Config, "reference_workload", other)
    line, _ = run_cell(attn_av.cell, SEED, 1.0, False, device="cpu",
                       bench=attn_av.bench, overrides=SMALL)
    assert not line["correct"]
    checks = line["checks"]
    assert (checks["metric_gap"]["value"] > checks["metric_gap"]["limit"]
            or checks["valid_mismatch"]["value"] > 0)


@pytest.mark.gpu
def test_cuda_the_brute_force_agrees_at_the_judged_tiles(attn_av,
                                                        monkeypatch):
    """One run of attn_av on the card at the cell's traffic: every tile
    size its judged rows asked the reference's causal kind about, at
    4096 x 4096, gives the brute force's counts (``causal_mask.py`` on
    the card), the port's scalar model's and its tensor forms' (on the
    card), exactly."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.reference import causal_mask as bf
    from repro_torch.core import density as port
    kind = refdensity._kind_module(refdensity.KINDS / "causal.py")
    asked = set()
    for name in ("prob_empty", "expected_density", "max_nnz"):
        real = getattr(kind.Causal, name)

        def wrapped(self, t, real=real):
            asked.add(int(t))
            return real(self, t)
        monkeypatch.setattr(kind.Causal, name, wrapped)
    line, notes = run_cell(attn_av.cell, SEED, 5.0, False,
                           bench=attn_av.bench,
                           overrides={"judge_share": 1.0,
                                      "judge_searches": 3})
    assert line["correct"], line["checks"]
    assert notes["rows_judged"] > 0 and len(asked) > 0
    monkeypatch.undo()
    n = 4096
    mask = bf.mask(n, n, n, device="cuda")
    mine = port.CausalModel(rows=n, cols=n, window=n)
    theirs = kind.model({"window": n, "rows": n, "cols": n}, n * n)
    tiles = sorted(asked)
    stats = port.TracedDensityStats(port.caps_for_models([mine]))
    params = torch.as_tensor(mine.params(), device="cuda")
    tt = torch.tensor(tiles, dtype=torch.float64, device="cuda")
    forms = list(zip(*(getattr(stats, s)(port.CAUSAL_ID, params, None, tt)
                       .tolist() for s in ("prob_empty", "expected_density",
                                           "max_nnz"))))
    for t, (pe, ed, mx) in zip(tiles, forms):
        want = bf.stats(mask, t)
        assert (mine.prob_empty(t), mine.expected_density(t),
                mine.max_nnz(t)) == want, t
        assert (theirs.prob_empty(t), theirs.expected_density(t),
                theirs.max_nnz(t)) == want, t
        assert (pe, ed, int(mx)) == want, t
    print(f"{len(tiles)} tile sizes agree: {tiles}")
