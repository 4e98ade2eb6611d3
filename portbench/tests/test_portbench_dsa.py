"""DeepSeek-V3.2's prefill with its sparse attention (DSA) on STC-flexible-
RLE (``configs/deepseek-v3.2-dsa-stc.json``): the file carries the
catalog's config.json unchanged and its GEMMs follow from it; the frozen
``causal_topk`` kind (``reference/kinds/causal_topk.py``) agrees with the
brute force and with the program; attn_av alone runs correct on the CPU,
and planted faults in its operand P (read by the reference as the causal
map, as uniform at P's own density, or with k one off) are not, nor is
the float32 control; the readers of what the kind costs read the
program's spans and histogram, on synthetic ones; the seeded indexer
PERF.md compares with the kind keeps k keys of each query's past."""
import importlib.util
import json
from types import SimpleNamespace

import pytest

from portbench.harness import judge
from portbench.harness.cell import Context, reader, run_cell
from portbench.harness.config import ROOT, Config
from portbench.reference import density as refdensity

SEED = 2 ** 31 + 3232
SMALL = {"pop_size": 128, "generations": 4, "chunk": 2, "judge_share": 1.0,
         "judge_searches": 3, "judge_rows": 16}
DSA = "deepseek-v3.2-dsa-stc"
T = 32768


def _raw():
    return json.loads((ROOT / "configs" / f"{DSA}.json").read_text())


def _kind():
    return refdensity._kind_module(refdensity.KINDS / "causal_topk.py")


def _brute():
    path = ROOT / "reference" / "causal_topk_mask.py"
    spec = importlib.util.spec_from_file_location("dsa_brute", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# the file
# ----------------------------------------------------------------------
def test_the_shapes_follow_from_the_published_config():
    """Every GEMM from config.json's numbers, weights first (A = W, B =
    X^T), at the published 32,768-token prefill."""
    raw = _raw()
    assert raw["source_url"] == ("https://huggingface.co/deepseek-ai/"
                                 "DeepSeek-V3.2/blob/main/config.json")
    t = raw["published"]["prefill"]["seq_len"]
    assert t == T and raw["published"]["prefill"]["batch"] == 1
    h, heads = raw["hidden_size"], raw["num_attention_heads"]
    qk = raw["qk_nope_head_dim"] + raw["qk_rope_head_dim"]
    latent = raw["kv_lora_rank"] + raw["qk_rope_head_dim"]
    ih, idim = raw["index_n_heads"], raw["index_head_dim"]
    moe, ffn = raw["moe_intermediate_size"], raw["intermediate_size"]
    per_expert = t * raw["num_experts_per_tok"] // raw["n_routed_experts"]
    assert per_expert == 1024
    want = {
        "mla_q_a_proj": (raw["q_lora_rank"], h, t),
        "mla_q_b_proj": (heads * qk, raw["q_lora_rank"], t),
        "mla_kv_a_proj": (latent, h, t),
        "mla_q_absorb": (raw["kv_lora_rank"], raw["qk_nope_head_dim"], t),
        "mla_v_up": (raw["v_head_dim"], raw["kv_lora_rank"], t),
        "mla_o_proj": (h, heads * raw["v_head_dim"], t),
        "idx_q_proj": (ih * idim, raw["q_lora_rank"], t),
        "idx_k_proj": (idim, h, t),
        "idx_weights_proj": (ih, h, t),
        "idx_qk": (t, idim, t),
        "attn_qk": (heads, latent, raw["index_topk"]),
        "attn_av": (t, t, raw["kv_lora_rank"]),
        "moe_router": (raw["n_routed_experts"], h, t),
        "moe_expert_gate_up": (2 * moe, h, per_expert),
        "moe_expert_down": (h, moe, per_expert),
        "moe_shared_gate_up": (2 * moe * raw["n_shared_experts"], h, t),
        "moe_shared_down": (h, moe * raw["n_shared_experts"], t),
        "ffn_gate_up": (2 * ffn, h, t),
        "ffn_down": (h, ffn, t),
        "lm_head": (raw["vocab_size"], h, t),
    }
    cfg = Config.load(DSA)
    assert {lay.name: (lay.M, lay.K, lay.N) for lay in cfg.layers} == want
    assert [lay.name for lay in cfg.layers] == list(want)


def test_the_file_holds_the_catalogs_numbers():
    """Every key of the catalog entry's config, unchanged, and nothing
    reduced: the published counts say what each GEMM stands for."""
    raw = _raw()
    for key, value in {"hidden_size": 7168, "q_lora_rank": 1536,
                       "kv_lora_rank": 512, "num_attention_heads": 128,
                       "index_topk": 2048, "index_n_heads": 64,
                       "index_head_dim": 128, "n_routed_experts": 256,
                       "num_experts_per_tok": 8, "n_shared_experts": 1,
                       "first_k_dense_replace": 3, "num_hidden_layers": 61,
                       "moe_intermediate_size": 2048,
                       "intermediate_size": 18432,
                       "vocab_size": 129280}.items():
        assert raw[key] == value, key
    per = raw["published"]["per_forward"]
    assert per["attn_av"] == 128 * 61 and per["idx_qk"] == 64 * 61
    assert per["attn_qk"] == T * 61
    assert per["moe_expert_down"] == 256 * 58 and per["ffn_down"] == 3
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == DSA)
    assert entry["reduced"] == [] and entry["source"] == raw["source_url"]


def test_the_operands_are_as_stated():
    """2:4 on every projection, absorption, expert and FFN weight; the
    router, idx_weights_proj, the head and the score GEMMs dense; attn_av's
    P the top-2,048 selection over the full causal support."""
    cfg = Config.load(DSA)
    nm, dense = ("structured", {"n": 2, "m": 4}), ("dense", None)
    for lay in cfg.layers:
        assert lay.densities["B"] == dense
        if lay.name == "attn_av":
            assert lay.densities["A"] == ("causal_topk", {
                "window": T, "k": 2048, "rows": T, "cols": T})
        elif lay.name in ("idx_weights_proj", "idx_qk", "attn_qk",
                          "moe_router", "lm_head"):
            assert lay.densities["A"] == dense, lay.name
        else:
            assert lay.densities["A"] == nm, lay.name
    for design in (cfg.program_design(), cfg.reference_design()):
        assert design.name == "stc-2:4-RLE"
    assert cfg.check_capacity and cfg.precision == "float64"


@pytest.mark.parametrize("bad", [{"k": 0}, {"k": 2.5}, {"window": 0},
                                 {"k": None}, "no k", {"side": "upper"},
                                 {"rows": 8}])
def test_a_malformed_causal_topk_density_raises_at_load(bad, stc_raw,
                                                         write_config):
    spec = {"kind": "causal_topk", "window": 64, "k": 8}
    if bad == "no k":
        del spec["k"]
    else:
        spec.update(bad)
    stc_raw["layers"][1]["density"]["A"] = spec
    path = write_config(stc_raw).path
    with pytest.raises(ValueError) as err:
        Config.load_file(path)
    msg = str(err.value)
    assert str(path) in msg and "'mla_kv_a_proj'" in msg and "'A'" in msg


# ----------------------------------------------------------------------
# the frozen kind
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rows, cols, window, k", [
    (17, 23, 5, 2), (23, 17, 30, 4), (32, 32, 32, 7), (12, 40, 3, 9),
    (40, 12, 12, 1)])
def test_the_frozen_kind_equals_the_brute_force(rows, cols, window, k):
    bf = _brute()
    theirs = _kind().model({"window": window, "k": k, "rows": rows,
                            "cols": cols}, rows * cols)
    for t in range(1, rows * cols + 2):
        want = bf.exact(rows, cols, min(window, rows), k, t)
        got = (theirs.prob_empty(t), theirs.expected_density(t),
               theirs.max_nnz(t))
        assert abs(got[0] - want[0]) <= 1e-12 and \
            abs(got[1] - want[1]) <= 1e-12 and got[2] == want[2], (t, got,
                                                                    want)


def test_the_frozen_kind_equals_the_program_at_attn_avs_size():
    """attn_av's P at 64 tile sizes, the shape's divisors and others: the
    frozen kind and the program's scalar model agree to 1e-15, and with
    k at the window both are the causal kind."""
    import numpy as np
    from repro_torch.core import density as port
    theirs = _kind().model({"window": T, "k": 2048, "rows": T, "cols": T},
                           T * T)
    mine = port.CausalTopkModel(rows=T, cols=T, window=T, k=2048)
    assert theirs.density == mine.density
    rng = np.random.default_rng(32768)
    tiles = sorted({1, 2, 3, 7, 48, T, T * T, T * T - 1}
                   | {2 ** e for e in range(0, 31, 3)}
                   | {int(t) for t in np.exp(rng.uniform(0, 20.8, 40))})
    for t in tiles:
        a = (theirs.prob_empty(t), theirs.expected_density(t),
             theirs.max_nnz(t))
        b = (mine.prob_empty(t), mine.expected_density(t), mine.max_nnz(t))
        assert abs(a[0] - b[0]) <= 1e-15 and abs(a[1] - b[1]) <= 1e-15 \
            and a[2] == b[2], (t, a, b)
    causal = refdensity._kind_module(refdensity.KINDS / "causal.py")
    full = causal.model({"window": 4096, "rows": 4096, "cols": 4096},
                        4096 ** 2)
    wide = _kind().model({"window": 4096, "k": 4096, "rows": 4096,
                          "cols": 4096}, 4096 ** 2)
    for t in (1, 3, 64, 4095, 4096 * 17, 4096 ** 2):
        assert (wide.prob_empty(t), wide.expected_density(t),
                wide.max_nnz(t)) == (full.prob_empty(t),
                                     full.expected_density(t),
                                     full.max_nnz(t)), t


def test_the_indexer_selections_keep_k_of_each_querys_past():
    """``causal_topk_mask.indexer_masks`` (PERF.md's comparison of a real
    lightning indexer with the kind): causal, min(k, i + 1) keys a row."""
    import torch
    bf = _brute()
    masks = bf.indexer_masks(24, 16, 4, 8, 5, count=3, seed=11)
    assert masks.shape == (3, 24, 24)
    assert not bool((masks & ~bf.support(24, 24, 24)).any())
    want = torch.clamp(torch.arange(1, 25), max=5)
    assert torch.equal(masks.sum(-1), want.expand(3, 24))


# ----------------------------------------------------------------------
# attn_av through the cell
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def attn_av(tmp_path_factory):
    """The file with attn_av alone, in a benchmark of its own: a CPU run
    judges the causal_topk layer in every search."""
    from portbench.harness.cell import load_benchmark
    raw = _raw()
    raw["name"] = "dsa-attn-av"
    raw["layers"] = [lay for lay in raw["layers"] if lay["name"] == "attn_av"]
    path = tmp_path_factory.mktemp("dsa") / "dsa-attn-av.json"
    path.write_text(json.dumps(raw))
    bench = load_benchmark()
    bench["configs"].append({"name": raw["name"], "file": str(path),
                             "reduced": [], "source": "-", "why": "-"})
    cell = "dsa-attn-av.fused-es"
    bench["workloads"].append({"name": cell, "config": raw["name"],
                               "traffic": "fused-es", "chips": 1,
                               "why": "-"})
    return SimpleNamespace(path=path, bench=bench, cell=cell)


@pytest.fixture(scope="module")
def judged(attn_av):
    """One correct run of attn_av, and what its judge read."""
    from portbench.harness import cell as cellmod
    seen = {}
    real = judge.readings

    def keep(rows, cfg, **kw):
        seen.update(rows=rows, cfg=cfg, gens=kw.get("gens", ()))
        return real(rows, cfg, **kw)
    cellmod.judge.readings = keep
    try:
        line, notes = run_cell(attn_av.cell, SEED, 1.0, False, device="cpu",
                               bench=attn_av.bench, overrides=SMALL)
    finally:
        cellmod.judge.readings = real
    return SimpleNamespace(line=line, notes=notes, **seen)


def test_attn_av_runs_correct(judged):
    assert judged.line["correct"], judged.line["checks"]
    assert judged.notes["rows_judged"] > 0
    assert judged.notes["generations_judged"] > 0
    assert judged.line["checks"]["metric_gap"]["value"] < 1e-12


def test_the_float32_control_is_not_correct(judged):
    """The reference in float32 in the program's place fails the limit.
    Only float32's rounding shows here (the kind's file computes in
    float64 and the reference rounds its answers): 8.3e-8 to 1.4e-7 over
    seeds on the CPU, so not always 10 times the limit (PERF.md §7)."""
    rows, gens = judge.control(judged.rows, judged.gens, judged.cfg)
    ctl = judge.readings(rows, judged.cfg, gens=gens)
    ok, checks = judge.verdict(ctl)
    assert not ok and ctl["metric_gap"] > judge.LIMITS["metric_gap"], checks


@pytest.mark.parametrize("read_as", ["causal", "uniform", "k_plus_one",
                                     "k_minus_one"])
def test_p_read_otherwise_by_the_reference_is_not_correct(judged, read_as,
                                                          monkeypatch):
    """The judge's rows of the correct run, held to a reference that reads
    P as the causal map (k ignored), as uniform at P's own density, or
    with k one off: not correct."""
    real = Config.reference_workload
    density = round(65012736 / T ** 2, 12)
    other = {"causal": ("causal", {"window": T, "rows": T, "cols": T}),
             "uniform": ("uniform", density),
             "k_plus_one": ("causal_topk", {"window": T, "k": 2049,
                                            "rows": T, "cols": T}),
             "k_minus_one": ("causal_topk", {"window": T, "k": 2047,
                                             "rows": T, "cols": T})}[read_as]

    def workload(self, layer):
        wl = real(self, layer)
        wl.densities["A"] = other
        return wl
    monkeypatch.setattr(Config, "reference_workload", workload)
    read = judge.readings(judged.rows, judged.cfg, gens=judged.gens)
    ok, checks = judge.verdict(read)
    assert not ok, checks
    assert read["metric_gap"] > judge.LIMITS["metric_gap"] \
        or read["valid_mismatch"] > 0


# ----------------------------------------------------------------------
# what the kind costs, on synthetic spans and histograms
# ----------------------------------------------------------------------
def _eval(t0, t1, gens, device_s=None, kind="fused", name="engine.eval",
          kinds=None):
    attrs = {"kind": kind, "generations": gens}
    if device_s is not None:
        attrs["device_s"] = device_s
    if kinds is not None:
        attrs["density_kinds"] = kinds
    return SimpleNamespace(name=name, t_start=t0, t_end=t1, dur=t1 - t0,
                           tid=1, depth=0, attrs=attrs)


def _ctx(spans=()):
    return Context(setup_s=3.0, window={"untraced": (10.0, 12.0)},
                   spans=list(spans))


def test_topk_graph_ms_per_gen_reads_only_causal_topk_programs():
    read = reader("topk_graph_ms_per_gen")
    spans = [_eval(0.0, 0.5, 4, device_s=0.4,
                   kinds=("causal_topk", "dense")),
             _eval(0.5, 0.7, 2, device_s=0.2, kinds=["causal_topk"]),
             # the causal kind's program, one recording no kinds (the
             # parent's), a first sighting and a span with no device clock
             _eval(1.0, 1.1, 4, device_s=0.02, kinds=("causal", "dense")),
             _eval(1.1, 1.2, 4, device_s=0.02),
             _eval(1.2, 1.3, 4, device_s=0.02, name="engine.compile",
                   kinds=("causal_topk",)),
             _eval(1.3, 1.4, 4, kinds=("causal_topk",))]
    assert read(_ctx(spans)) == pytest.approx(600.0 / 6)
    assert read(_ctx(spans[2:])) is None
    assert read(_ctx()) is None


def test_topk_graph_kernels_is_the_mean_of_the_causal_topk_captures(
        monkeypatch):
    from repro_torch.core.batched import DeviceLeaves
    from repro_torch.core.density import CAUSAL_ID, CAUSAL_TOPK_ID, DENSE_ID
    from repro_torch.obs import metrics
    from repro_torch.search.fused import FusedProgram
    monkeypatch.setattr(metrics, "REGISTRY", metrics.Registry())
    read = reader("topk_graph_kernels")
    assert read(_ctx()) is None
    FusedProgram._observe_kernels(1409, DeviceLeaves(
        *(None,) * 4, kinds=(CAUSAL_ID, DENSE_ID)))
    assert read(_ctx()) is None
    for n in (1690, 1710):
        FusedProgram._observe_kernels(n, DeviceLeaves(
            *(None,) * 4, kinds=(CAUSAL_TOPK_ID, DENSE_ID)))
    assert read(_ctx()) == pytest.approx(1700.0)
    assert reader("causal_graph_kernels")(_ctx()) == pytest.approx(1409.0)
