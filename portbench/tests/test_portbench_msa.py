"""MiniMax-M3's prefill with its block-sparse attention (MSA) on STC-
flexible-RLE (``configs/minimax-m3-msa-stc.json``): the file carries the
catalog's config.json unchanged and its GEMMs follow from it; the frozen
``causal_block_topk`` kind (``reference/kinds/causal_block_topk.py``)
agrees with the program's scalar model and with a plain-PyTorch MSA
(``reference/msa_block_mask.py``), whose gathered core is dense masked
attention; attn_av alone runs correct on the CPU, and planted faults in
its operand P (read by the reference at token level with about the same
count, in blocks of 64, or with k one short) are not, nor is the float32
control; the readers of what the kind costs read the program's spans and
histogram, on synthetic ones."""
import importlib.util
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.harness import judge
from portbench.harness.cell import Context, reader, run_cell
from portbench.harness.config import ROOT, Config
from portbench.reference import density as refdensity

SEED = 2 ** 31 + 3636
SMALL = {"pop_size": 128, "generations": 4, "chunk": 2, "judge_share": 1.0,
         "judge_searches": 3, "judge_rows": 16}
MSA = "minimax-m3-msa-stc"
T = 131072
P = {"block": 128, "k": 16, "init": 1, "local": 1}


def _raw():
    return json.loads((ROOT / "configs" / f"{MSA}.json").read_text())


def _kind():
    return refdensity._kind_module(refdensity.KINDS / "causal_block_topk.py")


def _msa():
    path = ROOT / "reference" / "msa_block_mask.py"
    spec = importlib.util.spec_from_file_location("msa_block_mask", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ----------------------------------------------------------------------
# the file
# ----------------------------------------------------------------------
def test_the_shapes_follow_from_the_published_config():
    """Every GEMM from config.json's numbers, weights first (A = W, B =
    X^T), at a 131,072-token prefill; attn_av among the first four (the
    traced searches)."""
    raw = _raw()
    assert raw["source_url"] == ("https://huggingface.co/MiniMaxAI/"
                                 "MiniMax-M3/blob/main/config.json")
    pre, msa = raw["published"]["prefill"], raw["published"]["msa"]
    assert pre == {"seq_len": T, "batch": 1}
    assert (msa["block"], msa["top_blocks"], msa["first_blocks"],
            msa["local_blocks"]) == (128, 16, 1, 1)
    h, heads, kv = (raw["hidden_size"], raw["num_attention_heads"],
                    raw["num_key_value_heads"])
    d = raw["head_dim"]
    per_expert = T * raw["num_experts_per_tok"] // raw["num_local_experts"]
    assert per_expert == 4096
    want = {
        "attn_av": (T, T, d),
        "idx_qk": (T, d, T // 128),
        "attn_qk": (heads // kv, d, 18 * 128),
        "q_proj": (heads * d, h, T),
        "kv_proj": (kv * d, h, T),
        "o_proj": (h, heads * d, T),
        "moe_router": (raw["num_local_experts"], h, T),
        "moe_expert_gate_up": (2 * raw["intermediate_size"], h, per_expert),
        "moe_expert_down": (h, raw["intermediate_size"], per_expert),
        "moe_shared_gate_up": (2 * raw["shared_intermediate_size"], h, T),
        "moe_shared_down": (h, raw["shared_intermediate_size"], T),
        "ffn_gate_up": (2 * raw["dense_intermediate_size"], h, T),
        "ffn_down": (h, raw["dense_intermediate_size"], T),
        "lm_head": (raw["vocab_size"], h, T),
    }
    cfg = Config.load(MSA)
    assert {lay.name: (lay.M, lay.K, lay.N) for lay in cfg.layers} == want
    assert [lay.name for lay in cfg.layers] == list(want)


def test_the_file_holds_the_catalogs_numbers():
    """Every key of the catalog entry's config, unchanged, and nothing
    reduced: the published counts say what each GEMM stands for."""
    raw = _raw()
    for key, value in {"hidden_size": 6144, "intermediate_size": 3072,
                       "num_hidden_layers": 60, "num_attention_heads": 64,
                       "num_key_value_heads": 4, "head_dim": 128,
                       "vocab_size": 200064, "num_local_experts": 128,
                       "num_experts_per_tok": 4, "n_shared_experts": 1,
                       "dense_intermediate_size": 12288,
                       "shared_intermediate_size": 3072,
                       "max_position_embeddings": 1048576}.items():
        assert raw[key] == value, key
    assert raw["moe_layer_freq"] == [0, 0, 0] + [1] * 57
    per = raw["published"]["per_forward"]
    assert per["attn_av"] == 64 * 60 and per["idx_qk"] == 16 * 60
    assert per["attn_qk"] == T * 4 * 60 and per["kv_proj"] == 120
    assert per["moe_expert_down"] == 128 * 57 and per["ffn_down"] == 3
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == MSA)
    assert entry["reduced"] == [] and entry["source"] == raw["source_url"]


def test_the_operands_are_as_stated():
    """2:4 on every projection, expert and FFN weight; the router, the
    head and the score GEMMs dense; attn_av's P the block selection, on
    both sides alike."""
    cfg = Config.load(MSA)
    nm, dense = ("structured", {"n": 2, "m": 4}), ("dense", None)
    for lay in cfg.layers:
        assert lay.densities["B"] == dense
        if lay.name == "attn_av":
            assert lay.densities["A"] == ("causal_block_topk", dict(
                P, rows=T, cols=T))
        elif lay.name in ("idx_qk", "attn_qk", "moe_router", "lm_head"):
            assert lay.densities["A"] == dense, lay.name
        else:
            assert lay.densities["A"] == nm, lay.name
    av = cfg.layers[0]
    assert cfg.program_workload(av).densities == \
        cfg.reference_workload(av).densities
    for design in (cfg.program_design(), cfg.reference_design()):
        assert design.name == "stc-2:4-RLE"
    assert cfg.check_capacity and cfg.precision == "float64"


@pytest.mark.parametrize("bad", [{"k": 0}, {"block": 2.5}, {"init": -1},
                                 {"local": None}, {"block": True}, "no init",
                                 "no k", {"window": 64}, {"cols": 8}])
def test_a_malformed_causal_block_topk_density_raises_at_load(
        bad, stc_raw, write_config):
    spec = {"kind": "causal_block_topk", "block": 16, "k": 4, "init": 1,
            "local": 1}
    if isinstance(bad, str):
        del spec[bad.split()[1]]
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
@pytest.mark.parametrize("case", [(24, 24, 4, 2, 1, 1), (23, 17, 2, 4, 0, 2),
                                  (17, 23, 5, 1, 1, 0), (40, 40, 1, 3, 0, 0),
                                  (60, 84, 9, 2, 1, 1)],
                         ids=lambda c: "-".join(map(str, c)))
def test_the_frozen_kind_equals_the_programs_scalar_model(case):
    """At every tile size of small tensors: the same answers, bit for bit
    (the frozen kind is a copy of the program's scalar model)."""
    from repro_torch.core import density as port
    rows, cols, block, k, init, local = case
    theirs = _kind().model({"block": block, "k": k, "init": init,
                            "local": local, "rows": rows, "cols": cols},
                           rows * cols)
    mine = port.CausalBlockTopkModel(*case)
    assert theirs.density == mine.density
    for t in range(1, rows * cols + 1):
        assert (theirs.prob_empty(t), theirs.expected_density(t),
                theirs.max_nnz(t)) == (mine.prob_empty(t),
                                       mine.expected_density(t),
                                       mine.max_nnz(t)), t


def test_the_frozen_kind_equals_the_program_at_attn_avs_size():
    """attn_av's P at 48 tile sizes, the shape's divisors and others: the
    frozen kind and the program's scalar model agree bit for bit, with
    P's 291,160,064 nonzeros."""
    from repro_torch.core import density as port
    theirs = _kind().model(dict(P, rows=T, cols=T), T * T)
    mine = port.CausalBlockTopkModel(T, T, **P)
    assert theirs.density == mine.density
    assert round(theirs.density * T * T) == 291160064
    rng = np.random.default_rng(131072)
    tiles = sorted({1, 3, 7, 48, 127, 129, T, T * T, T * T - 1}
                   | {2 ** e for e in range(0, 35, 3)}
                   | {int(t) for t in np.exp(rng.uniform(0, 23.5, 26))})
    for t in tiles:
        assert (theirs.prob_empty(t), theirs.expected_density(t),
                theirs.max_nnz(t)) == (mine.prob_empty(t),
                                       mine.expected_density(t),
                                       mine.max_nnz(t)), t


# ----------------------------------------------------------------------
# the plain-PyTorch MSA
# ----------------------------------------------------------------------
#: the small MSA of the tests: 256 tokens in 32 blocks of 8, the top 4
#: blocks a query, one KV group of 16 query heads of 16, 4 indexing
SMALL_MSA = {"tokens": 256, "hidden": 64, "heads": 16, "head_dim": 16,
             "block": 8, "k": 4, "init": 1, "local": 1, "idx_heads": 4}


def _tile_counts(m, t):
    tr = math.isqrt(t)
    while t % tr:
        tr -= 1
    tc = t // tr
    rows, cols = m.shape[-2:]
    nr, nc = max(1, rows // tr), max(1, cols // tc)
    hh, kk = min(tr, rows), min(tc, cols)
    return m[..., :nr * hh, :nc * kk].long().reshape(
        *m.shape[:-2], nr, hh, nc, kk).sum((-3, -1))


def test_the_gathered_core_is_dense_masked_attention():
    """The core over each query's gathered keys equals dense softmax
    attention with the keys off the map masked out (float32, TF32 off:
    to 1e-5 of the largest output), and the map is causal and keeps the
    first and own block of every query."""
    msa = _msa()
    s = SMALL_MSA
    g = msa.group(s["tokens"], s["hidden"], s["heads"], s["head_dim"], 7)
    mask = msa.block_mask(g, s["block"], s["k"], s["init"], s["local"],
                          s["idx_heads"])
    i = torch.arange(s["tokens"])
    assert not bool((mask & (i[None, :] > i[:, None])).any())
    assert bool(mask[:, 0].all()) and bool(mask[i, i].all())
    out, dense = msa.core(g, mask), msa.dense_core(g, mask)
    assert out.dtype == torch.float32
    assert float((out - dense).abs().max()) <= 1e-5 * float(
        dense.abs().max())


def test_200_seeded_indexers_give_the_kinds_count():
    """Over 200 seeds every map holds exactly the kind's nonzeros (with
    the own block forced, every candidate block is whole), its tiles never
    more than ``max_nnz``, its density is the kind's, and the kind's
    ``prob_empty`` lies within 0.0085 of the indexer's share of empty
    tiles, below it where the two differ by more than the sample's noise
    (a real indexer's blocks cluster; PERF.md §7 records the gap)."""
    msa = _msa()
    s = SMALL_MSA
    n = s["tokens"]
    kind = _kind().model({"block": s["block"], "k": s["k"],
                          "init": s["init"], "local": s["local"],
                          "rows": n, "cols": n}, n * n)
    masks = msa.masks(**s, count=200, seed=1000)
    want = round(kind.density * n * n)
    assert want == 10432
    assert masks.sum((1, 2)).tolist() == [want] * 200
    gaps = []
    for t in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096, 16384):
        counts = _tile_counts(masks, t)
        assert int(counts.amax()) <= kind.max_nnz(t), t
        assert float(counts.double().mean()) / t == pytest.approx(
            kind.expected_density(t), rel=1e-12)
        gaps.append(kind.prob_empty(t)
                    - float((counts == 0).double().mean()))
    assert -0.0085 <= min(gaps) and max(gaps) <= 1e-4, gaps


# ----------------------------------------------------------------------
# attn_av through the cell
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def attn_av(tmp_path_factory):
    """The file with attn_av alone, in a benchmark of its own: a CPU run
    judges the causal_block_topk layer in every search."""
    from portbench.harness.cell import load_benchmark
    raw = _raw()
    raw["name"] = "msa-attn-av"
    raw["layers"] = [lay for lay in raw["layers"] if lay["name"] == "attn_av"]
    path = tmp_path_factory.mktemp("msa") / "msa-attn-av.json"
    path.write_text(json.dumps(raw))
    bench = load_benchmark()
    bench["configs"].append({"name": raw["name"], "file": str(path),
                             "reduced": [], "source": "-", "why": "-"})
    cell = "msa-attn-av.fused-es"
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
    assert judged.line["checks"]["metric_gap"]["value"] < 1e-11


def test_the_float32_control_is_not_correct(judged):
    """The reference in float32 in the program's place fails the limit:
    only float32's rounding shows (the kind's file computes in float64
    and the reference rounds its answers), so not always 10 times the
    limit (PERF.md §7)."""
    rows, gens = judge.control(judged.rows, judged.gens, judged.cfg)
    ctl = judge.readings(rows, judged.cfg, gens=gens)
    ok, checks = judge.verdict(ctl)
    assert not ok and ctl["metric_gap"] > judge.LIMITS["metric_gap"], checks


@pytest.mark.parametrize("read_as", ["tokens", "block_64", "k_15"])
def test_p_read_otherwise_by_the_reference_is_not_correct(judged, read_as,
                                                          monkeypatch):
    """The judge's rows of the correct run, held to a reference that reads
    P at token level (causal_topk over the whole causal map, 2,304 keys a
    query, about the same count), in blocks of 64 or with k 15: not
    correct."""
    real = Config.reference_workload
    other = {"tokens": ("causal_topk", {"window": T, "k": 2304, "rows": T,
                                        "cols": T}),
             "block_64": ("causal_block_topk", dict(P, block=64, rows=T,
                                                    cols=T)),
             "k_15": ("causal_block_topk", dict(P, k=15, rows=T,
                                                cols=T))}[read_as]

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


def test_block_graph_ms_per_gen_reads_only_causal_block_topk_programs():
    read = reader("block_graph_ms_per_gen")
    spans = [_eval(0.0, 0.5, 4, device_s=0.4,
                   kinds=("causal_block_topk", "dense")),
             _eval(0.5, 0.7, 2, device_s=0.2, kinds=["causal_block_topk"]),
             # the token-level kind's program, one recording no kinds (the
             # parent's), a first sighting and a span with no device clock
             _eval(1.0, 1.1, 4, device_s=0.02, kinds=("causal_topk",
                                                      "dense")),
             _eval(1.1, 1.2, 4, device_s=0.02),
             _eval(1.2, 1.3, 4, device_s=0.02, name="engine.compile",
                   kinds=("causal_block_topk",)),
             _eval(1.3, 1.4, 4, kinds=("causal_block_topk",))]
    assert read(_ctx(spans)) == pytest.approx(600.0 / 6)
    assert read(_ctx(spans[2:])) is None
    assert read(_ctx()) is None
    assert reader("topk_graph_ms_per_gen")(_ctx(spans)) == pytest.approx(5.0)


def test_block_graph_kernels_is_the_mean_of_the_block_captures(monkeypatch):
    from repro_torch.core.batched import DeviceLeaves
    from repro_torch.core.density import (CAUSAL_BLOCK_TOPK_ID,
                                          CAUSAL_TOPK_ID, DENSE_ID)
    from repro_torch.obs import metrics
    from repro_torch.search.fused import FusedProgram
    monkeypatch.setattr(metrics, "REGISTRY", metrics.Registry())
    read = reader("block_graph_kernels")
    assert read(_ctx()) is None
    FusedProgram._observe_kernels(1748, DeviceLeaves(
        *(None,) * 4, kinds=(CAUSAL_TOPK_ID, DENSE_ID)))
    assert read(_ctx()) is None
    for n in (1920, 1940):
        FusedProgram._observe_kernels(n, DeviceLeaves(
            *(None,) * 4, kinds=(CAUSAL_BLOCK_TOPK_ID, DENSE_ID)))
    assert read(_ctx()) == pytest.approx(1930.0)
    assert reader("topk_graph_kernels")(_ctx()) == pytest.approx(1748.0)
