"""The harness's own arithmetic and rules, on the CPU: the rate, the
percentile, the spread, the union of device intervals, the metric
readers, the contract's name and unit rules for BENCHMARK.json, and the
import check."""
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import devtrace, importcheck, stats
from portbench.harness.cell import (Context, cell_entry, load_benchmark,
                                    metrics_for, reader)

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _ctx(**window):
    return Context(setup_s=3.0, window=window)


def test_candidates_per_s_is_all_work_over_all_time():
    read = reader("candidates_per_s")
    assert read(_ctx(candidates=3 * 16384, wall_s=2.0)) == 3 * 16384 / 2.0
    assert read(_ctx(candidates=0, wall_s=2.0)) is None


def test_percentile_is_nearest_rank():
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0
    assert stats.percentile([1.0], 95) == 1.0
    assert stats.percentile(list(range(1, 101)), 95) == 95


def test_spread_by_statistics_quantiles():
    vals = [100.0, 102.0, 98.0, 101.0, 99.0, 100.0]
    q1, med, q3 = __import__("statistics").quantiles(vals, n=4)
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_union_counts_overlap_once():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert devtrace.union_seconds(iv) == pytest.approx(4.0)
    assert devtrace.gaps(iv, 0.0, 7.0) == [(3.0, 5.0), (6.0, 7.0)]
    assert devtrace.gaps(iv, -1.0, 2.5) == [(-1.0, 0.0)]
    assert devtrace.innermost([("a", 0, 10, 0), ("b", 2, 4, 1)], 3) == "b"


def test_device_ms_per_gen_reader():
    read = reader("device_ms_per_gen")
    ctx = _ctx(traced_generations=64)
    ctx.device = {"busy_s": 0.32, "window_s": 0.5}
    assert read(ctx) == pytest.approx(5.0)
    ctx.device = {"busy_s": 0.0, "window_s": 0.5}
    assert read(ctx) is None
    assert read(_ctx()) is None


def test_fused_ms_per_gen_reader():
    from types import SimpleNamespace as S
    read = reader("fused_ms_per_gen")
    ctx = _ctx()
    ctx.spans = [S(name="search.chunk", dur=0.02, attrs={"length": 4}),
                 S(name="search.chunk", dur=0.03, attrs={"length": 4}),
                 S(name="engine.eval", dur=1.0, attrs={})]
    assert read(ctx) == pytest.approx(6.25)
    assert read(_ctx()) is None


def test_keys_differ_by_stream_and_take_large_seeds():
    k = {stats.key(2 ** 31 + 5, 0, i) for i in range(100)}
    assert len(k) == 100 and max(k) < 2 ** 62


def test_import_check_compares_whole_top_level_names():
    assert importcheck.forbidden_loaded(
        ["repro_torch", "repro_torch.search", "reprox", "jaxtyping"]) == []
    assert importcheck.forbidden_loaded(
        ["repro.core", "jax.numpy", "jaxlib", "flax.linen", "numpy"]) == [
            "flax", "jax", "jaxlib", "repro"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.argv = ['run.py']; "
            "sys.path[:0] = ['portbench']; import run; run._environment(); "
            "import portbench.harness.cell, repro_torch.search; "
            "from portbench.harness.importcheck import forbidden_loaded; "
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_the_cards_it_needs():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "scnn-resnet50.fused-es", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_the_contract():
    b = load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "portbench/run.py"]
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    # a full check of 24 cells fits
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and PATH.match(c["file"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        cells.add(w["name"])
    assert len(cells) == len(b["workloads"])
    assert {w["config"] for w in b["workloads"]} == names
    e2e = {}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e[m["name"]] = m
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    layers = {}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert m["name"] not in names - {m["name"]}
    for cell in cells:
        got = {m["name"] for m in metrics_for(b, cell, False)}
        assert "setup_s" in got and len(got) >= 2
        moves = {m["moves"] for m in metrics_for(b, cell, True)}
        assert moves and moves <= got
    assert len(json.dumps(b)) <= 64 * 1024
    assert cell_entry(b, "scnn-resnet50.fused-es")["traffic"] == "fused-es"


def test_every_metric_reader_is_found_by_name():
    b = load_benchmark()
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(reader(m["name"]))
    assert math.isfinite(reader("setup_s")(_ctx()))
