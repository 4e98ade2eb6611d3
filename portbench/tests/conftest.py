"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from
the root of the checkout (CPU; the ``gpu`` cases skip without a card)."""
import copy
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: A configuration that no cell runs and whose hierarchy differs from the
#: cells': Sparseloop's STC (Sec. 6.3.5, 7.1), 2:4 weights skipped at the
#: RF, on an HBM -> SMEM -> RF -> tensor-core array, over two GEMMs of
#: DeepSeek-V2-Lite's prefill at 4096 tokens written weights first (A the
#: weights, M x K = out x in features; B the activations, K x N).
STC = {
    "name": "stc-deepseek-v2-lite",
    "design": {
        "preset": "stc_like",
        "preset_args": {"n": 2, "m": 4},
        "arch": {
            "name": "sm-tc",
            "levels": [
                {"name": "HBM", "capacity_words": None,
                 "bandwidth_words_per_cycle": 16, "read_energy_pj": 200.0,
                 "write_energy_pj": 200.0, "gated_energy_pj": 0.0},
                {"name": "SMEM", "capacity_words": 49152,
                 "bandwidth_words_per_cycle": 64, "read_energy_pj": 8.0,
                 "write_energy_pj": 8.0, "gated_energy_pj": 0.05},
                {"name": "RF", "capacity_words": 2048,
                 "bandwidth_words_per_cycle": 512, "read_energy_pj": 0.6,
                 "write_energy_pj": 0.6, "gated_energy_pj": 0.01}],
            "compute": {"name": "TC-MAC", "instances": 256, "throughput": 1,
                        "mac_energy_pj": 1.0, "gated_energy_pj": 0.05}}},
    "spatial": {"SMEM": {"m": 16, "n": 16}},
    "check_capacity": True,
    "precision": "float64",
    "layers": [
        {"name": "moe_expert_down", "M": 2048, "K": 1408, "N": 384,
         "density": {"A": {"kind": "structured", "n": 2, "m": 4},
                     "B": {"kind": "dense"}}},
        {"name": "mla_kv_a_proj", "M": 576, "K": 2048, "N": 4096,
         "density": {"A": {"kind": "structured", "n": 2, "m": 4},
                     "B": {"kind": "dense"}}}],
}


def with_config(raw: dict, directory: Path) -> SimpleNamespace:
    """``raw`` written to ``directory``, and ``BENCHMARK.json`` with one
    more configuration and cell (on ``fused-es``) naming it."""
    from portbench.harness.cell import load_benchmark
    path = directory / f"{raw['name']}.json"
    path.write_text(json.dumps(raw))
    bench = load_benchmark()
    cell = f"{raw['name']}.fused-es"
    bench["configs"].append({"name": raw["name"], "file": str(path),
                             "reduced": [], "source": "-", "why": "-"})
    bench["workloads"].append({"name": cell, "config": raw["name"],
                               "traffic": "fused-es", "chips": 1, "why": "-"})
    return SimpleNamespace(path=path, bench=bench, cell=cell)


@pytest.fixture
def stc(tmp_path):
    """:data:`STC` in a temporary directory, in a benchmark of its own."""
    return with_config(STC, tmp_path)


@pytest.fixture
def stc_raw():
    """A copy of :data:`STC` to change."""
    return copy.deepcopy(STC)


@pytest.fixture
def write_config(tmp_path):
    """:func:`with_config` into a temporary directory."""
    return lambda raw: with_config(raw, tmp_path)
