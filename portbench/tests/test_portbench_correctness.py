"""``correct`` has to fail where it should.  On the CPU, at sizes a test
run can hold: the cells as they are come out correct; the control (the
reference in float32 in the program's place) does not; and a run with
the timed path broken underneath (an engine answer altered where it is
made, half a population left out with the other half's answers handed
out for it, a step that hands its population on unchanged, a winner's
mapping altered) comes out not correct, on the fused path and on the
host loop.  The harness's look for a card is skipped (``device="cpu"``);
the rest of a run is driven as on the card.  The exchange between chips
is not a fault these cells can have: each takes one chip.
"""
import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import judge
from portbench.harness.cell import load_benchmark, run_cell
from portbench.harness.config import Config

SEED = 2 ** 31 + 4242
SMALL = {"pop_size": 128, "generations": 4, "chunk": 2, "judge_share": 1.0,
         "judge_searches": 3, "judge_rows": 16}
CELLS = [w["name"] for w in load_benchmark()["workloads"]]
#: each cell, and the first on the host loop (the same searches with
#: ``fused`` false, the path every other strategy takes)
PATHS = [(c, True) for c in CELLS] + [(CELLS[0], False)]


def _id(p):
    return f"{p[0]}-{'fused' if p[1] else 'host'}"


def _run(cell, fused=True, seconds=1.0, bench=None):
    line, notes = run_cell(cell, SEED, seconds, False, device="cpu",
                           bench=bench, overrides=dict(SMALL, fused=fused))
    assert notes["rows_judged"] > 0
    return line


@pytest.mark.parametrize("path", PATHS, ids=_id)
def test_cells_as_they_are_are_correct(path):
    line = _run(*path)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("path", PATHS + [("stc", True)], ids=_id)
def test_the_control_fails(path, monkeypatch, request):
    """The rows and generations a run judged, with the float32
    reference's answers in the program's place, fail the limits; the
    program's pass.  Also on the 2:4 STC configuration
    (``conftest.STC``), where the control is float32's rounding alone,
    which the limit of 1e-6 let pass."""
    from portbench.harness import cell as cellmod
    stc = path[0] == "stc"
    if stc:
        ns = request.getfixturevalue("stc")
        path, bench = (ns.cell, True), ns.bench
    else:
        bench = None
    seen = {}
    real = judge.readings

    def keep(rows, cfg, **kw):
        seen.update(rows=rows, cfg=cfg, gens=kw.get("gens", ()))
        return real(rows, cfg, **kw)
    monkeypatch.setattr(cellmod.judge, "readings", keep)
    assert _run(*path, bench=bench)["correct"]
    rows, gens, cfg = seen["rows"], seen["gens"], seen["cfg"]
    assert bool(gens) == path[1]
    ok, _ = judge.verdict(real(rows, cfg, gens=gens))
    assert ok
    ctl_rows, ctl_gens = judge.control(rows, gens, cfg)
    ctl = real(ctl_rows, cfg, gens=ctl_gens)
    ok, checks = judge.verdict(ctl)
    if stc:
        assert not ok and judge.LIMITS["metric_gap"] < ctl["metric_gap"] < 1e-6, \
            checks
    else:
        assert not ok and ctl["metric_gap"] > 10 * judge.LIMITS["metric_gap"], \
            checks


def _fault_engine_altered(monkeypatch):
    """Every cycles and EDP answer of the engine 1e-4 off."""
    from repro_torch.core import batched
    from repro_torch.search.fused import FusedProgram
    real_unpack, real_eval = batched._unpack, FusedProgram._evaluate

    def unpack(*a, **kw):
        out = real_unpack(*a, **kw)
        out["cycles"] = out["cycles"] * (1.0 + 1e-4)
        out["edp"] = out["edp"] * (1.0 + 1e-4)
        return out

    def evaluate(self, g, wp):
        fit, cyc, en, edp, valid, g2 = real_eval(self, g, wp)
        return fit * (1.0 + 1e-4), cyc, en, edp * (1.0 + 1e-4), valid, g2
    monkeypatch.setattr(batched, "_unpack", unpack)
    monkeypatch.setattr(FusedProgram, "_evaluate", evaluate)


def _fault_half_left_out(monkeypatch):
    """The engine scores the first half of each population and hands
    those answers out for the second half too."""
    from repro_torch.core.batched import BucketedModel
    from repro_torch.search.fused import FusedProgram
    real_bm, real_eval = BucketedModel.evaluate, FusedProgram._evaluate

    def bm_evaluate(self, bounds, rank_ids, *a, **kw):
        half = (len(bounds) + 1) // 2
        res = real_bm(self, bounds[:half], rank_ids[:half], *a, **kw)
        idx = np.arange(len(bounds)) % half
        return {k: v[idx] for k, v in res.items()}

    def evaluate(self, g, wp):
        half = (g.shape[0] + 1) // 2
        out = real_eval(self, g[:half], wp)
        idx = torch.arange(g.shape[0], device=g.device) % half
        return tuple(t[idx] for t in out[:5]) + (g,)
    monkeypatch.setattr(BucketedModel, "evaluate", bm_evaluate)
    monkeypatch.setattr(FusedProgram, "_evaluate", evaluate)


def _fault_state_unchanged(monkeypatch):
    """A step that hands its population on unchanged: the fused chunk
    returns the carry it was given, the host loop's strategy asks the
    same children again."""
    from repro_torch.search.fused import FusedProgram
    from repro_torch.search.strategies import EvolutionStrategy
    real_chunk, real_ask = FusedProgram.invoke_chunk, EvolutionStrategy.ask
    first = {}

    def invoke_chunk(self, carry, length):
        _, ys = real_chunk(self, carry, length)
        return carry, ys

    def ask(self, state, enc):
        if id(state) not in first:
            first[id(state)] = (state, real_ask(self, state, enc))
        return first[id(state)][1].copy()
    monkeypatch.setattr(FusedProgram, "invoke_chunk", invoke_chunk)
    monkeypatch.setattr(EvolutionStrategy, "ask", ask)


FAULTS = {"engine_altered": (_fault_engine_altered, "metric_gap"),
          "half_left_out": (_fault_half_left_out, None),
          "state_unchanged": (_fault_state_unchanged, "stalled")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("path", PATHS, ids=_id)
def test_a_fault_underneath_is_not_correct(path, fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    line = _run(*path)
    assert not line["correct"], line["checks"]
    if number:
        assert line["checks"][number]["value"] > line["checks"][number]["limit"]


def test_a_winner_altered_is_not_correct(monkeypatch):
    """The winner's mapping altered where it is decoded: one loop of the
    nest goes missing."""
    from repro_torch.search.encoding import MapspaceEncoding
    real = MapspaceEncoding.nest_of

    def nest_of(self, genome):
        n = real(self, genome)
        return dataclasses.replace(n, loops=n.loops[1:])
    monkeypatch.setattr(MapspaceEncoding, "nest_of", nest_of)
    line = _run(CELLS[-1])
    assert not line["correct"]
    # the program's own re-validation may already refuse it (missing)
    assert (line["checks"]["illegal"]["value"]
            + line["checks"]["missing"]["value"]) > 0


def test_limits_lie_between_the_readings():
    """The limits as PERF.md records them: ``metric_gap``'s at the
    geometric middle of the program's widest gap over the seeds read on
    the card (never under 2.44e-9, the widest of the first cells' first
    seeds) and the float32 control's
    narrowest over the configurations these tests hold."""
    for k in ("missing", "illegal", "stalled", "valid_mismatch",
              "valid_count_gap"):
        assert judge.LIMITS[k] == 0
    lower, upper = judge.METRIC_GAP_READINGS
    limit = judge.LIMITS["metric_gap"]
    assert 2.44e-9 <= lower < limit < upper
    assert limit == pytest.approx((lower * upper) ** 0.5, rel=0.02)
    for w in load_benchmark()["workloads"]:
        assert Config.load(w["config"]).precision == "float64"


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """One short run of each cell through the command, on the card."""
    import json
    import subprocess
    import sys
    from pathlib import Path
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = Path(__file__).resolve().parents[2]
    for cell in CELLS:
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell,
             "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
            cwd=root, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr[-2000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["device"]["platform"] == "gpu"
