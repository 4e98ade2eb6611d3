"""One run of one cell: set-up, the measured window, the judge, the
metrics, the result line.

Everything a cell is made of is found by name: ``BENCHMARK.json``'s
``workloads`` entry names a configuration (the ``file`` of its
``configs`` entry, ``configs/<config>.json``) and
a traffic mix (``traffic/<traffic>.json``, whose ``mode`` picks the
generator: :data:`DRIVERS`), and each metric is read by
``metrics/<name>.py``'s ``read(ctx)``.  A reader that finds nothing to
read returns None, and the metric is left out of the line.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time

from . import importcheck, judge
from .config import ROOT, Config
from .devtrace import DeviceTrace
from .search import SearchDriver

DRIVERS = {"search": SearchDriver}

BENCHMARK = ROOT.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    setup_s: float
    window: dict
    #: the program's spans (``repro_torch.obs``) of the untraced part of
    #: the window (traced runs)
    spans: list = dataclasses.field(default_factory=list)
    #: :meth:`DeviceTrace.reduce` of the traced part (traced runs)
    device: dict | None = None


def load_benchmark(path=BENCHMARK) -> dict:
    return json.loads(path.read_text())


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` False) or per-layer
    metrics (``trace`` True), as ``BENCHMARK.json`` lists them."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moves)]


def reader(name: str):
    path = ROOT / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def finite(x: float) -> float:
    """JSON has no infinity: the largest double stands for it."""
    return x if math.isfinite(x) else sys.float_info.max


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             bench: dict | None = None,
             overrides: dict | None = None) -> tuple[dict, dict]:
    """Run ``name`` once.  Returns the result line as a dict (the checks
    last) and notes for the log (where the widest gap was, how much the
    judge read).  ``overrides`` replaces traffic keys (the tests run
    cells at sizes a CPU can hold)."""
    import torch

    from repro_torch import obs
    from repro_torch.core.batched import clear_caches
    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or load_benchmark()
    cell = cell_entry(bench, name)
    cfg = Config.load_file(ROOT.parent / config_entry(bench, cell["config"])
                           ["file"], cell["config"])
    traffic = json.loads((ROOT / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    traffic.update(overrides or {})
    cuda = device == "cuda"
    drv = DRIVERS[traffic["mode"]](cfg, traffic, seed,
                                   None if cuda else device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    tracer = None
    if trace:
        tr = obs.enable()
        tracer = DeviceTrace("cuda" if cuda else "cpu")
    win = drv.window(seconds, tracer)
    ctx = Context(setup_s=setup_s, window=win)
    if trace:
        # spans of the untraced part: after the profiler stopped
        a, b = win["untraced"]
        lo, hi = a - tr.epoch, b - tr.epoch
        ctx.spans = [s for s in tr.spans if s.t_start >= lo and s.t_end <= hi]
        ctx.device = tracer.reduce(tr.spans, epoch=tr.epoch)
        obs.disable()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = importcheck.forbidden_loaded()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}")
    if "repro_torch.kernels.nvcc" in sys.modules:
        raise SystemExit("the run loaded the kernel builder "
                         "(repro_torch.kernels.nvcc)")

    # the program's state goes before the reference runs
    rows, gens = win.pop("rows"), win.pop("generations")
    del drv
    clear_caches()
    if cuda:
        torch.cuda.empty_cache()
    read = judge.readings(rows, cfg, missing=win["failed"], gens=gens,
                          stalled=win["stalled"])
    ok, checks = judge.verdict(read)

    metrics = {}
    for m in metrics_for(bench, name, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": finite(float(v)), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(ok), "attempted": int(win["attempted"]),
            "failed": int(win["failed"]), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = ctx.device["busy_s"]
        dev["window_s"] = ctx.device["window_s"]
        line["breakdown"] = ctx.device["breakdown"]
    line["checks"] = {k: {"value": finite(float(v)), "limit": lim}
                      for k, v, lim in checks}
    notes = {"rows_judged": read["rows"],
             "generations_judged": len(gens),
             "children_judged": read["children"],
             "widest_gap_at": read["worst"], "window_s": win["wall_s"]}
    if win.get("search_s"):
        took = win["search_s"]
        tenths = [took[len(took) * j // 10:len(took) * (j + 1) // 10]
                  for j in range(10)]
        notes["search_s_by_tenth"] = [statistics.median(s) if s else None
                                      for s in tenths]
    return line, notes
