"""What the program's tracing costs a cell (not run by the benchmark's own
runs).

    python3 portbench/tracecost.py --workload <cell> --seed <n> --seconds 10

Sets the cell up once, runs a ``--warmup`` window with tracing on that
no figure counts, then ``--pairs`` pairs of windows as the benchmark
does, one with the program's tracing off and one with it on
(``repro_torch.obs.enable()``, no profiler), the order alternating from
pair to pair.  One JSON line a window: the rate of candidates scored,
the card's SM clock read by ``nvidia-smi`` as the window ends, and for
a window with tracing on what the span readers read from it
(``graph_ms_per_gen``, ``search_host_ms``, ``graph_idle_share``,
``fused_ms_per_gen``).  The last line gives each side's median and
quartiles and the median of the pairs' on/off ratios.  On a CUDA card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from run import ROOT, _environment  # noqa: F401  (sets sys.path)

SPAN_METRICS = ("graph_ms_per_gen", "search_host_ms", "graph_idle_share",
                "fused_ms_per_gen")


def _sm_clock_mhz() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=10, check=True)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _quartiles(values: list[float]) -> list[float]:
    if len(values) < 2:
        return values * 3
    return statistics.quantiles(values, n=4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--warmup", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--traffic", default="{}",
                    help="JSON object of traffic keys to replace (a "
                         "rehearsal at sizes a CPU holds)")
    args = ap.parse_args(argv)
    _environment()
    import torch

    from portbench.harness.cell import (DRIVERS, Context, cell_entry,
                                        load_benchmark, reader)
    from portbench.harness.config import Config
    from repro_torch import obs
    torch.set_num_threads(2)
    cell = cell_entry(load_benchmark(), args.workload)
    cfg = Config.load(cell["config"])
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    traffic.update(json.loads(args.traffic))
    cuda = args.device == "cuda"
    drv = DRIVERS[traffic["mode"]](cfg, traffic, args.seed,
                                   None if cuda else args.device)
    t0 = time.perf_counter()
    drv.setup()
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0) if cuda
                      else "cpu", "setup_s": time.perf_counter() - t0}),
          flush=True)

    def window(on: bool, label, seconds: float) -> float:
        tr = obs.enable() if on else None
        win = drv.window(seconds)
        row = {"pair": label, "tracing": on,
               "candidates_per_s": win["candidates"] / win["wall_s"],
               "searches": win["attempted"],
               "sm_clock_mhz": _sm_clock_mhz() if cuda else None}
        if on:
            ctx = Context(setup_s=0.0, window=win, spans=list(tr.spans))
            row.update({m: reader(m)(ctx) for m in SPAN_METRICS})
            obs.disable()
        print(json.dumps(row), flush=True)
        return row["candidates_per_s"]

    if args.warmup > 0:
        window(True, "warmup", args.warmup)
    rates = {False: [], True: []}
    ratios = []
    for pair in range(args.pairs):
        got = {on: window(on, pair, args.seconds)
               for on in ((False, True) if pair % 2 == 0 else (True, False))}
        for on, rate in got.items():
            rates[on].append(rate)
        ratios.append(got[True] / got[False])
    print(json.dumps({
        "workload": args.workload, "seed": args.seed,
        "off": {"median": statistics.median(rates[False]),
                "quartiles": _quartiles(rates[False])},
        "on": {"median": statistics.median(rates[True]),
               "quartiles": _quartiles(rates[True])},
        "on_over_off_median": statistics.median(ratios),
        "pairs": args.pairs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
