"""The readings that the judge's limits are set from (not run by the
benchmark's own runs).

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 --seconds 10

Sets the cell up once, then for each seed runs one window as the
benchmark does and reads every number the judge compares twice on the
same rows and generations: as the program answered (the lower reading)
and with the control in the program's place, the reference computed in
float32 (the upper reading).  One JSON line a seed; on a CUDA card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from run import ROOT, _environment  # noqa: F401  (sets sys.path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _environment()
    import torch
    from portbench.harness import judge
    from portbench.harness.cell import DRIVERS, cell_entry, load_benchmark
    from portbench.harness.config import Config
    torch.set_num_threads(2)
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = cell_entry(load_benchmark(), args.workload)
    cfg = Config.load(cell["config"])
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    dev = None if args.device == "cuda" else args.device
    ref = judge.Reference(cfg)
    for seed in seeds:
        drv = DRIVERS[traffic["mode"]](cfg, traffic, seed, dev)
        t0 = time.perf_counter()
        drv.setup()
        setup = time.perf_counter() - t0
        win = drv.window(args.seconds)
        rows, gens = win.pop("rows"), win.pop("generations")
        prog = judge.readings(rows, cfg, missing=win["failed"], gens=gens,
                              stalled=win["stalled"], reference=ref)
        ctl_rows, ctl_gens = judge.control(rows, gens, cfg)
        ctl = judge.readings(ctl_rows, cfg, gens=ctl_gens, reference=ref)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "setup_s": setup, "rows": len(rows),
                          "generations": len(gens),
                          "attempted": win["attempted"],
                          "program": prog, "control": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
