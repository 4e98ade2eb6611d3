"""Mapspace hillclimb launcher — stochastic search at production scale.

Runs any of the search strategies (hillclimb by default) over a design
preset x matmul-layer mapspace, evaluating each generation's whole
population through the batched engine on the CUDA card (``--device
cpu`` runs it on the CPU).

Set ``REPRO_SEARCH_DEVICES=8`` to shard the population axis over 8
simulated devices (the shards run in turn on the one device,
``search.runner.auto_mesh``), as the JAX package's CLI forces 8 host
devices on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
      --design scnn --mkn 3136 576 64 --densities 0.4 0.55 \\
      --strategy hillclimb --budget 2048 --pop 64 --seed 0 \\
      --out hillclimb_log.json
"""
from __future__ import annotations

import argparse
import time

from ..core import matmul
from ..core.device import resolve_device
from ..core.mapper import MapspaceConstraints
from ..core.presets import (bitmask_design, coordinate_list_design,
                            dense_design, eyeriss_like, scnn_like,
                            three_level_arch, two_level_arch)
from ..search import STRATEGIES, run_search
from ..search.runner import auto_mesh

DESIGNS = {
    "dense": lambda: dense_design(two_level_arch()),
    "bitmask": lambda: bitmask_design(two_level_arch()),
    "coordlist": lambda: coordinate_list_design(two_level_arch()),
    "eyeriss": lambda: eyeriss_like(three_level_arch()),
    "scnn": lambda: scnn_like(three_level_arch()),
}


def main(argv: list[str] | None = None):
    """Run the CLI; returns the ``SearchResult``."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--design", choices=sorted(DESIGNS), default="scnn")
    p.add_argument("--mkn", nargs=3, type=int, default=(3136, 576, 64),
                   metavar=("M", "K", "N"),
                   help="matmul layer dims (default: ResNet50 conv2_x)")
    p.add_argument("--densities", nargs=2, type=float, default=(0.4, 0.55),
                   metavar=("dA", "dB"))
    p.add_argument("--strategy", choices=sorted(STRATEGIES),
                   default="hillclimb")
    p.add_argument("--budget", type=int, default=2048,
                   help="total candidate evaluations")
    p.add_argument("--pop", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--spatial-n", type=int, default=8,
                   help="forced spatial fanout on rank n (0 = none)")
    p.add_argument("--out", default="",
                   help="write the SearchLog trajectory JSON here")
    p.add_argument("--device", default=None,
                   help="where the batched engine runs (default: the "
                        "CUDA card; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    mesh = auto_mesh(device)
    M, K, N = args.mkn
    dA, dB = args.densities
    wl = matmul(M, K, N, densities={"A": ("uniform", dA),
                                    "B": ("uniform", dB)})
    design = DESIGNS[args.design]()
    spatial = ({1: {"n": args.spatial_n}}
               if args.spatial_n > 1 and N % args.spatial_n == 0 else None)
    cons = MapspaceConstraints(budget=args.budget, seed=args.seed,
                               spatial=spatial)

    print(f"--- {args.strategy} on {args.design} x "
          f"matmul({M},{K},{N}) d=({dA},{dB}) ---")
    devices = 1 if mesh is None else mesh.size
    simulated = " (simulated)" if mesh is not None and mesh.simulated \
        else ""
    print(f"    device={device} devices={devices}{simulated} "
          f"budget={args.budget} pop={args.pop} seed={args.seed}",
          flush=True)
    t0 = time.perf_counter()
    res = run_search(design, wl, cons, strategy=args.strategy,
                     key=args.seed, pop_size=args.pop, mesh=mesh,
                     device=device)
    dt = time.perf_counter() - t0

    for rec in res.log.records:
        print(f"    gen {rec.generation:3d}  evals {rec.evaluations:6d}  "
              f"best EDP {rec.best_edp:.4e}", flush=True)
    if res.best is None:
        print(f"    no valid mapping found ({res.evaluated} evaluated)")
        return res
    print(f"    best: cycles={res.best.cycles:.4g} "
          f"energy={res.best.energy_pj:.4g}pJ EDP={res.best.edp:.4g}  "
          f"({res.evaluated} evals, {res.valid} valid, {dt:.1f}s)")
    print(res.best_nest.describe())
    if args.out:
        res.log.save(args.out)
        print(f"    wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
