"""Design-space exploration (paper Sec. 7 style) on the PyTorch port:
sweep SAF choices and densities, search the mapspace for each design,
and pick the best design per application regime — plus the vectorized
mapper for large mapspaces (the counterpart of
``design_space_exploration.py``).

  PYTHONPATH=src python examples/pt_design_space_exploration.py
  PYTHONPATH=src python examples/pt_design_space_exploration.py \\
      --device cpu
"""
import argparse

from repro_torch.core import matmul
from repro_torch.core.device import resolve_device
from repro_torch.core.mapper import MapspaceConstraints, search
from repro_torch.core.presets import (bitmask_design, coordinate_list_design,
                                      dense_design, two_level_arch)
from repro_torch.core.vmapper import VDesign, search as vsearch

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="where the batched engine runs (default: the CUDA "
                     "card)")
device = resolve_device(ap.parse_args().device)

M = K = N = 32

print("== per-design mapspace search (engine, exact) ==")
for density in (0.05, 0.5):
    wl = matmul(M, K, N, densities={"A": ("uniform", density),
                                    "B": ("uniform", density)})
    best = {}
    for mk in (dense_design, bitmask_design, coordinate_list_design):
        design = mk(two_level_arch())
        res = search(design, wl,
                     MapspaceConstraints(budget=150, seed=1),
                     device=device)
        best[design.name] = res
        print(f"density={density:4.2f} {design.name:10s} "
              f"best EDP={res.best.edp:10.3e} "
              f"(evaluated {res.evaluated}, {res.valid} valid)")
    winner = min(best, key=lambda k: best[k].best.edp)
    print(f"  -> best design at density {density}: {winner}\n")

print("== vectorized mapspace search (vmapper, batched) ==")
factors, metrics, n_cand = vsearch(64, 64, 64, 0.3, 0.5,
                                   two_level_arch(), VDesign(),
                                   device=device)
print(f"evaluated {n_cand} mappings in one batched evaluation; best "
      f"factors (m1,m0,n1,ns,n0)={tuple(int(x) for x in factors)} "
      f"cycles={metrics['cycles']:.0f} EDP={metrics['edp']:.3e}")
