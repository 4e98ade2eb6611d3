"""Design-space exploration with stochastic mapspace search on the
PyTorch port (the counterpart of ``search_dse.py``).

Where ``pt_design_space_exploration.py`` enumerates a truncated mapspace
per design, this example drives the ``repro_torch.search`` subsystem: an
evolution strategy (and friends) spends the *same* evaluation budget
adaptively, so each design is characterized by a better mapping — which
can change which design wins a regime (the paper's Sec. 7 co-design
point: mapper quality is part of the design comparison).  Populations
are sharded over every visible card (``population_mesh``).

  PYTHONPATH=src python examples/pt_search_dse.py
  PYTHONPATH=src python examples/pt_search_dse.py --device cpu
"""
import argparse

from repro_torch.core import matmul
from repro_torch.core.device import resolve_device
from repro_torch.core.mapper import MapspaceConstraints, search
from repro_torch.core.presets import (bitmask_design, coordinate_list_design,
                                      dense_design, two_level_arch)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="where the batched engine runs (default: the CUDA "
                     "card)")
device = resolve_device(ap.parse_args().device)

M = K = N = 64
BUDGET = 256

print("== enumeration vs stochastic search, equal budget ==")
for density in (0.05, 0.5):
    wl = matmul(M, K, N, densities={"A": ("uniform", density),
                                    "B": ("uniform", density)})
    best = {}
    for mk in (dense_design, bitmask_design, coordinate_list_design):
        design = mk(two_level_arch())
        cons = MapspaceConstraints(budget=BUDGET, seed=1,
                                   spatial={1: {"n": 8}})
        enum = search(design, wl, cons, device=device)
        es = search(design, wl, cons, strategy="es", key=1, pop_size=32,
                    device=device)
        best[design.name] = es
        gain = enum.best.edp / es.best.edp if es.best else float("nan")
        print(f"density={density:4.2f} {design.name:10s} "
              f"enum EDP={enum.best.edp:10.3e}  "
              f"es EDP={es.best.edp:10.3e}  ({gain:5.2f}x)")
    winner = min(best, key=lambda k: best[k].best.edp)
    print(f"  -> best design at density {density}: {winner}\n")

print("== trajectory of one search (best-so-far EDP per generation) ==")
wl = matmul(M, K, N, densities={"A": ("uniform", 0.3),
                                "B": ("uniform", 0.5)})
res = search(coordinate_list_design(two_level_arch()), wl,
             MapspaceConstraints(budget=512, seed=0,
                                 spatial={1: {"n": 8}}),
             strategy="es", key=0, pop_size=64, device=device)
for rec in res.log.records:
    print(f"  gen {rec.generation}: evals={rec.evaluations:4d} "
          f"best EDP={rec.best_edp:.4e}")
print("winning mapping (validated through the scalar oracle):")
print(res.best_nest.describe())
