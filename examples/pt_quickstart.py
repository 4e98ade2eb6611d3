"""Quickstart on the PyTorch port: describe a sparse accelerator with the
SAF taxonomy and evaluate it with Sparseloop's three-step analytical
pipeline (the counterpart of ``quickstart.py``).

  PYTHONPATH=src python examples/pt_quickstart.py            # the card
  PYTHONPATH=src python examples/pt_quickstart.py --device cpu
"""
import argparse

from repro_torch.core import Sparseloop, matmul, nest
from repro_torch.core.device import resolve_device
from repro_torch.core.presets import (coordinate_list_design, dense_design,
                                      two_level_arch)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="where the engine runs (default: the CUDA card)")
device = resolve_device(ap.parse_args().device)

# 1. Workload: sparse matmul Z[m,n] = sum_k A[m,k] B[k,n]  (Fig. 6 style)
wl = matmul(64, 64, 64, densities={"A": ("uniform", 0.25),
                                   "B": ("uniform", 0.5)})

# 2. Mapping: coordinate-space tiling across DRAM -> Buffer -> 4 PEs
mapping = nest(2,
               ("m", 16, 1), ("n", 4, 1), ("n", 4, 1, "spatial"),
               ("n", 4, 0), ("k", 64, 0), ("m", 4, 0))
print("mapping:")
print(mapping.describe(), "\n")

# 3. Designs: dense baseline vs SCNN-like coordinate-list + skipping
for design in (dense_design(two_level_arch()),
               coordinate_list_design(two_level_arch())):
    ev = Sparseloop(design, device=device).evaluate(wl, mapping)
    print(f"=== {design.name} ===")
    print(design.safs.describe())
    print(ev.result.describe(), "\n")
