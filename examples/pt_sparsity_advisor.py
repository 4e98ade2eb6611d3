"""The framework bridge on the PyTorch port: Sparseloop advises N:M
sparsity configs for the assigned LM architectures on a modelled TPU
v5e (the accelerator under study), and the advised 2:8 config is
executed on the H100 by the N:M kernel K3 (``nm_spmm``, CUDA C++ for
sm_90a), held to its plain PyTorch version (the counterpart of
``sparsity_advisor.py``).

  PYTHONPATH=src python examples/pt_sparsity_advisor.py          # the card
  PYTHONPATH=src python examples/pt_sparsity_advisor.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.advisor import advise, describe
from repro_torch.core.device import resolve_device
from repro_torch.kernels.nm_spmm.ops import nm_spmm, nm_spmm_plain
from repro_torch.sparsity import nm_prune_dense, pack_nm

#: K3 against its plain version, relative to the largest magnitude (both
#: accumulate the bf16 products in f32; the kernel tests' bound)
REL_BOUND = 1e-5

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="where the engine and the kernel run (default: the "
                     "CUDA card; on the CPU the kernel's plain version "
                     "runs)")
device = resolve_device(ap.parse_args().device)

print("== Sparseloop TPU-v5e advisor ==")
print("decode (8 tokens/device): weight streaming dominates -> compress")
for arch in ("qwen3-4b", "command-r-35b", "deepseek-v2-lite-16b"):
    cfg = get_config(arch)
    print(f"\n--- {arch}, decode ---")
    print(describe(advise(cfg, tokens_per_device=8, device=device)))
print("\ntrain (65536 tokens/device): compute-bound -> stay dense "
      "(the MXU cannot skip; DESIGN.md §3)")
print(describe(advise(get_config("qwen3-4b"), tokens_per_device=65536,
                      device=device)))

kernel = ("the H100 kernel K3 (nm_spmm.cu)" if device.type == "cuda"
          else "K3's plain PyTorch version (CPU)")
print(f"\n== executing the advised 2:8 config with {kernel} ==")
rng = np.random.default_rng(0)
M, K, N = 128, 512, 256
a = torch.from_numpy(rng.normal(size=(M, K))).to(torch.bfloat16).to(device)
w = nm_prune_dense(torch.from_numpy(rng.normal(size=(K, N))).float(), 2, 8)
wv, wi = pack_nm(w, 2, 8)
wv, wi = wv.to(torch.bfloat16).to(device), wi.to(device)
out = nm_spmm(a, wv, wi, n=2, m=8)
ref = nm_spmm_plain(a, wv, wi, n=2, m=8)
err = float((out - ref).abs().max())
rel = err / max(float(ref.abs().max()), 1e-30)
dense_bytes = K * N * 2
packed_bytes = wv.numel() * 2 + wi.numel()
print(f"kernel vs plain version max|err| = {err:.4f} (bf16)")
print(f"relative to the largest |out|: {rel:.3g} (bound {REL_BOUND:g})")
if rel > REL_BOUND:
    raise SystemExit(f"K3 disagrees with its plain version: {rel:.3g}")
print(f"HBM weight bytes: {packed_bytes} vs dense {dense_bytes} "
      f"({packed_bytes / dense_bytes:.3f}x) -> the advisor's predicted "
      f"~3x decode speedup comes from exactly this traffic cut")
print(f"K3 launches: {nm_spmm.launches}")
