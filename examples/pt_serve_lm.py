"""Batched serving on the PyTorch port: continuous batching over a
reduced model (the counterpart of ``serve_lm.py``).

  PYTHONPATH=src python examples/pt_serve_lm.py              # the card
  PYTHONPATH=src python examples/pt_serve_lm.py --device cpu
"""
import argparse

from repro_torch.launch.serve import main

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="where the model runs (default: the CUDA card)")
device = ap.parse_args().device

out = main(["--arch", "qwen2-0.5b", "--reduced", "--requests", "10",
            "--batch", "4", "--prompt-len", "12", "--gen", "16",
            "--temperature", "0.8"]
           + ([] if device is None else ["--device", device]))
print(f"generated {sum(len(v) for v in out['outputs'].values())} tokens "
      f"across {len(out['outputs'])} requests at "
      f"{out['tokens_per_s']:.1f} tok/s")
