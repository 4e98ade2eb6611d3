"""End-to-end training on the PyTorch port: trains a reduced qwen2 on
the synthetic Zipf-Markov corpus with checkpointing + fault tolerance,
then kills and resumes to demonstrate restart-elasticity (the
counterpart of ``train_lm.py``).  On the card the attention of the
forward and its recompute runs through the flash-attention kernel K4
wherever the sequence is a multiple of 128; the count of its launches
is printed.

  PYTHONPATH=src python examples/pt_train_lm.py                # the card
  PYTHONPATH=src python examples/pt_train_lm.py --device cpu
  PYTHONPATH=src python examples/pt_train_lm.py --full         # ~0.5B
"""
import argparse
import tempfile

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch.train import main

ap = argparse.ArgumentParser()
ap.add_argument("--full", action="store_true")
ap.add_argument("--device", default=None,
                help="where the model trains (default: the CUDA card)")
opts = ap.parse_args()


def run(ckpt: str) -> None:
    """Train, then resume from the checkpoints in ``ckpt``."""
    if opts.full:
        # ~0.5B-param full config, few steps
        args = ["--arch", "qwen2-0.5b", "--steps", "5", "--batch", "2",
                "--seq", "512", "--ckpt-dir", ckpt, "--ckpt-every", "2"]
    else:
        args = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "30",
                "--batch", "8", "--seq", "128", "--ckpt-dir", ckpt,
                "--ckpt-every", "10", "--log-every", "5"]
    # the plain module: one process, no mesh to place it on
    args += ["--mesh", "none"]
    if opts.device is not None:
        args += ["--device", opts.device]

    print("=== phase 1: train from scratch ===")
    main(args)

    print("\n=== phase 2: 'crash' and resume from checkpoint ===")
    args[args.index("--steps") + 1] = str(int(
        args[args.index("--steps") + 1]) + 10)
    out2 = main(args)
    print(f"\nresumed run continued from the checkpoint "
          f"(ran {len(out2['losses'])} additional steps)")
    print(f"K4 launches: {fa_ops.flash_attention.launches}")


with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as ckpt:
    run(ckpt)
