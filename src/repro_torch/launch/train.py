"""End-to-end training driver with fault tolerance (the JAX package's
``launch/train.py``).

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --device cpu --steps 40 --batch 4 --seq 128 \
      --ckpt-dir /tmp/repro_ckpt

Without ``--device`` it runs on the CUDA card (and raises without one).
Restart the same command after killing it: it resumes from the latest
checkpoint (params, optimizer, data cursor) on the device it is given.
"""
from __future__ import annotations

import argparse
import tempfile

import torch

from ..checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..configs import ARCH_NAMES, get_config
from ..core.device import resolve_device
from ..data import DataState, make_pipeline
from ..models import get_api
from ..optim import adamw_init
from ..runtime import Heartbeat, StragglerWatchdog
from .steps import abstract_params, make_train_step


def main(argv=None) -> dict:
    """Train ``--arch`` for ``--steps`` steps; returns {"losses": the
    loss of every step run, "stragglers": the watchdog's (step, seconds)
    flags, "step_s": each step's wall seconds, ending with the loss read
    back to the host}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu "
                         "to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    device = resolve_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
          f"{where}")

    start_step = 0
    pipe = make_pipeline(cfg, args.seq, args.batch, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        skeleton = abstract_params(cfg)
        restored, extra = load_checkpoint(
            args.ckpt_dir, {"params": skeleton, "opt": adamw_init(skeleton)},
            device=device)
        model, opt_state = restored["params"], restored["opt"]
        pipe.restore(DataState.from_dict(extra["data"]))
        start_step = int(extra["step"])
        print(f"[train] resumed from step {start_step}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = get_api(cfg).init(cfg, gen, device)
        opt_state = adamw_init(model)

    train_step = make_train_step(cfg, lr=args.lr)

    wd = StragglerWatchdog(on_straggle=lambda s, dt, ema: print(
        f"[watchdog] step {s} straggled: {dt:.2f}s vs ema {ema:.2f}s"))
    losses, step_s = [], []
    hb_dir = args.ckpt_dir or tempfile.gettempdir()
    with Heartbeat(f"{hb_dir}/heartbeat"):
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(pipe).items()}
            wd.start_step()
            model, opt_state, metrics = train_step(model, opt_state, batch)
            loss = float(metrics["loss"])
            step_s.append(wd.end_step())
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f}")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, {"params": model, "opt": opt_state},
                               extra={"step": step + 1,
                                      "data": pipe.state.to_dict()})
    if mgr:
        mgr.save_async(args.steps, {"params": model, "opt": opt_state},
                       extra={"step": args.steps,
                              "data": pipe.state.to_dict()})
        mgr.wait()
    if losses:
        print(f"[train] done: first loss {losses[0]:.4f} -> last loss "
              f"{losses[-1]:.4f}, stragglers={len(wd.straggles)}")
    return {"losses": losses, "stragglers": wd.straggles, "step_s": step_s}


if __name__ == "__main__":
    main()
