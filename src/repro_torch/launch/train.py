"""End-to-end training driver with fault tolerance (the JAX package's
``launch/train.py``).

Example (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
      --reduced --device cpu --steps 40 --batch 4 --seq 128 \
      --ckpt-dir /tmp/repro_ckpt

Without ``--device`` it runs on the CUDA card (and raises without one).
As the reference's CLI, the model is placed by its partition specs on
``make_debug_mesh()`` over the ranks alive (``torchrun`` ranks; one rank
gives a (1, 1) mesh, which still runs every op through DTensor), its
optimizer state ZeRO-1 placed, and the step runs inside
``sharding.ShardedExecution``; ``--mesh none`` trains the plain module.
Restart the same command after killing it: it resumes from the latest
checkpoint (params, optimizer, data cursor) on the device and mesh it
is given (resharding restore).  ``--compress-grads`` reduces the
data-parallel gradients with the int8 all-reduce
(``runtime.compressed_grad_allreduce``); it is off unless asked for.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile

import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager, latest_step, load_checkpoint
from ..configs import ARCH_NAMES, get_config
from ..core.device import resolve_device
from ..data import DataState, make_pipeline
from ..models import get_api
from ..optim import adamw_init, zero1_specs
from ..runtime import Heartbeat, StragglerWatchdog
from .mesh import axis_sizes, make_debug_mesh
from .sharding import (ShardedExecution, batch_spec, shard_tree,
                       sharding_tree)
from .steps import abstract_params, make_train_step


def _scalar(x) -> float:
    """A metric as a host float (a DTensor's whole value)."""
    return float(x.full_tensor() if hasattr(x, "full_tensor") else x)


def main(argv=None) -> dict:
    """Train ``--arch`` for ``--steps`` steps; returns {"losses": the
    loss of every step run, "stragglers": the watchdog's (step, seconds)
    flags, "step_s": each step's wall seconds, ending with the loss read
    back to the host}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0: as "
                         "configured)")
    ap.add_argument("--dtype", default="",
                    help="the weights' and activations' type (default: "
                         "the configuration's)")
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
    ap.add_argument("--mesh", choices=("debug", "none"), default="debug",
                    help="debug: place the model on make_debug_mesh() over "
                         "the ranks alive; none: the plain module")
    ap.add_argument("--compress-grads", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    device = resolve_device(args.device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    own_group = args.mesh == "debug" and not dist.is_initialized()
    mesh = make_debug_mesh(device_type=device.type) \
        if args.mesh == "debug" else None
    rank = dist.get_rank() if mesh is not None else 0
    print(f"[train] {cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
          f"{where}, mesh "
          f"{axis_sizes(mesh) if mesh is not None else None}")

    start_step = 0
    pipe = make_pipeline(cfg, args.seq, args.batch, seed=args.seed)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    skeleton, specs = abstract_params(cfg)

    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        shardings = None
        if mesh is not None:
            z1 = sharding_tree(adamw_init(skeleton).mu, zero1_specs(
                specs, dict(skeleton.named_parameters()),
                data_size=axis_sizes(mesh)["data"]), mesh)
            # restore with resharding onto the CURRENT mesh (elastic)
            shardings = {"params": sharding_tree(skeleton, specs, mesh),
                         "opt": {"mu": z1, "nu": z1, "step": None}}
        restored, extra = load_checkpoint(
            args.ckpt_dir, {"params": skeleton, "opt": adamw_init(skeleton)},
            device=device, shardings=shardings, mesh=mesh)
        model, opt_state = restored["params"], restored["opt"]
        pipe.restore(DataState.from_dict(extra["data"]))
        start_step = int(extra["step"])
        print(f"[train] resumed from step {start_step}")
    else:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        model = get_api(cfg).init(cfg, gen, device)
        if mesh is not None:
            opt_state = adamw_init(model, mesh, specs)
            shard_tree(model, specs, mesh)
        else:
            opt_state = adamw_init(model)

    train_step = make_train_step(cfg, lr=args.lr,
                                 compress_grads=args.compress_grads,
                                 mesh=mesh)
    b_spec = batch_spec(mesh, args.batch) if mesh is not None else None

    wd = StragglerWatchdog(on_straggle=lambda s, dt, ema: print(
        f"[watchdog] step {s} straggled: {dt:.2f}s vs ema {ema:.2f}s"))
    losses, step_s = [], []
    hb_dir = args.ckpt_dir or tempfile.gettempdir()
    with Heartbeat(f"{hb_dir}/heartbeat" + (f".{rank}" if rank else "")):
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in next(pipe).items()}
            if mesh is not None:
                batch = shard_tree(batch, {k: b_spec for k in batch}, mesh)
            wd.start_step()
            with (ShardedExecution() if mesh is not None
                  else contextlib.nullcontext()):
                model, opt_state, metrics = train_step(model, opt_state,
                                                       batch)
            loss = _scalar(metrics["loss"])
            step_s.append(wd.end_step())
            losses.append(loss)
            if step % args.log_every == 0 and rank == 0:
                print(f"[train] step {step:5d} loss {loss:8.4f} "
                      f"gnorm {_scalar(metrics['grad_norm']):7.3f}")
            if mgr and (step + 1) % args.ckpt_every == 0:
                mgr.save_async(step + 1, {"params": model, "opt": opt_state},
                               extra={"step": step + 1,
                                      "data": pipe.state.to_dict()},
                               write=rank == 0)
    if mgr:
        mgr.save_async(args.steps, {"params": model, "opt": opt_state},
                       extra={"step": args.steps,
                              "data": pipe.state.to_dict()},
                       write=rank == 0)
        mgr.wait()
    if own_group:
        dist.destroy_process_group()
    if losses and rank == 0:
        print(f"[train] done: first loss {losses[0]:.4f} -> last loss "
              f"{losses[-1]:.4f}, stragglers={len(wd.straggles)}")
    return {"losses": losses, "stragglers": wd.straggles, "step_s": step_s}


if __name__ == "__main__":
    main()
