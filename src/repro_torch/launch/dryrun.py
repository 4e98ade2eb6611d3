"""Multi-pod dry run: show that the distribution config is coherent (the
JAX package's ``launch/dryrun.py``).

For every (architecture x input shape) cell, run the relevant step
(train_step / prefill / decode) once on the production mesh, single-pod
16x16 and multi-pod 2x16x16, and record this rank's FLOPs and bytes,
its collective traffic by kind and its memory.  Where the reference
lowers and compiles for 256 or 512 fake CPU devices, the port opens a
``"fake"`` process group of that many ranks in this one process
(``mesh.fake_world``), places every input as a DTensor whose local
shard is on the meta device (``steps.input_specs``), and runs the step
eagerly inside ``sharding.ShardedExecution`` under
``costanalysis.CostMode``: DTensor computes each op's placement and
issues its collectives into the fake group, which moves nothing, and
only shapes are computed.  No kernel runs, as none runs in the
reference's CPU dry run.

Records go to ``results/dryrun_torch/`` (never the reference's
``results/dryrun/``) and ``roofline.py`` reads them.  An error is
recorded, not raised.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import signal
import threading
import time
import traceback

import torch

from ..configs import ARCH_NAMES, get_config
from ..optim import adamw_init
from .costanalysis import CostMode
from .mesh import fake_world, make_production_mesh, production_mesh_shape
from .sharding import ShardedExecution
from .steps import (SHAPES, abstract_batch, abstract_cache, abstract_params,
                    cell_applicable, input_specs, make_decode_step,
                    make_prefill_step, make_train_step)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / \
    "dryrun_torch"


def _local_tensors(tree):
    """Every tensor (a DTensor's local shard) in a tree of inputs."""
    if isinstance(tree, torch.nn.Module):
        yield from (p for p in tree.parameters())
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _local_tensors(v)
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _local_tensors(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _local_tensors(v)


def _where(tb) -> str:
    """Where in the port a traceback stopped, as file:line function: the
    innermost frame of the models (the op of the step), then the
    innermost of the port if that is elsewhere."""
    frames = [f for f in traceback.extract_tb(tb)
              if "repro_torch" in f.filename and f.name != "fire"]
    model = [f for f in frames if "/models/" in f.filename]
    picked = [f for f in (model[-1:] + frames[-1:])]
    if len(picked) == 2 and picked[0] is picked[1]:
        picked = picked[:1]
    return " <- ".join(f"{pathlib.Path(f.filename).name}:{f.lineno} "
                       f"{f.name}" for f in picked)


def _step(cfg, shape, remat_policy, inputs):
    """(step function, its arguments) of one cell from ``input_specs``'s
    dict (or the same keys unsharded)."""
    if shape.kind == "train":
        return (make_train_step(cfg, remat_policy=remat_policy),
                (inputs["params"], inputs["opt_state"], inputs["batch"]))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, S_max=shape.seq + 128),
                (inputs["params"], inputs["batch"]))
    return (make_decode_step(cfg),
            (inputs["params"], inputs["cache"], inputs["batch"]["token"],
             inputs["pos"]))


def world1_costs(cfg, shape, remat_policy: str = "full"):
    """The cost count of one step of the cell on one rank: the whole
    model and batch as plain tensors on the meta device (inside
    ``ShardedExecution`` for its meta ``bincount``)."""
    model, _ = abstract_params(cfg)
    batch, _ = abstract_batch(cfg, shape)
    inputs = {"params": model, "batch": batch}
    if shape.kind == "train":
        inputs["opt_state"] = adamw_init(model)
    if shape.kind == "decode":
        inputs["cache"] = abstract_cache(cfg, shape.batch, shape.seq)[0]
        inputs["pos"] = torch.zeros((), dtype=torch.int32, device="meta")
    fn, args = _step(cfg, shape, remat_policy, inputs)
    with CostMode() as cm, ShardedExecution():
        fn(*args)
    return cm.costs


class CellTimeout(Exception):
    """A cell ran past its time limit."""


@contextlib.contextmanager
def _time_limit(seconds: float | None):
    """Raise :class:`CellTimeout` in the body after ``seconds`` (SIGALRM;
    none off the main thread or for None)."""
    if not seconds or threading.current_thread() is not \
            threading.main_thread():
        yield
        return

    def fire(signum, frame):
        raise CellTimeout(f"the cell ran past its limit of {seconds:g} s")

    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True, policy: str = "tp",
             remat_policy: str = "full", variant: str = "",
             cfg_overrides: dict | None = None,
             time_limit: float | None = None) -> dict:
    """One cell's record: status ``ok`` with this rank's counts,
    ``skipped`` (long_500k on a full-attention arch) or ``error`` with
    the exception and the op of the port where it stopped (a cell past
    ``time_limit`` seconds ends so, where it was)."""
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    multi = mesh_kind == "multi"
    ranks = 1
    for _, n in production_mesh_shape(multi_pod=multi):
        ranks *= n
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "ranks": ranks, "params": cfg.param_count(), "variant": variant,
           "policy": policy, "remat_policy": remat_policy}
    if not ok:
        rec |= {"status": "skipped", "reason": why}
        return rec

    t0 = time.time()
    try:
        with _time_limit(time_limit), fake_world(ranks):
            mesh = make_production_mesh(multi_pod=multi)
            fn, args = _step(cfg, shape, remat_policy,
                             input_specs(cfg, shape, mesh, policy=policy))
            t_place = time.time() - t0
            with CostMode(track_memory=True) as cm:
                arg_bytes = cm.exclude(
                    getattr(t, "_local_tensor", t)
                    for t in _local_tensors(args))
                with ShardedExecution() as sx:
                    fn(*args)
            t_run = time.time() - t0 - t_place
    except Exception as e:  # noqa: BLE001 — record, don't crash the sweep
        rec |= {"status": "error", "error": f"{type(e).__name__}: {e}"[:2000],
                "where": _where(e.__traceback__),
                "trace": traceback.format_exc()[-2000:]}
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: "
                  f"{rec['where']}: {rec['error'][:200]}")
        return rec

    hc = cm.costs
    try:
        w1 = world1_costs(cfg, shape, remat_policy).dot_flops
    except Exception:  # noqa: BLE001 — an op with no meta kernel
        w1 = None
    coll = dict(hc.collective_bytes)
    coll["count"] = hc.collective_count
    rec |= {
        "status": "ok",
        "place_s": t_place,
        "run_s": t_run,
        # the port counts the dots only: ``flops`` is ``dot_flops``
        "flops": hc.dot_flops,
        "dot_flops": hc.dot_flops,
        "dot_bytes": hc.dot_bytes,
        # the same step on one rank (None where the meta device cannot
        # run it); dot_flops x ranks - this is the replicated work
        "world1_dot_flops": w1,
        "collectives": coll,
        "memory": {
            "argument_bytes": float(arg_bytes),
            "temp_bytes": float(hc.peak_temp_bytes),
            "peak_bytes": float(arg_bytes + hc.peak_temp_bytes),
        },
        # ops where DTensor could not keep a sharding and the step
        # gathered (ShardedExecution), by op name
        "gathered_ops": dict(sx.fallbacks),
    }
    if verbose:
        cb = sum(v for k, v in coll.items() if k != "count")
        print(f"[ OK ] {arch:24s} {shape_name:12s} {mesh_kind:6s} "
              f"dot_flops={hc.dot_flops:.4g} dot_bytes={hc.dot_bytes:.4g} "
              f"peak={rec['memory']['peak_bytes'] / 2 ** 30:.2f}GiB "
              f"coll={cb / 2 ** 30:.3f}GiB "
              f"({t_place:.1f}s place, {t_run:.1f}s run)")
    return rec


def _run_cell_args(cell_and_limit) -> dict:
    cell, limit = cell_and_limit
    return run_cell(*cell, time_limit=limit)


def save(rec: dict) -> pathlib.Path:
    RESULTS.mkdir(parents=True, exist_ok=True)
    suffix = f"__{rec['variant']}" if rec.get("variant") else ""
    path = RESULTS / (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
                      f"{suffix}.json")
    path.write_text(json.dumps(rec, indent=1))
    return path


def main(argv=None) -> dict:
    """Run and save the cells asked for; returns {"ok", "skipped",
    "error": counts, "seconds": wall seconds}.  Exits 1 if a cell
    ended in an error, as the reference does."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    ap.add_argument("--cell-timeout", type=float, default=0,
                    help="seconds a cell may run before it is recorded as "
                         "an error where it stopped (0: no limit)")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(a, s, m) for a in ARCH_NAMES for s in SHAPES
                 for m in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, m) for m in meshes]

    t0 = time.time()
    counts = {"ok": 0, "skipped": 0, "error": 0}
    todo = []
    for a, s, m in cells:
        path = RESULTS / f"{a}__{s}__{m}.json"
        if args.skip_existing and path.exists():
            st = json.loads(path.read_text()).get("status")
            if st in ("ok", "skipped"):
                counts[st] += 1
                continue
        todo.append((a, s, m))
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(args.jobs,
                                 mp_context=mp.get_context("spawn")) as ex:
            recs = ex.map(_run_cell_args,
                          [(c, args.cell_timeout) for c in todo])
            for rec in recs:
                save(rec)
                counts[rec["status"]] += 1
    else:
        for cell in todo:
            rec = run_cell(*cell, time_limit=args.cell_timeout)
            save(rec)
            counts[rec["status"]] += 1
    counts["seconds"] = time.time() - t0
    print(f"[dryrun] {counts}")
    if counts["error"]:
        raise SystemExit(1)
    return counts


if __name__ == "__main__":
    main()
