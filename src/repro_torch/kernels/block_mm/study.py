"""K1 and K2 timed under every K split at the chip_smoke cells.

``ops.plan`` takes its split from K3's policy (``splitk.split_aim``:
two waves of blocks, a power of two up to 16), cut to the block list's
longest run.  This study measures that choice for K1 and K2: each
kernel, on the chip_smoke inputs (``fleet.validate.block_cell_inputs``,
blocks of 64 at density 0.25, seed 0), is launched under the plan's
split and under every other power of two from 1 to 16 that the run
allows (:func:`slices`), through the library's C interface with the
plan's kernel and tiles; each launch is held to the plain version at
1e-5 of the largest magnitude and timed as CUDA-graph replays over input
sets twice the L2 cache, as ``chip_smoke.py`` times the wrappers.  K1
runs on the nonzero block list (masked W) and on the full list
(unmasked W), the numerators of the block agreement arms.  Needs a CUDA
device and nvcc:

    PYTHONPATH=src python -m repro_torch.kernels.block_mm.study

prints one row per (cell, kernel, split) with its time and the plan's
split, and a JSON summary last.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from ...fleet.validate import block_cell_inputs, cuda_graph
from ..splitk import sm_count
from . import ops

#: the chip_smoke cells: (name, M, K, N, dtype)
CELLS = (("ffn_gate_up", 8, 896, 9728, torch.float32),
         ("lm_head", 8, 896, 151936, torch.float32),
         ("ffn_down", 128, 4864, 896, torch.bfloat16))
BS, DENSITY, SEED = 64, 0.25, 0
#: K splits aimed at, cut to the run as ``ops.plan`` cuts its own
SPLITS = (1, 2, 4, 8, 16)
TOL = 1e-5
L2_BYTES = 50 * 2 ** 20


def slices(run: int, aim: int) -> tuple[int, int]:
    """(split, most k blocks a slice holds) for ``aim`` slices aimed at
    over a longest run of ``run`` blocks, as ``ops.plan`` cuts its
    own."""
    split = min(aim, run)
    split = 1 << (split.bit_length() - 1)
    return split, math.ceil(run / split)


def _time_ms(fn, sets, reps: int = 5) -> float:
    """Milliseconds per call: min over ``reps`` replays of a CUDA graph
    of back-to-back calls cycling over ``sets``."""
    inner = max(10, len(sets))
    calls = iter(range(10 ** 9))
    graph = cuda_graph(lambda: fn(*sets[next(calls) % len(sets)]), inner)
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def run(seed: int = SEED) -> list[dict]:
    device = torch.device("cuda")
    lib = ops.LIBRARY.lib()
    sms = sm_count(device)
    stream = torch.cuda.current_stream
    rows = []
    for cell, M, K, N, dtype in CELLS:
        x = block_cell_inputs(M, K, N, density=DENSITY, bs=BS, seed=seed,
                              device=device)
        a, w, wm = (x[k].to(dtype) for k in ("a", "w", "wm"))
        mask = torch.as_tensor(x["mask"].astype(np.int32), device=device)
        bf16 = int(dtype == torch.bfloat16)
        kw = dict(bm=min(BS, M), bk=BS, bn=BS)
        for op, w_in in (("skip", wm), ("full", w), ("gate", w)):
            if op == "gate":
                run_len = K // BS
                want = ops.gated_mm_plain(a, w_in, mask, **kw)
            else:
                ks, js = x["nonzero" if op == "skip" else "full"]
                blocks = ops.block_list(ks, js, mask.shape, device)
                run_len = blocks.max_run
                want = ops.skip_mm_plain(a, w_in, ks, js, **kw)
            p = ops.plan(M, K, N, kw["bm"], BS, BS, dtype, sms, run_len)
            elt = a.element_size()
            n_sets = max(1, math.ceil(2 * L2_BYTES / ((M * K + K * N) * elt)))
            sets = [(a.clone(), w_in.clone(), torch.empty((M, N),
                                                          device=device))
                    for _ in range(n_sets)]
            for split, cap in sorted({slices(run_len, s) for s in SPLITS}):
                def launch(a_, w_, o_, split=split, cap=cap):
                    if op == "gate":
                        err = lib.block_mm_gated(
                            a_.data_ptr(), w_.data_ptr(), mask.data_ptr(),
                            o_.data_ptr(), M, K, N, BS, BS, bf16,
                            ops.KERNELS[p.kernel], p.tile[1], split, cap,
                            stream().cuda_stream)
                    else:
                        idx = blocks.index
                        err = lib.block_mm_skip(
                            a_.data_ptr(), w_.data_ptr(), idx.data_ptr(),
                            idx.data_ptr() + 4 * len(blocks.kidx),
                            o_.data_ptr(), M, K, N, BS, BS, bf16,
                            ops.KERNELS[p.kernel], p.tile[1], split, cap,
                            stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{cell} {op} split {split}: "
                                           f"CUDA error {err}")
                launch(*sets[0])
                torch.cuda.synchronize()
                rel = float((sets[0][2] - want).abs().max()
                            / want.abs().max())
                if not rel <= TOL:
                    raise AssertionError(f"{cell} {op} split {split} is off "
                                         f"by {rel} of the largest output")
                rows.append({"cell": cell, "op": op, "kernel": p.kernel,
                             "run": run_len, "split": split, "cap": cap,
                             "plan_split": p.split,
                             "ms": _time_ms(launch, sets), "rel_err": rel})
                print(f"[study] {json.dumps(rows[-1])}")
            del sets
    return rows


def best_splits(rows: list[dict]) -> dict:
    """Per cell and kernel: the plan's split and time, the fastest split
    and its time."""
    out = {}
    for r in rows:
        key = f"{r['cell']}/{r['op']}"
        best = out.setdefault(key, {"plan_split": r["plan_split"],
                                    "best_split": r["split"],
                                    "best_ms": r["ms"]})
        if r["split"] == r["plan_split"]:
            best["plan_ms"] = r["ms"]
        if r["ms"] < best["best_ms"]:
            best.update(best_split=r["split"], best_ms=r["ms"])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = run()
    print(json.dumps({"study": rows, "best": best_splits(rows)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
