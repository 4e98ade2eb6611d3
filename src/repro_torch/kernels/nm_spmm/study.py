"""Where K3's time goes: ``csrc/nm_spmm.cu`` timed with parts removed.

Each variant is the kernel source with one part of the work cut out by a
text substitution (every substitution must match the source as many
times as it names, else this raises): no cluster reduction (each slice
writes its partial tile), no A gathers (the narrow path's FMAs take the
value itself, so its offsets are not decoded either), no decompression
or no ``mma.sync`` (the wide path), only the loads (both paths copy
their ring stages and stage A, and compute nothing; with and without
the reduction), and an empty kernel (the launch of the same grid of
clusters).  A substitution that names only one path leaves the other
as it is: its rows there repeat the unchanged kernel.  The variants'
outputs are wrong by design; only their times are read.  Each is built
into ``build/repro_torch/`` beside the kernel's own library, launched
under the plan of ``ops.plan`` on the chip_smoke cells at 2:4 with int8
offsets, and timed as CUDA-graph replays over input sets twice the L2
cache, as ``chip_smoke.py`` times K3.  The unchanged kernel is also
timed under other K splits than the plan's (1, 2, 4, 8 and 16 slices
aimed at, cut to whole stages as ``ops.plan`` cuts them).  Needs a
CUDA device and nvcc:

    PYTHONPATH=src python -m repro_torch.kernels.nm_spmm.study

prints one row per (cell, variant, split) with its time, the byte
bound, the variant's registers and local memory, and a JSON summary
last.
"""
from __future__ import annotations

import ctypes
import json
import math
from concurrent.futures import ThreadPoolExecutor

import torch

from ..nvcc import BUILD_DIR, CudaLibrary
from . import ops

#: the chip_smoke cells: (name, M, K, N, dtype)
CELLS = (("ffn_gate_up", 8, 896, 9728, torch.float32),
         ("lm_head", 8, 896, 151936, torch.float32),
         ("ffn_down", 128, 4864, 896, torch.bfloat16))
#: K splits aimed at when the unchanged kernel is timed under others
SPLITS = (1, 2, 4, 8, 16)
HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50 * 2 ** 20

_NARROW_FMA = "const float4 a4 = *reinterpret_cast<const float4*>(ar + r);"
_NARROW_STEP = "if (g < left) {  // uniform"
_WIDE_DECOMPRESS = "for (int e = tid; e < P::G * WN / 4; e += WT) {"
_WIDE_MMA = "for (int kk = 0; kk < P::KC; kk += 16) {"
_NARROW_TOP = "const int tid = threadIdx.x, cg = tid % NCG, h = tid / NCG;"
_WIDE_TOP = "const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;"
_NO_REDUCE = [("if (gridDim.x == 1) {", "if (true) {", 2)]
_LOADS_ONLY = [(_NARROW_STEP, _NARROW_STEP.replace("g < left", "false"),
                1),
               (_WIDE_DECOMPRESS, _WIDE_DECOMPRESS.replace(
                   "P::G * WN / 4", "0"), 1),
               (_WIDE_MMA, _WIDE_MMA.replace("P::KC", "0"), 1)]
#: variant -> substitutions (old text, new text, times it must occur)
VARIANTS = {
    "base": [],
    "no_reduce": _NO_REDUCE,
    "no_gather": [(_NARROW_FMA, "const float4 a4 = make_float4(v[c], v[c], "
                   "v[c], v[c]);\n              (void)ar;", 1)],
    "no_decompress": [(_WIDE_DECOMPRESS, _WIDE_DECOMPRESS.replace(
        "P::G * WN / 4", "0"), 1)],
    "no_mma": [(_WIDE_MMA, _WIDE_MMA.replace("P::KC", "0"), 1)],
    "loads_only": _LOADS_ONLY,
    "loads_only_no_reduce": _LOADS_ONLY + _NO_REDUCE,
    "empty": [(_NARROW_TOP, _NARROW_TOP + " if (K > 0) return;", 1),
              (_WIDE_TOP, _WIDE_TOP + " if (K > 0) return;", 1)],
}


def variant_sources() -> dict[str, str]:
    """Every variant's source text, from the kernel's source as it
    stands; raises where a substitution does not match."""
    src = ops.LIBRARY.src.read_text()
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new, times in subs:
            if text.count(old) != times:
                raise ValueError(f"variant {name}: {old!r} occurs "
                                 f"{text.count(old)} times, not {times}")
            text = text.replace(old, new)
        out[name] = text
    return out


def _libraries() -> dict[str, CudaLibrary]:
    """Every variant built, one nvcc each, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, text in variant_sources().items():
        path = BUILD_DIR / f"nm_spmm_{name}.cu"
        path.write_text(text)
        libs[name] = CudaLibrary(path, ops.LIBRARY.signatures)
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(CudaLibrary.lib, libs.values()))
    return libs


def _time_ms(fn, sets, reps: int = 5) -> float:
    """Milliseconds per call: min over ``reps`` replays of a CUDA graph
    of back-to-back calls cycling over ``sets``."""
    from ...fleet.validate import cuda_graph
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


def _variant_info(lib: CudaLibrary, kernel: str, dtype, n: int,
                  m: int) -> dict:
    """Registers and local memory per thread of one variant's kernel."""
    info = (ctypes.c_int * 6)()
    err = lib.lib().nm_spmm_info(n, m, 0, ops.KERNELS[kernel],
                                 int(dtype == torch.bfloat16), info)
    if err:
        raise RuntimeError(f"nm_spmm_info failed: CUDA error {err}")
    return {"registers": info[1], "local_bytes": info[2]}


def _slices(p: ops.Plan, groups: int, aim: int) -> tuple[int, int]:
    """(split, groups per slice) for ``aim`` slices aimed at, in whole
    stages of plan ``p``, as ``ops.plan`` cuts its own."""
    split = min(ops.MAX_SPLIT, aim, math.ceil(groups / p.stage_groups))
    gs = math.ceil(math.ceil(groups / split) / p.stage_groups) \
        * p.stage_groups
    return math.ceil(groups / gs), gs


def run(seed: int = 0) -> list[dict]:
    from ...sparsity import nm_prune_dense, pack_nm
    device = torch.device("cuda")
    libs = _libraries()
    sms = ops.sm_count(device)
    n, m = 2, 4
    rows = []
    for cell, M, K, N, dtype in CELLS:
        gen = torch.Generator(device=device).manual_seed(seed)
        a = torch.randn((M, K), generator=gen, device=device).to(dtype)
        w = nm_prune_dense(torch.randn((K, N), generator=gen,
                                       device=device), n, m)
        vals, idx = pack_nm(w, n, m)
        vals = vals.to(dtype)
        want = ops.nm_spmm_plain(a, vals, idx, n=n, m=m, bm=M, bk=K, bn=N)
        p = ops.plan(M, K, N, n, m, dtype, sms)
        byte_count = (a.numel() * a.element_size()
                      + vals.numel() * vals.element_size() + idx.numel()
                      + M * N * 4)
        n_sets = max(1, math.ceil(2 * L2_BYTES / (byte_count - M * N * 4)))
        sets = [(a.clone(), vals.clone(), idx.clone(),
                 torch.empty((M, N), device=device)) for _ in range(n_sets)]
        runs = [(name, p.split, p.slice_groups) for name in libs]
        runs += [("base", *_slices(p, K // m, aim)) for aim in SPLITS]
        for name, split, gs in runs:
            def launch(a_, v_, i_, o_, fn=libs[name].lib().nm_spmm):
                err = fn(a_.data_ptr(), v_.data_ptr(), i_.data_ptr(),
                         o_.data_ptr(), M, K, N, n, m, 0,
                         int(dtype == torch.bfloat16), ops.KERNELS[p.kernel],
                         split, gs, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            launch(*sets[0])
            torch.cuda.synchronize()
            rel = float((sets[0][3] - want).abs().max() / want.abs().max())
            if name == "base" and not rel <= 1e-5:
                raise AssertionError(f"{cell}: the unchanged kernel is "
                                     f"off by {rel} of the largest output")
            rows.append({"cell": cell, "variant": name, "kernel": p.kernel,
                         "split": split, "plan_split": p.split,
                         "ms": _time_ms(launch, sets),
                         "bound_ms": byte_count / HBM_BYTES_PER_S * 1e3,
                         "rel_err": rel, **_variant_info(
                             libs[name], p.kernel, dtype, n, m)})
            print(f"[study] {json.dumps(rows[-1])}")
        del sets
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"study": run()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
