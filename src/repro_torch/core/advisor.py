"""Sparsity advisor helpers: the canonical TPU mapping the advisor and
the kernel-agreement harness evaluate.

Only ``_div_floor`` and ``tpu_mapping`` are ported so far; ``advise``
and ``fleet_report`` need the fleet extraction and sweep, which come
with a later slice of the port.
"""
from __future__ import annotations

import math

from .mapping import LoopNest, nest


def _div_floor(x: int, target: int) -> int:
    """Largest divisor of x that is <= target."""
    best = 1
    for d in range(1, int(math.isqrt(x)) + 1):
        if x % d == 0:
            if d <= target:
                best = max(best, d)
            if x // d <= target:
                best = max(best, x // d)
    return best


def tpu_mapping(M: int, K: int, N: int, *, bm: int = 2048, bn: int = 2048,
                bk: int = 1024, macs: int = 104448) -> LoopNest:
    """Canonical HBM->VMEM->REG/MXU mapping: (bm x bn) output tile spread
    spatially across the MXU, k streamed temporally with in-array (REG)
    accumulation; a k-spatial factor models the systolic depth so small-M
    decode matmuls still fill the array.

    Unit-bound loops are kept deliberately: every (M, K, N) yields the
    same 7-slot loop STRUCTURE, so all shapes fall into one padded-
    template bucket and the whole fleet shares one compiled program per
    design (the property the fleet-compile CI gate pins)."""
    bm = _div_floor(M, bm)
    bn = _div_floor(N, bn)
    bk = _div_floor(K, bk)
    # systolic depth: spend leftover parallelism on k
    ksp = _div_floor(bk, max(1, macs // max(1, bm * bn)))
    bk2 = bk // ksp
    mo, no, ko = M // bm, N // bn, K // bk
    return nest(
        3,
        ("m", mo, 2), ("n", no, 2), ("k", ko, 2),
        ("k", bk2, 1), ("m", bm, 1, "spatial"), ("n", bn, 1, "spatial"),
        ("k", ksp, 0, "spatial"),
    )
