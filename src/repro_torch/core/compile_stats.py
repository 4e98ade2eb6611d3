"""Compile-count accounting for the batched PyTorch engine.

The counters keep the meaning they have in the JAX package, where a
compile was an XLA compilation measured in seconds.  A *program* is one
entry of ``core.batched``'s program cache: a traced evaluator keyed by
arch topology, SAF placement, workload structure, density caps and
template or bucket.  A *compile* is recorded the first time a program
sees a given (device, input shape) pair; in eager PyTorch that call pays
device context and allocator warm-up instead of XLA, and its seconds go
to ``compile_seconds``.  Sweeps therefore keep their *compile budget*
("this sweep built N programs") as a checkable property.  Scalar
fallback evaluations are counted too, so "zero scalar-path evaluations"
is assertable.

Usage::

    from repro_torch.core import compile_stats
    with compile_stats.track() as stats:
        run_search(...)
    assert stats.compiles <= bound and stats.scalar_evals == 0
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading


@dataclasses.dataclass
class CompileStats:
    """Counters over one tracking window (or the process lifetime)."""

    #: traced programs constructed (shared across model facades whose
    #: workload *structure* matches — see core.batched._PROGRAM_CACHE)
    programs: int = 0
    #: XLA compilations: first evaluation of a (program, shape) pair
    compiles: int = 0
    #: content-cache hits in get_batched_model / get_bucketed_model
    cache_hits: int = 0
    #: times an existing traced program was rebound to a new facade —
    #: i.e. a different (workload, params) evaluated through a shared
    #: program instead of compiling its own
    program_shares: int = 0
    #: candidates evaluated through a compiled (vmap+jit) program
    batched_evals: int = 0
    #: the subset of batched_evals that went through a *shared* program
    #: (one whose facade did not itself create the traced program); the
    #: rest ran program-specialized.  Multi-layer sweeps want this to be
    #: (layers - 1) / layers of the total.
    shared_evals: int = 0
    #: candidates evaluated through the scalar fallback path
    scalar_evals: int = 0
    #: evaluations AVOIDED by shape deduplication: a sweep that collapses
    #: structurally-identical layer workloads (all N identical transformer
    #: blocks of a config) evaluates the unique shape once and fans the
    #: result back out; each fanned-out duplicate counts here
    dedup_evals: int = 0
    #: wall-clock seconds spent inside evaluations that triggered an XLA
    #: compile (first (program, shape) sightings) — attributed by
    #: core.batched at the call site, so "3 compiles took 41 s" is a
    #: counter read, not a profiler run
    compile_seconds: float = 0.0
    #: wall-clock seconds spent inside warm (already-compiled) batched
    #: evaluations, host->device->host inclusive
    eval_seconds: float = 0.0
    #: per-kind compile breakdown, e.g. {"template": 3, "bucket": 1}
    compiles_by_kind: dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["compiles_by_kind"] = dict(self.compiles_by_kind)
        return d

    def __sub__(self, other: "CompileStats") -> "CompileStats":
        by_kind = {
            k: v - other.compiles_by_kind.get(k, 0)
            for k, v in self.compiles_by_kind.items()
            if v - other.compiles_by_kind.get(k, 0)
        }
        return CompileStats(
            programs=self.programs - other.programs,
            compiles=self.compiles - other.compiles,
            cache_hits=self.cache_hits - other.cache_hits,
            program_shares=self.program_shares - other.program_shares,
            batched_evals=self.batched_evals - other.batched_evals,
            shared_evals=self.shared_evals - other.shared_evals,
            scalar_evals=self.scalar_evals - other.scalar_evals,
            dedup_evals=self.dedup_evals - other.dedup_evals,
            compile_seconds=self.compile_seconds - other.compile_seconds,
            eval_seconds=self.eval_seconds - other.eval_seconds,
            compiles_by_kind=by_kind)

    def copy(self) -> "CompileStats":
        return CompileStats(**{**dataclasses.asdict(self),
                               "compiles_by_kind":
                               dict(self.compiles_by_kind)})


#: process-lifetime counters (never reset implicitly; see ``reset``)
STATS = CompileStats()

#: bumped by every ``reset()`` so an open ``track()`` block can tell
#: that its "before" snapshot belongs to a discarded history
_EPOCH = 0

#: guards every STATS mutation, snapshot(), and reset()'s epoch bump —
#: concurrent DSE clients (threads sharing the warm program cache)
#: record through the same module globals
_LOCK = threading.Lock()


def record_program(kind: str) -> None:
    with _LOCK:
        STATS.programs += 1
    del kind


def record_compile(kind: str) -> None:
    with _LOCK:
        STATS.compiles += 1
        STATS.compiles_by_kind[kind] = \
            STATS.compiles_by_kind.get(kind, 0) + 1


def record_cache_hit() -> None:
    with _LOCK:
        STATS.cache_hits += 1


def record_program_share(kind: str) -> None:
    """An existing traced program was rebound to a new model facade
    (a different workload's params will flow through it)."""
    with _LOCK:
        STATS.program_shares += 1
    del kind


def record_batched_evals(n: int, shared: bool = False) -> None:
    with _LOCK:
        STATS.batched_evals += int(n)
        if shared:
            STATS.shared_evals += int(n)


def record_scalar_evals(n: int) -> None:
    with _LOCK:
        STATS.scalar_evals += int(n)


def record_dedup_evals(n: int) -> None:
    with _LOCK:
        STATS.dedup_evals += int(n)


def record_compile_seconds(seconds: float) -> None:
    """Wall-clock of an evaluation that triggered an XLA compile."""
    with _LOCK:
        STATS.compile_seconds += float(seconds)


def record_eval_seconds(seconds: float) -> None:
    """Wall-clock of a warm (already-compiled) batched evaluation."""
    with _LOCK:
        STATS.eval_seconds += float(seconds)


def snapshot() -> CompileStats:
    """Point-in-time copy of the process-lifetime counters."""
    with _LOCK:
        return STATS.copy()


def _snapshot_with_epoch() -> tuple[CompileStats, int]:
    """Atomic (copy, epoch) pair: ``track`` must never pair a snapshot
    with an epoch from the other side of a concurrent ``reset()``."""
    with _LOCK:
        return STATS.copy(), _EPOCH


def reset() -> None:
    """Zero the process-lifetime counters.  Note the batched-model content
    caches are NOT cleared: a model compiled before the reset stays warm
    and re-use of it records no new compile — which is exactly the
    "compiles caused by this sweep" semantics the CI gates want.
    (``batched.clear_caches()`` is the complementary hook that cold-
    starts the caches so re-created programs count again.)"""
    global _EPOCH
    fresh = CompileStats()
    with _LOCK:
        STATS.__dict__.update(fresh.__dict__)
        _EPOCH += 1


@contextlib.contextmanager
def track():
    """Context manager yielding a :class:`CompileStats` that, on exit,
    holds the *delta* accumulated inside the block (counters inside the
    block are live — read them after exit for final values).

    The snapshot subtraction is robust to a mid-block ``reset()`` (in
    any ordering with ``batched.clear_caches()``): a reset discards the
    "before" snapshot's history, so the delta becomes everything
    recorded *since the reset* — counters can never double-count or go
    negative because the baseline belonged to a zeroed epoch."""
    before, epoch = _snapshot_with_epoch()
    delta = CompileStats()
    try:
        yield delta
    finally:
        # a mid-block reset() zeroed STATS: the pre-block baseline no
        # longer describes any recorded activity, so the delta is the
        # post-reset lifetime counters themselves
        now, epoch_now = _snapshot_with_epoch()
        after = now if epoch_now != epoch else now - before
        delta.__dict__.update(after.__dict__)
        delta.compiles_by_kind = dict(after.compiles_by_kind)
