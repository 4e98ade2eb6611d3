"""SearchLog: the per-generation trajectory record of one search run.

Benches serialize it to JSON (``BENCH_search_convergence.json``) so
quality-per-budget curves are tracked per-PR, and the reproducibility
contract is stated on it directly: same strategy + same PRNG key =>
byte-identical ``to_json(timing=False)``.  The ``timing=False`` form
strips the wall-clock fields (``GenerationRecord.wall_time_s`` and the
run-level ``timing`` attribution dict) — those measure the machine, not
the search, and legitimately differ between identical runs.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any


@dataclasses.dataclass
class GenerationRecord:
    """Best-so-far metrics after one generation (cumulative)."""

    generation: int
    evaluations: int          # cumulative candidates evaluated
    valid: int                # cumulative valid candidates
    best_fitness: float       # best-so-far of the optimized metric
    best_cycles: float
    best_energy_pj: float
    best_edp: float
    #: wall-clock seconds this generation took (ask + evaluate + tell +
    #: archive maintenance); ``None`` when the generation ran inside a
    #: compiled scan (fused search) where per-generation wall time is
    #: unmeasurable — chunk-level timing lives in ``SearchLog.timing``
    #: instead; 0.0 when loaded from a pre-flight-recorder JSON
    wall_time_s: float | None = 0.0

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "GenerationRecord":
        """Back-compat constructor: unknown keys are ignored and missing
        optional fields take their defaults, so old serialized logs
        (and future ones with extra fields) still load."""
        known = {f.name for f in dataclasses.fields(GenerationRecord)}
        return GenerationRecord(**{k: v for k, v in d.items()
                                   if k in known})


@dataclasses.dataclass
class SearchLog:
    strategy: str
    metric: str
    workload: str = ""
    design: str = ""
    seed: int | None = None
    records: list[GenerationRecord] = dataclasses.field(
        default_factory=list)
    #: run-level wall-clock attribution (wall_s / compile_s / eval_s /
    #: compiles), filled by ``run_search`` from ``compile_stats``
    timing: dict = dataclasses.field(default_factory=dict)

    def append(self, rec: GenerationRecord) -> None:
        self.records.append(rec)

    # ------------------------------------------------------------------
    @property
    def best_fitness(self) -> float:
        return (self.records[-1].best_fitness if self.records
                else float("inf"))

    @property
    def evaluations(self) -> int:
        return self.records[-1].evaluations if self.records else 0

    @property
    def wall_time_s(self) -> float:
        """Sum of the measurable per-generation wall times (fused-scan
        generations carry ``None`` and are skipped — their cost is
        attributed at chunk level in :attr:`timing`)."""
        return sum(r.wall_time_s for r in self.records
                   if r.wall_time_s is not None)

    def trajectory(self, field: str = "best_fitness") -> list[float]:
        """Per-generation series of ``field``.  Only the optimized
        metric is monotone non-increasing by construction
        (``best_fitness``, and the matching ``best_<metric>`` column —
        what the CI search-smoke step asserts); the other metric
        columns describe the best-fitness candidate and may move either
        way."""
        return [getattr(r, field) for r in self.records]

    # ------------------------------------------------------------------
    def to_dict(self, timing: bool = True) -> dict[str, Any]:
        """Serializable form.  ``timing=False`` strips the volatile
        wall-clock fields — the byte-reproducibility contract compares
        that form."""
        records = [dataclasses.asdict(r) for r in self.records]
        if not timing:
            for r in records:
                r.pop("wall_time_s", None)
        d = {
            "strategy": self.strategy,
            "metric": self.metric,
            "workload": self.workload,
            "design": self.design,
            "seed": self.seed,
            "records": records,
        }
        if timing:
            d["timing"] = dict(self.timing)
        return d

    def to_json(self, timing: bool = True, **kw) -> str:
        return json.dumps(self.to_dict(timing=timing),
                          sort_keys=True, **kw)

    @staticmethod
    def from_dict(d: dict[str, Any]) -> "SearchLog":
        return SearchLog(
            strategy=d["strategy"], metric=d["metric"],
            workload=d.get("workload", ""), design=d.get("design", ""),
            seed=d.get("seed"),
            records=[GenerationRecord.from_dict(r)
                     for r in d.get("records", [])],
            timing=dict(d.get("timing", {})))

    @staticmethod
    def from_json(s: str) -> "SearchLog":
        return SearchLog.from_dict(json.loads(s))

    def save(self, path: str) -> None:
        """Atomic write (tmp + ``os.replace``): a reader — or a crash —
        mid-write can never observe a truncated log."""
        path = os.fspath(path)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            f.write(self.to_json(indent=2))
            f.write("\n")
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "SearchLog":
        with open(path) as f:
            return SearchLog.from_json(f.read())
