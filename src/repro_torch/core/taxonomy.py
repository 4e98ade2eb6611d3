"""The SAF taxonomy (Sparseloop Sec. 3): representation format, gating,
skipping — plus the hierarchical per-rank format descriptions of Sec. 3.1.1.

A design point = Architecture x Dataflow(Mapping) x SAFs.  This module is
the *description language*; the quantitative analyzers live in sparse.py.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

# ----------------------------------------------------------------------
# Per-rank representation formats (Sec. 3.1.1, Fig. 2)
# ----------------------------------------------------------------------
class RankFormat(str, enum.Enum):
    U = "U"        # uncompressed values
    UB = "UB"      # uncompressed bitmask-guarded (Eyeriss on-chip zero-gate)
    B = "B"        # bitmask: 1 bit per coordinate
    CP = "CP"      # coordinate-payload: coord bits per nonzero
    RLE = "RLE"    # run-length encoding: run bits per nonzero
    UOP = "UOP"    # uncompressed offset pairs (CSR-style segment pointers)


#: classic composite formats expressed hierarchically (Table 2)
CLASSIC_FORMATS: dict[str, tuple[RankFormat, ...]] = {
    "CSR": (RankFormat.UOP, RankFormat.CP),
    "COO2D": (RankFormat.CP, RankFormat.CP),   # flattened CP^2
    "CSB": (RankFormat.UOP, RankFormat.CP, RankFormat.CP),
    "CSF3": (RankFormat.CP, RankFormat.CP, RankFormat.CP),
    "BITMASK": (RankFormat.B,),
    "RLE": (RankFormat.RLE,),
}


@dataclasses.dataclass(frozen=True)
class TensorFormat:
    """Hierarchical format for one tensor at one storage level.

    ``rank_formats`` are listed top (outermost tensor dim) to bottom.  A
    tensor kept uncompressed is ``TensorFormat.uncompressed()``.
    ``coord_bits``/``run_bits``/``offset_bits`` parameterize metadata width;
    flattened ranks (CP^2 style) are expressed by ``flatten`` groups.
    """

    rank_formats: tuple[RankFormat, ...]
    coord_bits: int = 8
    payload_bits: int = 16
    compressed: bool = True   # False => U with metadata (e.g. UB gating)

    @staticmethod
    def uncompressed() -> "TensorFormat":
        return TensorFormat(rank_formats=(RankFormat.U,), compressed=False)

    @staticmethod
    def of(*fmts: RankFormat | str, coord_bits: int = 8) -> "TensorFormat":
        rf = tuple(RankFormat(f) for f in fmts)
        compressed = any(f not in (RankFormat.U, RankFormat.UB) for f in rf)
        return TensorFormat(rank_formats=rf, coord_bits=coord_bits,
                            compressed=compressed)

    @staticmethod
    def classic(name: str, coord_bits: int = 8) -> "TensorFormat":
        return TensorFormat.of(*CLASSIC_FORMATS[name], coord_bits=coord_bits)

    @property
    def is_uncompressed(self) -> bool:
        return not self.compressed


# ----------------------------------------------------------------------
# Gating / skipping action SAFs (Sec. 3.1.2, 3.1.3)
# ----------------------------------------------------------------------
class SAFKind(str, enum.Enum):
    GATE = "gate"   # stay idle during IneffOp cycles: saves energy only
    SKIP = "skip"   # do not spend the cycles at all: saves energy AND time


@dataclasses.dataclass(frozen=True)
class ActionSAF:
    """`Skip/Gate  follower <- leader(s)`  at one storage level.

    ``double_sided=True`` models `A <-> B`, which per Sec. 5.3.4 is the pair
    of leader-follower intersections (B<-A) + (A<-B) — the analyzer expands
    it that way.
    ``target='compute'`` applies the SAF to the compute units instead.
    """

    kind: SAFKind
    level: str                      # storage level name, or "compute"
    follower: str                   # tensor whose IneffOps are eliminated
    leaders: tuple[str, ...]        # condition tensors (the checked operands)
    double_sided: bool = False

    def describe(self) -> str:
        arrow = "<->" if self.double_sided else "<-"
        lead = "&".join(self.leaders)
        return f"{self.kind.value.title()} {self.follower} {arrow} {lead} @ {self.level}"


@dataclasses.dataclass(frozen=True)
class SAFSpec:
    """All SAFs of one design: per-(level, tensor) formats + action SAFs.

    formats: {(level_name, tensor_name): TensorFormat}; anything absent is
    uncompressed.  ``actions`` lists gating/skipping SAFs anywhere in the
    hierarchy; the Gating/Skipping Analyzer (sparse.py) resolves their
    leader-tile granularity from the mapping (Fig. 10).
    """

    formats: dict[tuple[str, str], TensorFormat] = dataclasses.field(
        default_factory=dict)
    actions: tuple[ActionSAF, ...] = ()

    def format_for(self, level: str, tensor: str) -> TensorFormat:
        return self.formats.get((level, tensor), TensorFormat.uncompressed())

    def expand_double_sided(self) -> tuple[ActionSAF, ...]:
        """B <-> A  ==  (B <- A) + (A <- B)   [Sec. 5.3.4]."""
        out: list[ActionSAF] = []
        for a in self.actions:
            if a.double_sided and len(a.leaders) == 1:
                other = a.leaders[0]
                out.append(dataclasses.replace(
                    a, double_sided=False))
                out.append(dataclasses.replace(
                    a, follower=other, leaders=(a.follower,),
                    double_sided=False))
            else:
                out.append(dataclasses.replace(a, double_sided=False))
        return tuple(out)

    def describe(self) -> str:
        lines = [f"  format[{lvl}][{t}] = {'-'.join(f.value for f in fmt.rank_formats)}"
                 for (lvl, t), fmt in sorted(self.formats.items())]
        lines += [f"  {a.describe()}" for a in self.actions]
        return "\n".join(lines) if lines else "  (no SAFs — dense design)"
