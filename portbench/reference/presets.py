"""Design presets: representative accelerators described with the SAF
taxonomy (paper Table 3) plus the TPU-v5e hierarchy used by the framework's
sparsity advisor.

Energy numbers are Accelergy-style 45nm-class per-action costs (pJ/16-bit
word), consistent with the Eyeriss/Timeloop energy tables: DRAM ~200,
global SRAM ~6, small SRAM/SPad ~1.2, RF ~0.6, MAC ~1.0.
"""
from __future__ import annotations

from .arch import Architecture, ComputeLevel, StorageLevel
from .engine import Design
from .taxonomy import ActionSAF, RankFormat, SAFKind, SAFSpec, TensorFormat

INF = float("inf")


# ----------------------------------------------------------------------
# Generic 2-level architecture used by Fig. 1 / Fig. 17 style studies:
# DRAM -> Buffer -> (spatial) compute
# ----------------------------------------------------------------------
def two_level_arch(name: str = "edge", buffer_kwords: float = 64,
                   pes: int = 256, dram_bw: float = 32,
                   buffer_bw: float = 256) -> Architecture:
    return Architecture(
        name=name,
        levels=(
            StorageLevel("DRAM", INF, dram_bw, 200.0, 200.0, 0.0),
            StorageLevel("Buffer", buffer_kwords * 1024, buffer_bw, 6.0,
                         6.0, 0.05),
        ),
        compute=ComputeLevel("MAC", instances=pes, mac_energy_pj=1.0,
                             gated_energy_pj=0.05),
    )


def three_level_arch(name: str = "eyeriss-like", glb_kwords: float = 96,
                     spad_words: int = 512, pes: int = 168) -> Architecture:
    return Architecture(
        name=name,
        levels=(
            StorageLevel("DRAM", INF, 16, 200.0, 200.0, 0.0),
            StorageLevel("GLB", glb_kwords * 1024, 128, 6.0, 6.0, 0.05),
            StorageLevel("SPad", spad_words, 2 * pes, 1.2, 1.2, 0.02),
        ),
        compute=ComputeLevel("MAC", instances=pes, mac_energy_pj=1.0,
                             gated_energy_pj=0.05),
    )


# ----------------------------------------------------------------------
# Representative designs of Table 3 (matmul tensor naming: A, B -> Z)
# ----------------------------------------------------------------------
def dense_design(arch: Architecture | None = None) -> Design:
    """No SAFs: the dense baseline every comparison normalizes to."""
    return Design(arch=arch or two_level_arch("dense"), safs=SAFSpec(),
                  name="dense")


def bitmask_design(arch: Architecture | None = None) -> Design:
    """Fig. 1 'Bitmask (Eyeriss-like)': B format + gating — saves energy,
    not time."""
    arch = arch or two_level_arch("bitmask")
    fmts = {}
    for lvl in ("DRAM", "Buffer"):
        fmts[(lvl, "A")] = TensorFormat.of(RankFormat.B, RankFormat.B)
        fmts[(lvl, "B")] = TensorFormat.of(RankFormat.B, RankFormat.B)
    safs = SAFSpec(
        formats=fmts,
        actions=(
            ActionSAF(SAFKind.GATE, "Buffer", "B", ("A",)),
            ActionSAF(SAFKind.GATE, "compute", "Z", ("A", "B")),
        ))
    return Design(arch=arch, safs=safs, name="bitmask")


def coordinate_list_design(arch: Architecture | None = None) -> Design:
    """Fig. 1 'Coordinate list (SCNN-like)': CP format + skipping — saves
    energy AND time, but pays multi-bit coordinate metadata per nonzero."""
    arch = arch or two_level_arch("coordlist")
    fmts = {}
    for lvl in ("DRAM", "Buffer"):
        fmts[(lvl, "A")] = TensorFormat.of(RankFormat.CP, RankFormat.CP,
                                           coord_bits=16)
        fmts[(lvl, "B")] = TensorFormat.of(RankFormat.CP, RankFormat.CP,
                                           coord_bits=16)
    safs = SAFSpec(
        formats=fmts,
        actions=(
            ActionSAF(SAFKind.SKIP, "Buffer", "B", ("A",)),
            ActionSAF(SAFKind.SKIP, "Buffer", "Z", ("A", "B")),
            ActionSAF(SAFKind.GATE, "compute", "Z", ("A", "B")),
        ))
    return Design(arch=arch, safs=safs, name="coordlist")


def eyeriss_like(arch: Architecture | None = None) -> Design:
    """Eyeriss (Table 3): offchip RLE for I/O, on-chip UB gating; gating
    only — no speedup, energy savings from gated storage/compute."""
    arch = arch or three_level_arch("eyeriss")
    safs = SAFSpec(
        formats={
            ("DRAM", "A"): TensorFormat.of(RankFormat.B, RankFormat.RLE,
                                           coord_bits=5),
            ("DRAM", "Z"): TensorFormat.of(RankFormat.B, RankFormat.RLE,
                                           coord_bits=5),
            ("GLB", "A"): TensorFormat.of(RankFormat.UB),
        },
        actions=(
            ActionSAF(SAFKind.GATE, "SPad", "B", ("A",)),
            ActionSAF(SAFKind.GATE, "compute", "Z", ("A",)),
        ))
    return Design(arch=arch, safs=safs, name="eyeriss-like")


def eyeriss_v2_like(arch: Architecture | None = None) -> Design:
    """Eyeriss V2 PE (Table 3): I/W in B-UOP-CP (CSC-like), skipping at the
    innermost storage, Gate Compute."""
    arch = arch or three_level_arch("eyerissv2")
    fmt = TensorFormat.of(RankFormat.UOP, RankFormat.CP, coord_bits=4)
    safs = SAFSpec(
        formats={
            ("GLB", "A"): fmt, ("GLB", "B"): fmt,
            ("SPad", "A"): fmt, ("SPad", "B"): fmt,
        },
        actions=(
            ActionSAF(SAFKind.SKIP, "SPad", "B", ("A",)),
            ActionSAF(SAFKind.SKIP, "SPad", "Z", ("A", "B")),
            ActionSAF(SAFKind.GATE, "compute", "Z", ("A", "B")),
        ))
    return Design(arch=arch, safs=safs, name="eyerissv2-like")


def scnn_like(arch: Architecture | None = None) -> Design:
    """SCNN (Table 3): I/W in B-UOP-RLE, skip W<-I and O<-I&W at innermost
    storage, Gate Compute."""
    arch = arch or three_level_arch("scnn")
    fmt = TensorFormat.of(RankFormat.UOP, RankFormat.RLE, coord_bits=4)
    safs = SAFSpec(
        formats={
            ("GLB", "A"): fmt, ("GLB", "B"): fmt,
            ("SPad", "A"): fmt, ("SPad", "B"): fmt,
        },
        actions=(
            ActionSAF(SAFKind.SKIP, "SPad", "B", ("A",)),
            ActionSAF(SAFKind.SKIP, "SPad", "Z", ("A", "B")),
            ActionSAF(SAFKind.GATE, "compute", "Z", ("A", "B")),
        ))
    return Design(arch=arch, safs=safs, name="scnn-like")


def extensor_like(arch: Architecture | None = None) -> Design:
    """ExTensor (Table 3): hierarchical elimination — double-sided skipping
    at ALL storage levels long before data reaches compute."""
    arch = arch or three_level_arch("extensor")
    fmt = TensorFormat.classic("CSR", coord_bits=16)
    safs = SAFSpec(
        formats={(lvl, t): fmt for lvl in ("DRAM", "GLB", "SPad")
                 for t in ("A", "B")},
        actions=(
            ActionSAF(SAFKind.SKIP, "DRAM", "B", ("A",), double_sided=True),
            ActionSAF(SAFKind.SKIP, "GLB", "B", ("A",), double_sided=True),
            ActionSAF(SAFKind.SKIP, "SPad", "B", ("A",), double_sided=True),
            ActionSAF(SAFKind.SKIP, "SPad", "Z", ("A", "B")),
        ))
    return Design(arch=arch, safs=safs, name="extensor-like")


# ----------------------------------------------------------------------
# Tensor-core family (Sec. 7.1): SMEM -> RF -> compute hierarchy
# ----------------------------------------------------------------------
def tc_arch(name: str, smem_bw: float = 64.0) -> Architecture:
    """SMEM-RF-Compute hierarchy of Fig. 14.  smem_bw is the provisioned
    share of SMEM bandwidth (words/cycle) — the case study's bottleneck."""
    return Architecture(
        name=name,
        levels=(
            StorageLevel("SMEM", 48 * 1024, smem_bw, 8.0, 8.0, 0.05),
            StorageLevel("RF", 2048, 512.0, 0.6, 0.6, 0.01),
        ),
        compute=ComputeLevel("TC-MAC", instances=256, mac_energy_pj=1.0,
                             gated_energy_pj=0.05),
    )


def stc_like(n: int = 2, m: int = 4, fmt_kind: str = "CP",
             compress_b: bool = False, smem_bw: float = 64.0) -> Design:
    """NVIDIA STC (Sec. 6.3.5/7.1): weights (A) compressed with offset-based
    CP, N:M structured; skipping on weights only.  Variants:

      fmt_kind='RLE'     -> STC-flexible-rle
      compress_b=True    -> STC-flexible-rle-dualCompress (B in bitmask,
                            compression only — no B-based skipping, to keep
                            the compute in sync, Sec. 7.1.4)
    """
    arch = tc_arch(f"stc-{n}:{m}", smem_bw=smem_bw)
    coord_bits = max(1, (m - 1).bit_length())
    rf = RankFormat.CP if fmt_kind == "CP" else RankFormat.RLE
    fmts = {
        ("SMEM", "A"): TensorFormat.of(rf, coord_bits=coord_bits),
        ("RF", "A"): TensorFormat.of(rf, coord_bits=coord_bits),
    }
    if compress_b:
        fmts[("SMEM", "B")] = TensorFormat.of(RankFormat.B)
    safs = SAFSpec(
        formats=fmts,
        actions=(
            # skipping follows the weight metadata: inputs for zero weights
            # are never fetched into the RF / compute
            ActionSAF(SAFKind.SKIP, "RF", "B", ("A",)),
            ActionSAF(SAFKind.SKIP, "RF", "Z", ("A",)),
        ))
    return Design(arch=arch, safs=safs,
                  name=f"stc-{n}:{m}-{fmt_kind}"
                       + ("-dualCompress" if compress_b else ""))


def dstc_like(smem_bw: float = 64.0) -> Design:
    """DSTC (Table 3): two-level bitmap on both operands, double-sided
    skipping at the 2nd-to-innermost and innermost levels."""
    arch = tc_arch("dstc", smem_bw=smem_bw)
    bb = TensorFormat.of(RankFormat.B, RankFormat.B)
    safs = SAFSpec(
        formats={(lvl, t): bb for lvl in ("SMEM", "RF")
                 for t in ("A", "B")},
        actions=(
            ActionSAF(SAFKind.SKIP, "SMEM", "B", ("A",), double_sided=True),
            ActionSAF(SAFKind.SKIP, "RF", "B", ("A",), double_sided=True),
            ActionSAF(SAFKind.SKIP, "RF", "Z", ("A", "B")),
        ))
    return Design(arch=arch, safs=safs, name="dstc-like")


# ----------------------------------------------------------------------
# TPU v5e (the framework's target hardware): HBM -> VMEM -> MXU.
# Used by repro_torch.core.advisor to pick sparsity configs for the LM archs.
# ----------------------------------------------------------------------
def tpu_v5e_arch() -> Architecture:
    """Per-chip numbers: 197 TFLOP/s bf16, 819 GB/s HBM, ~128 MB VMEM-class
    on-chip storage (modeled at cycle granularity of the 940 MHz clock).
    Words are bf16.  The REG level models the MXU's in-array accumulators:
    partial sums live there, so VMEM sees tile traffic, not per-MAC
    traffic (matching the systolic dataflow).  MXU cannot skip individual
    lanes — sparse wins on TPU come from *traffic* (format compression),
    which is exactly what this model expresses (DESIGN.md 'hardware
    adaptation')."""
    clock_hz = 0.94e9
    hbm_words_per_cycle = 819e9 / 2 / clock_hz      # ~436 words/cycle
    vmem_words_per_cycle = 8192.0                   # on-chip fabric
    macs = 197e12 / 2 / clock_hz                    # ~104k MAC/cycle
    return Architecture(
        name="tpu-v5e",
        levels=(
            StorageLevel("HBM", 16e9 / 2, hbm_words_per_cycle, 80.0, 80.0,
                         0.0),
            StorageLevel("VMEM", 64e6, vmem_words_per_cycle, 1.5, 1.5, 0.02),
            # high per-instance bandwidth: the systolic adder tree reduces
            # k-spatial partials in flight before the accumulator write
            StorageLevel("REG", 8192, 64.0, 0.05, 0.05, 0.005),
        ),
        compute=ComputeLevel("MXU", instances=int(macs), mac_energy_pj=0.4,
                             gated_energy_pj=0.02),
    )


def tpu_nm_design(n: int = 2, m: int = 4) -> Design:
    """N:M weight sparsity on TPU: CP-compressed weights in HBM/VMEM,
    decompress-then-dense-MXU (no compute skipping — gating only at the
    traffic level).  Matches kernels/nm_spmm."""
    coord_bits = max(1, (m - 1).bit_length())
    fmts = {
        ("HBM", "A"): TensorFormat.of(RankFormat.CP, coord_bits=coord_bits),
        ("VMEM", "A"): TensorFormat.of(RankFormat.CP, coord_bits=coord_bits),
    }
    return Design(arch=tpu_v5e_arch(),
                  safs=SAFSpec(formats=fmts, actions=()),
                  name=f"tpu-nm-{n}:{m}")
