"""Three-term roofline from the dry run's per-rank counts (the JAX
package's ``launch/roofline.py``), for an NVIDIA H100 SXM:

    compute    = dot FLOPs per rank      / peak FLOP/s (bf16 dense)
    memory     = dot bytes per rank      / HBM bytes/s
    collective = collective bytes / rank / link bytes/s

The counts are ``costanalysis``'s, as ``dryrun.py`` records them in
``results/dryrun_torch/``; ``dot_bytes`` (operands + results of every
matmul) is the HBM proxy, as in the reference.  MODEL_FLOPS = 6·N·D for
training (2·N·D prefill, 2·N per token decode), with N_active for MoE;
the ratio MODEL_FLOPS / counted FLOPs exposes remat and replicated work
(< 1: recompute, attention, or work a rank repeats because a dimension
does not split).

The peak rates are inputs (``--peak-flops``, ``--hbm-bw``,
``--link-bw``).  Their defaults are the H100 SXM datasheet's, not
measurements: 989e12 FLOP/s bf16 dense on the tensor cores (67e12 f32
without them), 3.35e12 B/s HBM3, and 50e9 B/s per GPU for collectives —
the 400 Gb/s network link of each GPU, which both axes of a 16 x 16
mesh cross, since an 8-GPU NVLink domain holds neither.  The reference's
TPU figures (197 TFLOP/s, 819 GB/s, 50 GB/s ICI) do not carry over.
The chip smoke test reads the same constants for its kernel bounds.

  PYTHONPATH=src python -m repro_torch.launch.roofline            # table
  PYTHONPATH=src python -m repro_torch.launch.roofline --json out.json
"""
from __future__ import annotations

import argparse
import json
import pathlib

from ..configs import ARCH_NAMES, get_config
from .steps import SHAPES

#: H100 SXM datasheet: dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS = 989e12
#: H100 SXM datasheet: f32 on the FMA pipes (no tensor cores), FLOP/s
PEAK_FLOPS_F32 = 67e12
#: H100 SXM datasheet: HBM3, bytes/s
HBM_BW = 3.35e12
#: one GPU's 400 Gb/s network link, bytes/s
LINK_BW = 50e9
CHIPS = 256                  # single-pod roofline (16 x 16)

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results"
DRYRUN = RESULTS / "dryrun_torch"


def active_params(cfg) -> int:
    """Parameters touched per token (MoE: shared + top_k experts)."""
    total = cfg.param_count()
    if not cfg.moe:
        return total
    m = cfg.moe
    routed = cfg.num_layers // m.every * m.num_experts * 3 * \
        cfg.d_model * m.expert_d_ff
    active_routed = routed * m.top_k / m.num_experts
    return int(total - routed + active_routed)


def model_flops_per_chip(cfg, shape, chips: int = CHIPS) -> float:
    n_active = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n_active * shape.batch * shape.seq / chips
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.batch * shape.seq / chips
    # decode: one token per sequence
    return 2.0 * n_active * shape.batch / chips


def cell_roofline(rec: dict, peak_flops: float = PEAK_FLOPS,
                  hbm_bw: float = HBM_BW,
                  link_bw: float = LINK_BW) -> dict | None:
    """The three terms of one ``ok`` record, its dominant term and the
    step's lower bound (the largest term); None for other records.
    MODEL_FLOPS is divided over the record's ranks."""
    if rec.get("status") != "ok":
        return None
    cfg = get_config(rec["arch"])
    shape = SHAPES[rec["shape"]]
    flops = rec.get("dot_flops") or rec.get("flops") or 0.0
    dbytes = rec.get("dot_bytes") or 0.0
    coll = rec.get("collectives", {})
    cbytes = sum(v for k, v in coll.items() if k != "count")

    t_comp = flops / peak_flops
    t_mem = dbytes / hbm_bw
    t_coll = cbytes / link_bw
    dom = max((t_comp, "compute"), (t_mem, "memory"),
              (t_coll, "collective"))[1]
    total = max(t_comp, t_mem, t_coll)
    mf = model_flops_per_chip(cfg, shape, rec.get("ranks", CHIPS))
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "dominant": dom,
        "model_flops": mf,
        "hlo_flops": flops,
        "useful_ratio": mf / flops if flops else 0.0,
        "roofline_fraction": (mf / peak_flops) / total if total else 0.0,
        "step_lower_bound_s": total,
    }


_ADVICE = {
    "compute": ("compute-bound: reduce recompute (remat policy) and the "
                "work replicated across the model axis; bf16 on the "
                "tensor cores is the roof"),
    "memory": ("HBM-bound: fuse the ops around the matmuls, keep weights "
               "compressed (N:M through K3), raise the per-GPU batch for "
               "arithmetic intensity"),
    "collective": ("network-bound: lower the TP degree or keep it inside "
                   "the 8-GPU NVLink domain, shard the batch over the "
                   "model axis, overlap collectives with compute, "
                   "int8-compress the data-parallel all-reduce"),
}


def build_table(mesh: str = "single", results=DRYRUN, **peaks) -> list[dict]:
    rows = []
    for arch in ARCH_NAMES:
        for shape in SHAPES:
            p = pathlib.Path(results) / f"{arch}__{shape}__{mesh}.json"
            if not p.exists():
                continue
            rec = json.loads(p.read_text())
            if rec["status"] == "skipped":
                rows.append({"arch": arch, "shape": shape,
                             "skipped": rec["reason"]})
                continue
            if rec["status"] == "error":
                rows.append({"arch": arch, "shape": shape,
                             "error": rec.get("where", "")})
                continue
            r = cell_roofline(rec, **peaks)
            r["advice"] = _ADVICE[r["dominant"]]
            rows.append(r)
    return rows


def fmt_table(rows: list[dict]) -> str:
    out = [f"{'arch':>24} {'shape':>12} {'compute':>10} {'memory':>10} "
           f"{'collective':>10} {'dominant':>10} {'useful':>7} "
           f"{'roofline%':>9}"]
    for r in rows:
        if "skipped" in r:
            out.append(f"{r['arch']:>24} {r['shape']:>12} "
                       f"{'- skipped: sub-quadratic-only shape -':^50}")
            continue
        if "error" in r:
            out.append(f"{r['arch']:>24} {r['shape']:>12} "
                       f"  error at {r['error']}")
            continue
        out.append(
            f"{r['arch']:>24} {r['shape']:>12} {r['compute_s']:10.4f} "
            f"{r['memory_s']:10.4f} {r['collective_s']:10.4f} "
            f"{r['dominant']:>10} {r['useful_ratio']:7.2f} "
            f"{100 * r['roofline_fraction']:8.1f}%")
    return "\n".join(out)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json", default="")
    ap.add_argument("--results", default=str(DRYRUN))
    ap.add_argument("--peak-flops", type=float, default=PEAK_FLOPS)
    ap.add_argument("--hbm-bw", type=float, default=HBM_BW)
    ap.add_argument("--link-bw", type=float, default=LINK_BW)
    args = ap.parse_args(argv)
    rows = build_table(args.mesh, args.results, peak_flops=args.peak_flops,
                       hbm_bw=args.hbm_bw, link_bw=args.link_bw)
    print(fmt_table(rows))
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(rows, indent=1))
    ok = [r for r in rows if "compute_s" in r]
    if ok:
        worst = min(ok, key=lambda r: r["roofline_fraction"])
        collb = max(ok, key=lambda r: r["collective_s"]
                    / max(1e-12, r["step_lower_bound_s"]))
        print(f"\nworst roofline fraction: {worst['arch']} x "
              f"{worst['shape']} ({100*worst['roofline_fraction']:.1f}%)")
        print(f"most collective-bound:   {collb['arch']} x "
              f"{collb['shape']} "
              f"(coll {collb['collective_s']:.3f}s of "
              f"{collb['step_lower_bound_s']:.3f}s)")
    return rows


if __name__ == "__main__":
    main()
