"""Chip smoke test of the PyTorch port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (it exits non-zero, printing no result, without
one) and the CUDA toolkit's ``nvcc``; it imports nothing of JAX or of the
JAX package.  Phases, in order — any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: compile the block-sparse kernels K1 (SKIP) and K2 (GATE), the
   N:M kernel K3 and the flash-attention kernel K4 from
   ``src/repro_torch/kernels/*/csrc`` with nvcc for sm_90a, one nvcc per
   source, started together;
3. kernels: K1 and K2 against their plain PyTorch versions on the
   qwen2-0.5b full-width decode cells (batch 8: ffn_gate_up 8x896x9728
   and lm_head 8x896x151936, 64-wide blocks, density 0.25, seed 0) and
   one bf16 cell at the ffn_down shape (128x4864x896), held to 1e-5 of
   the largest magnitude in both types, each row naming the path,
   kernel and K split that ran (``ops.plan``) and holding a repeat
   launch to the same bits; at the f32 cells K1 is also timed on the
   full block list and the three block agreement arms' ratios printed;
   at lm_head K2 with an all-zero mask must take at least 0.8 of its
   all-ones time (its copies are never under the mask); every K1/K2
   variant's registers, local memory, shared memory, resident blocks
   per SM and spills are printed as ``[build] block_mm variant`` lines;
   K3 against its
   plain version at 2:4 on the same two f32 cells and the bf16 cell,
   with int8 and with bit-packed offsets, each row naming the path,
   kernel and K split that ran (``ops.plan``) and holding a repeat
   launch to the same bits; each with kernel, plain, library
   (torch.matmul) and bound times; every K3 variant's stage, registers,
   local memory, shared memory, resident blocks per SM and spills are
   printed as ``[build] nm_spmm variant`` lines; K4 against its plain
   version
   on the serve prefill cell (B 8, S 512, 14 heads, 2 KV heads, D 64),
   a long prefill (1, 4096, 14, 2, 64), qwen3-4b's heads (1, 2048, 32,
   8, 128), all bf16 and causal, one f32 cell and one non-causal cell,
   with kernel, plain, library (``scaled_dot_product_attention`` on the
   repeated KV heads) and bound times, the serving loop's refill
   prefill (1, 512, 14, 2, 64) and the families phase's prefills
   (llama4-scout (8 and 1, 512, 40, 8, 128), internvl2 (4, 512, 64, 8,
   128), whisper's decoder (8, 128, 8, 8, 64)); each K4 row names the
   variant that ran
   (bf16 tensor cores or f32 FMA), and every K4 variant's registers,
   local memory, shared memory, resident blocks per SM and spills are
   printed;
4. model: the whole mapspace of each of the four ResNet50 layers
   (833,400 candidates) searched on the card through ``mapper.search``;
   each winner re-validated by the scalar oracle, 512 sampled
   candidates per layer held to the scalar oracle, one program shared
   by the four layers;
5. search: Sparseloop's mapspace search on the card (ResNet50 conv2_x,
   the Table-5 densities, ``scnn_like(three_level_arch())``, spatial
   n = 8): enumeration at budgets 512 and 5120 and the four strategies
   (random, hillclimb, annealing, ES) at budget 512, population 32,
   key 0; ES at 512 over seeds 0-19, as a ratio to enumeration at
   5120, held to the JAX package's ratios on the same seeds (two-sample
   KS, 0.01), and every seed's run to enumeration at 512; then one ES per
   ResNet50 layer at population 1024 for 16 generations through the
   ``hillclimb`` CLI (logs in ``chiprun_out/search_<layer>.json``) and
   a traced ES run for the device's idle share; candidates/s, programs,
   the host's share of wall time, and every winner re-validated by the
   scalar oracle;
6. fused: the device-resident fused search (``search/fused.py``: one
   captured CUDA graph per generation, replayed for a chunk) against
   the host loop on ``bench_fused``'s cell (conv2_x, population 32, 48
   generations, chunks of 16, key 0): warm generations/s of both and
   their ratio beside the JAX package's bar (3.0); the fused path must
   be faster, capture one graph, run no scalar evaluation, repeat its
   log on a same-key rerun with no new capture, and its winner is
   re-validated; then fused ES at population 1024 x 16 generations per
   ResNet50 layer beside phase 5's host ES, and the device's idle share
   over one traced warm chunk;
7. hybrid: hybrid ES+SGD against pure fused ES on ``bench_codesign``'s
   provisioning space (12 generations, SGD step 0.5) over seeds 0-19,
   the ratios held to the JAX package's (two-sample KS, 0.01), winners
   re-validated under their own designs; the architecture gradient
   (``evaluate_with_arch_grad``, raw and surrogate) at population 1024
   on the card against the port on the CPU;
8. service: 4 ES islands through one ``EvaluationService`` against the
   same 4 searches run alone on conv2_x: one program and one shape in
   total, winners re-validated, the candidates/s ratio; then fused
   island mode (chunks on the service's thread), and fused islands
   without migration held to direct fused runs of the same seeds;
9. validation: the paper's validation on the port — Fig. 11, 12 and
   13's errors of the model against the copied refsim (host-side model
   outputs), Table 5's CPHC of the batched engine on the card over the
   TEMPLATE3 tilings of the four ResNet50 layers, and its speedup over
   refsim on the same mappings at cube sides 32 and 64;
10. fleet: ``fleet_sweep`` over the 10 architectures at full width on
   the card (production mesh, prefill + decode, crossover grid): 178
   entries, 142 unique shapes, programs within ``compile_bound``, 64
   sampled rows held to the scalar oracle, and the advisor's verdicts
   for qwen2-0.5b;
11. agreement: ``validate_fleet`` with all five arms on qwen2-0.5b at
   full width, decode batch 8 (the ffn_gate_up and lm_head cells): the
   model's skip-time, gate-time and skip-vs-gate predictions against
   K1/K2, the advisor's N:M traffic verdict against the packed bytes,
   and K3's error against the dense product of the pruned weight;
12. serve: the LM serving path, ``ServeLoop`` over qwen2-0.5b at full
   width in bf16 (weights from a seeded generator on the card): batch 8,
   prompt 512, 32 generated tokens, 16 requests (a first wave and 8
   refill prefills), greedy; K4 must launch once per layer and prefill;
   prefill and decode-step times, tokens/s and request latency, then
   the device's idle share over 8 traced decode steps of a second,
   one-wave loop, and the device time of a traced warm first-wave
   prefill of a third;
13. families: every other model family, one model at a time at full
   width in bf16 (random seeded weights), freed before the next:
   deepseek-v2-lite (MoE + MLA, 27 layers), llama4-scout (MoE + GQA, 2
   of 48 layers), xlstm-350m (24 layers) and zamba2-7b (Mamba2 hybrid,
   78 layers) through ``ServeLoop`` (batch 8, prompt 512, 16 generated
   tokens, 12 requests: a first wave and 4 refills; then a second,
   one-wave loop whose warm first-wave prefill is timed); internvl2-76b (2
   of 80 layers) through a prefill of 256 patch embeddings + 256 tokens
   at batch 4 and 16 decode steps; whisper-base (6 + 6 layers) through
   ``encdec_prefill`` at batch 8 over 1024 frames with a decoder prompt
   of 128, then 16 decode steps.  Each: prefill and median decode-step
   ms, tokens/s, peak allocated memory, K4 launched once per decoder
   layer and prefill for llama4, internvl2 and whisper and never for
   the others; deepseek's device idle share over 8 traced decode steps;
   xLSTM's device kernels per sLSTM position;
14. train: LM training through ``launch/train.main`` on qwen2-0.5b as
   published (24 layers, bf16 weights, f32 AdamW moments, random seeded
   weights): 30 steps of batch 8 x seq 512, remat "full"; the loss must
   fall (mean of the last 5 below the first 5's minus 0.1) and K4
   launch twice a layer and step (forward and its recompute; the
   gradient is plain PyTorch); first-step and median warm-step ms,
   tokens/s, peak memory, ``train_mfu``, then one traced warm step (the
   device's idle share, K4's device ms, the backward attention's); then
   the restart contract on the reduced configuration (10 steps with a
   checkpoint every 5, the same command to 16: 6 steps, the last loss
   below the first run's first);
15. dry run: ``launch/dryrun.run_cell`` on qwen2-0.5b x train_4k,
   prefill_32k and decode_32k on the single-pod (16 x 16) mesh,
   train_4k on the multi-pod (2 x 16 x 16) mesh, and
   deepseek-v2-lite-16b x train_4k single-pod, one process per cell
   (CPU only: the fake process group of 256 or 512 ranks, DTensors on
   the meta device, no kernel); each cell's per-rank dot FLOPs and
   bytes, collective GiB by kind, peak bytes, seconds and
   ``roofline.cell_roofline``; qwen2's four cells must be ``ok``;
16. counted step: one warm step of phase 14's cell under
   ``launch/costanalysis.CostMode`` on the card (K4 counted by its
   FLOP formula, 48 launches) and the same step at world size 1 on the
   meta device (attention as plain products); with the attention
   products taken out of both, the counts must be equal; the roofline
   bound of the card's count against the measured warm step;
17. mesh train: the train CLI on a one-rank NCCL (1, 1) ``DeviceMesh``
   (qwen2-0.5b full width, depth 2, f32, batch 2 x 512, 3 steps): the
   losses within 1e-6 of the same steps with no mesh and K4 launched as
   often; then its checkpoint restored with ``shardings=`` onto the
   mesh and one more step;
18. compression: ``runtime.compressed_grad_allreduce`` on a one-rank
   NCCL group over qwen2-0.5b's full gradient tree (one backward of
   phase 14's cell, the leaves in f32): every leaf within 1.01 quanta,
   the mean of 30 draws of one leaf within 0.2 quanta; its ms against a
   plain ``all_reduce`` of the same tree;
19. serve check: the card's prefill logits and KV cache against the
   port's CPU path on the same weights (full width, 2 layers, f32,
   prompt 128, so K4 runs in f32 on the card);
20. families check: each family's prefill logits, caches or states and
   one decode step on the card against the port's CPU path on the same
   weights in f32 (1e-4 of the largest magnitude): depth 2 (zamba2: one
   super-block of 6), full width for deepseek, xlstm, zamba2 and
   whisper, the reduced configurations of llama4 and internvl2;
21. train check: training on the card against the port's CPU path in
   f32 on the same weights and batch: the loss (1e-5 relative), every
   gradient and every parameter after one AdamW step (1e-4 of each
   leaf's largest magnitude); qwen2-0.5b at full width and depth 2, the
   other nine configurations reduced, batch 2, seq 128, K4 asserted
   where a family reaches it;
22. profile: where one warm engine evaluation of a ResNet50 layer's
   mapspace goes on the card.

Phases 4-18 are the main path: before each, every kernel's launch
counter is set to 0, and it is read right after.  The last lines are
the ``kernels`` JSON object, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.launch import roofline as _roofline  # noqa: E402

#: qwen2-0.5b (hidden 896, intermediate 4864, vocab 151936), decode at
#: batch 8: the two largest weight matmuls, as (layer, M, K, N)
QWEN2_CELLS = (("ffn_gate_up", 8, 896, 9728), ("lm_head", 8, 896, 151936))
#: the bf16 case: the ffn_down shape at 128 rows
BF16_CELL = ("ffn_down", 128, 4864, 896)
BS, DENSITY, SEED = 64, 0.25, 0
#: ResNet50 layers as GEMMs (name, M, K, N, density A, density B), the
#: Table-5 densities of the repository's benchmark set
RESNET50_LAYERS = (
    ("conv2_x", 3136, 576, 64, 0.4, 0.55),
    ("conv3_x", 784, 1152, 128, 0.35, 0.5),
    ("conv4_x", 196, 2304, 256, 0.3, 0.45),
    ("conv5_x", 49, 4608, 512, 0.3, 0.4),
)
MAPSPACE_SIZES = {"conv2_x": 282_240, "conv3_x": 291_600,
                  "conv4_x": 204_120, "conv5_x": 55_440}
#: one loop order per level (0 = SPad, 1 = GLB, 2 = DRAM), the same for
#: every layer so the four searches share one bucket and one program
PERMUTATIONS = {0: ("n", "k", "m"), 1: ("m", "n", "k"), 2: ("m", "n", "k")}
SAMPLES = 512
#: the N:M pattern of the K3 cells and of the agreement harness
NM = (2, 4)
#: fleet rows held to the scalar oracle
FLEET_SAMPLES = 64
#: unique fleet shapes in the traced evaluation pass
PROFILE_SHAPES = 24
#: K4 cells: (name, B, S, H, KV, D, dtype, causal)
FLASH_CELLS = (
    ("serve_prefill", 8, 512, 14, 2, 64, torch.bfloat16, True),
    ("long_prefill", 1, 4096, 14, 2, 64, torch.bfloat16, True),
    ("qwen3_4b_heads", 1, 2048, 32, 8, 128, torch.bfloat16, True),
    ("serve_prefill_f32", 2, 512, 14, 2, 64, torch.float32, True),
    ("serve_prefill_noncausal", 8, 512, 14, 2, 64, torch.bfloat16, False),
    # the serving loop's refill prefill: 192 of its 240 K4 launches
    ("serve_refill", 1, 512, 14, 2, 64, torch.bfloat16, True),
    # the families phase's prefills: llama4-scout's first wave and
    # refill, internvl2's 256 patches + 256 tokens, whisper's decoder
    ("llama4_prefill", 8, 512, 40, 8, 128, torch.bfloat16, True),
    ("llama4_refill", 1, 512, 40, 8, 128, torch.bfloat16, True),
    ("internvl2_prefill", 4, 512, 64, 8, 128, torch.bfloat16, True),
    ("whisper_dec_prefill", 8, 128, 8, 8, 64, torch.bfloat16, True),
)
#: the serve phase: qwen2-0.5b at full width
SERVE = dict(arch="qwen2-0.5b", batch=8, prompt_len=512, gen=32,
             requests=16)
#: decode steps traced for the device's idle share
SERVE_TRACE_STEPS = 8
#: the families phase, one model at a time at full width in bf16:
#: (cell, arch, layers (None: full depth), how it is driven, whether its
#: prefill reaches K4 (then once per decoder layer and prefill))
FAMILY_CELLS = (
    ("moe_mla", "deepseek-v2-lite-16b", None, "loop", False),
    ("moe_gqa", "llama4-scout-17b-a16e", 2, "loop", True),
    ("xlstm", "xlstm-350m", None, "loop", False),
    ("hybrid", "zamba2-7b", None, "loop", False),
    ("vlm", "internvl2-76b", 2, "prefix", True),
    ("encdec", "whisper-base", None, "encdec", True),
)
#: ``ServeLoop`` cells: batch, prompt, generated tokens, requests (a
#: first wave of 8 and 4 refills); the vlm's prefill (batch, patch
#: embeddings, tokens, decode steps); whisper's (batch, frames, decoder
#: prompt, decode steps: 1500 frames raise in the reference's sdpa)
FAMILY_LOOP = dict(batch=8, prompt_len=512, gen=16, requests=12)
FAMILY_VLM = dict(batch=4, prefix=256, prompt_len=256, steps=16)
FAMILY_ENCDEC = dict(batch=8, frames=1024, prompt_len=128, steps=16)
#: the cell whose decode steps are traced for the device's idle share
FAMILY_TRACED = "moe_mla"
#: the card-vs-CPU check of every family in f32: (arch, layers, reduced);
#: full width where the f32 weights fit in about 8 GB
FAMILY_CHECKS = (
    ("deepseek-v2-lite-16b", 2, False),
    ("llama4-scout-17b-a16e", None, True),
    ("xlstm-350m", 2, False),
    ("zamba2-7b", 6, False),        # one super-block of 6
    ("internvl2-76b", None, True),
    ("whisper-base", 2, False),     # 2 encoder + 2 decoder layers
)
#: the train phase: qwen2-0.5b as published (bf16 weights, f32 moments),
#: 4,096 tokens a step, remat "full" (the CLI's defaults); then the
#: restart contract on the reduced configuration: ``steps`` with a
#: checkpoint every ``every``, then the same command to ``resume_to``
TRAIN = dict(arch="qwen2-0.5b", batch=8, seq=512, steps=30)
TRAIN_RESTART = dict(batch=4, seq=128, steps=10, every=5, resume_to=16)
#: the card-vs-CPU check of training in f32: (arch, layers (None: the
#: configuration's), reduced); qwen2-0.5b at full width, depth 2
TRAIN_CHECKS = (("qwen2-0.5b", 2, False),) + tuple(
    (arch, None, True) for arch in (
        "command-r-35b", "qwen3-4b", "stablelm-1.6b",
        "llama4-scout-17b-a16e", "deepseek-v2-lite-16b", "xlstm-350m",
        "zamba2-7b", "internvl2-76b", "whisper-base"))
#: its batch and sequence (K4 where a family reaches it: S % 128 == 0)
TRAIN_CHECK_SHAPE = dict(batch=2, seq=128, frames=64)
#: card vs CPU: the loss relative, each gradient and each parameter after
#: one AdamW step relative to its leaf's largest magnitude (the CPU
#: tests' bounds against the JAX package)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
#: max|kernel - plain| / max|plain| for K1-K3 in f32 and bf16 alike (both
#: sides multiply the same inputs in f32 and sum in f32: only the order of
#: the sums differs), and for K4 in f32
F32_TOL = 1e-5
FLASH_BF16_TOL = 3e-2   # atol = rtol of the JAX package's bf16 flash test
#: card vs CPU prefill logits, relative to the largest |logit|: f32 sums
#: taken in another order over 2 layers (the CPU tests' bound)
SERVE_LOGITS_TOL = 1e-4
#: K2 with an all-zero mask against an all-ones mask at lm_head: below
#: this ratio its copies went under the mask and GATE turned into SKIP
GATE_ZERO_MASK_MIN = 0.8
ORACLE_REL = 1e-6       # batched engine vs the scalar oracle
#: the search phase: the Table-5 convergence setup (budget, population,
#: the seeds ES@budget runs over as a ratio to enumeration at 10x
#: budget), then one production ES per ResNet50 layer (population x
#: generations) and a traced ES of a few generations
SEARCH_BUDGET, SEARCH_POP, SEARCH_SEEDS = 512, 32, tuple(range(20))
#: the JAX package's ES@512 / enumeration@5120 on that cell at seeds
#: 0-19 (jax 0.9 on the CPU; ``python tests/torch_reference.py 20``
#: prints them), and the level of the two-sample Kolmogorov-Smirnov
#: test the card's ratios are held to them by (the CPU tests'
#: ``tests/test_torch_convergence.py`` bar)
REFERENCE_ES_RATIOS = (
    0.9870777099913594, 1.0284147544999478, 1.0495958397871856,
    1.0878614063914809, 1.0291879670809267, 0.9846934050229664,
    1.0595477680955212, 1.1160853333396696, 1.0491515581812316,
    1.0000689616909892, 1.020678515866768, 0.9647871585377441,
    0.9974316479020175, 1.0924123034758264, 1.0492529058316926,
    0.9440554490646857, 0.9902196192327241, 1.0491863782735076,
    1.0519384873648145, 0.9361516714304078,
)
SEARCH_KS_ALPHA = 0.01
ES_POP, ES_GENS, SEARCH_TRACE_GENS = 1024, 16, 4
#: the fused phase: ``bench_fused``'s cell (population, generations,
#: generations per chunk) and the JAX package's own bar on the fused
#: path's warm generations/s over the host loop's (printed beside the
#: measured ratio; the run asserts only that the fused path is faster)
FUSED_POP, FUSED_GENS, FUSED_CHUNK = 32, 48, 16
#: generations per chunk of the fused production cell (ES_POP x
#: ES_GENS): four chunks, so three of them are warm
ES_FUSED_CHUNK = 4
FUSED_SPEEDUP_BOUND = 3.0
#: the hybrid phase: generations and SGD step of ``bench_fused``'s
#: hybrid cell, and the JAX package's hybrid ES+SGD / pure ES ratios on
#: it at seeds 0-19 (jax 0.9 on the CPU; ``PYTHONPATH=src python
#: tests/torch_reference.py 20 hybrid`` prints them; checked against the
#: reference by ``tests/test_torch_fused.py``)
HYBRID_GENS, HYBRID_LR = 12, 0.5
REFERENCE_HYBRID_RATIOS = (
    1.0278883648380024, 0.9883640005842013, 0.9997151984700456,
    0.9855406139260938, 0.954518676424974, 0.8265692672130692,
    1.0256820242184628, 0.9774737230852539, 1.0106921331006629,
    0.9872976497995076, 1.0298707190620757, 0.9712236000548153,
    0.9863601061566133, 0.8820022251399748, 1.0489624248527323,
    1.0787431881288023, 1.0472783909996866, 0.9500610041489518,
    0.9503282279204809, 0.9716804364434181,
)
#: the arch gradient on the card against the port on the CPU: the
#: batched parity bound.  Exactness is out of reach: float64 lgamma and
#: exp differ by an ulp between the card and the CPU, and the forward
#: EDP moves with them (both are printed)
HYBRID_GRAD_REL = ORACLE_REL
#: the service phase: islands, generations, migration interval
ISLANDS, ISLAND_GENS, ISLAND_MIGRATE = 4, 16, 4
#: the validation phase: refsim against the engine at these cube sides,
#: on this many of each side's Table-5 tilings
REFSIM_SIDES, REFSIM_SAMPLES = (32, 64), 8
#: the H100 SXM datasheet's rates, from the one place the port keeps
#: them (``launch/roofline.py``)
HBM_BYTES_PER_S = _roofline.HBM_BW
PEAK_OPS = {torch.float32: _roofline.PEAK_FLOPS_F32,
            torch.bfloat16: _roofline.PEAK_FLOPS}
L2_BYTES = 50 * 2 ** 20


def _root() -> Path:
    return Path(__file__).resolve().parent


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, sets, graph: bool, reps: int = 5) -> float:
    """Milliseconds per call: min over ``reps`` windows of back-to-back
    calls timed with CUDA events, after a warm-up.  The calls cycle over
    ``sets`` (argument tuples, at least ten calls) so that a working set
    smaller than the L2 cache is read cold, as a caller would find it.
    With ``graph`` the calls are captured once in a CUDA graph and each
    window is one replay: the device time, without the host's per-call
    work.  Without it (the plain versions, which copy host data on every
    call and cannot be captured) the calls are launched eagerly."""
    from repro_torch.fleet.validate import cuda_graph
    inner = max(10, len(sets))
    calls = iter(range(10 ** 9))

    def one():
        return fn(*sets[next(calls) % len(sets)])

    for _ in sets:
        one()
    run = cuda_graph(one, inner).replay if graph else \
        (lambda: [one() for _ in range(inner)])
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def bound_ms(byte_count: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = byte_count / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
def _libraries():
    from repro_torch.kernels.block_mm.ops import LIBRARY as block_mm
    from repro_torch.kernels.flash_attention.ops import LIBRARY as flash
    from repro_torch.kernels.nm_spmm.ops import LIBRARY as nm_spmm
    return (block_mm, nm_spmm, flash)


def phase_build() -> dict:
    """Every kernel source built at once (one nvcc each) and loaded; the
    compiler's reports go to ``chiprun_out/<source>_ptxas.txt``."""
    libs = _libraries()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        lib.lib()
    dt = time.perf_counter() - t0
    out_dir = _root() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for lib, path in zip(libs, paths):
        (out_dir / f"{lib.src.stem}_ptxas.txt").write_text(lib.log)
        regs = [int(w) for line in lib.log.splitlines() if "Used" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt.startswith("registers")]
        spills = sum(1 for line in lib.log.splitlines()
                     if "bytes spill stores" in line
                     and not line.split("bytes spill stores")[0].rstrip()
                     .endswith(" 0"))
        print(f"[build] {lib.src.name} -> {path.name}: {len(regs)} kernels, "
              f"at most {max(regs, default=0)} registers, {spills} with "
              f"spills")
    print(f"[build] all sources in {dt:.2f} s")
    return {"seconds": dt}


def _cell_inputs(M, K, N, dtype, device):
    from repro_torch.fleet.validate import block_cell_inputs
    x = block_cell_inputs(M, K, N, density=DENSITY, bs=BS, seed=SEED,
                          device=device)
    for k in ("a", "w", "wm"):
        x[k] = x[k].to(dtype)
    x["mask_dev"] = torch.as_tensor(x["mask"].astype(np.int32),
                                    device=device)
    return x


def _compare(got, want, dtype, bf16_tol=None) -> tuple[float, float, bool]:
    """Max abs error, max error relative to the largest |want|, and
    whether it holds: relative F32_TOL, or for bf16 with ``bf16_tol``
    (K4) elementwise ``bf16_tol + bf16_tol * |want|``."""
    err = float((got - want).abs().max())
    rel = err / max(1e-30, float(want.abs().max()))
    if dtype == torch.bfloat16 and bf16_tol is not None:
        ok = bool(((got - want).abs()
                   <= bf16_tol + bf16_tol * want.abs()).all())
    else:
        ok = rel <= F32_TOL
    return err, rel, ok


def phase_kernels(device="cuda", cells=None, timed=True) -> dict:
    """K1 and K2 against their plain versions; returns per-kernel rows
    for every cell checked.  Each row names the path, kernel and K split
    that ran and holds a repeat launch to the same bits; at the f32 cells
    K1 is also timed on the full block list, and the three block
    agreement arms' ratios are printed; at lm_head K2 is timed with an
    all-zero and an all-ones mask."""
    from repro_torch.fleet.validate import GATE_NEUTRAL, WIN_THRESHOLD
    from repro_torch.kernels.block_mm.ops import (H100_SMS, block_list,
                                                  gated_mm, gated_mm_plain,
                                                  plan, skip_mm,
                                                  skip_mm_plain, sm_count)
    cells = cells or ([(n, M, K, N, torch.float32)
                       for n, M, K, N in QWEN2_CELLS]
                      + [(*BF16_CELL, torch.bfloat16)])
    sms = sm_count(device) if device != "cpu" else H100_SMS
    rows = {"skip_mm": [], "gated_mm": []}
    for layer, M, K, N, dtype in cells:
        x = _cell_inputs(M, K, N, dtype, device)
        a, w, wm, mask = x["a"], x["w"], x["wm"], x["mask"]
        ks, js = x["nonzero"]
        blocks = block_list(ks, js, mask.shape, device)
        full = block_list(*x["full"], mask.shape, device)
        elt = a.element_size()
        nnzb, nblocks = int(mask.sum()), mask.size
        kw = dict(bm=BS, bk=BS, bn=BS)
        bm = min(BS, M)
        # K1 on the masked W, K2 on the unmasked W (the mask must be
        # honoured by the kernel, not by zeros in W)
        # per kernel: the W bytes it must read, its block-list or mask
        # bytes, the blocks it multiplies and the run the plan sees
        checks = {
            "skip_mm": (lambda a_, w_: skip_mm(a_, w_, blocks, **kw),
                        lambda a_, w_: skip_mm_plain(a_, w_, ks, js, **kw),
                        wm, len(ks) * BS * BS * elt,
                        (len(ks) + N // BS + 1) * 4, len(ks),
                        blocks.max_run),
            "gated_mm": (lambda a_, w_: gated_mm(a_, w_, x["mask_dev"],
                                                 **kw),
                         lambda a_, w_: gated_mm_plain(a_, w_,
                                                       x["mask_dev"], **kw),
                         w, K * N * elt, nblocks * 4, nnzb, None),
        }
        for name, (kern, plain, w_in, w_bytes, index_bytes,
                   blocks_done, run) in checks.items():
            got, want = kern(a, w_in), plain(a, w_in)
            again = kern(a, w_in)
            if device != "cpu":
                torch.cuda.synchronize()
            err, rel, ok = _compare(got, want, dtype)
            # the path, K split and grid that ran (ops.plan)
            p = plan(M, K, N, bm, BS, BS, dtype, sms, run)
            row = {"cell": layer, "shape": [M, K, N],
                   "dtype": str(dtype).replace("torch.", ""),
                   "bm_bk_bn": [bm, BS, BS], "nnzb": nnzb,
                   "blocks": nblocks, "path": p.path, "kernel": p.kernel,
                   "split": p.split, "slice_blocks": p.slice_blocks,
                   "tile": list(p.tile), "grid": list(p.grid),
                   "waves": p.waves(sms), "max_abs_err": err,
                   "rel_err": rel,
                   "repeat_bit_identical": bool(torch.equal(got, again))}
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version on {layer}: {row}")
            if not row["repeat_bit_identical"]:
                raise AssertionError(f"{name} gave other bits on a repeat "
                                     f"launch on {layer}: {row}")
            if timed:
                byte_count = M * K * elt + w_bytes + M * N * 4 + index_bytes
                ops = 2.0 * M * BS * BS * blocks_done
                b_ms, b_by = bound_ms(byte_count, ops, dtype)
                # cycle over enough input copies to exceed the L2 cache
                per_set = (M * K + K * N) * elt
                n_sets = max(1, math.ceil(2 * L2_BYTES / per_set))
                sets = [(a.clone(), w_in.clone()) for _ in range(n_sets)]
                row.update(ms=time_ms(kern, sets, graph=True),
                           plain_ms=time_ms(plain, sets, graph=False))
                if name == "skip_mm" and dtype == torch.float32:
                    # the skip-time and gate-time arms' numerator: K1 on
                    # the full block list of the unmasked W
                    full_sets = [(s[0], w.clone()) for s in sets]
                    row["full_list_ms"] = time_ms(
                        lambda a_, w_: skip_mm(a_, w_, full, **kw),
                        full_sets, graph=True)
                    del full_sets
                if name == "gated_mm" and layer == "lm_head":
                    # GATE pays for every block's bytes: with nothing to
                    # multiply it must take about as long as with all
                    zero = torch.zeros_like(x["mask_dev"])
                    ones = torch.ones_like(x["mask_dev"])
                    row["zero_mask_ms"] = time_ms(
                        lambda a_, w_: gated_mm(a_, w_, zero, **kw), sets,
                        graph=True)
                    row["ones_mask_ms"] = time_ms(
                        lambda a_, w_: gated_mm(a_, w_, ones, **kw), sets,
                        graph=True)
                    ratio = row["zero_mask_ms"] / row["ones_mask_ms"]
                    row["zero_over_ones"] = ratio
                    print(f"[kernels] gated_mm {layer} zero mask "
                          f"{row['zero_mask_ms']:.4f} ms, all ones "
                          f"{row['ones_mask_ms']:.4f} ms: {ratio:.3f} "
                          f"(>= {GATE_ZERO_MASK_MIN})")
                    if ratio < GATE_ZERO_MASK_MIN:
                        raise AssertionError(
                            f"gated_mm with an all-zero mask took {ratio:.3f}"
                            f" of its all-ones time on {layer}: its copies "
                            f"went under the mask (GATE became SKIP)")
                # the yardstick: one library call of the same function,
                # the dense product with the masked W
                sets = [(s[0], wm.clone()) for s in sets]
                row.update(library_ms=time_ms(torch.matmul, sets,
                                              graph=True),
                           bound_ms=b_ms, bound_by=b_by, bytes=byte_count,
                           ops=ops, input_sets=n_sets)
                del sets
            rows[name].append(row)
            print(f"[kernels] {name} {layer} {row}")
        if timed and dtype == torch.float32:
            t_full = rows["skip_mm"][-1]["full_list_ms"]
            t_skip = rows["skip_mm"][-1]["ms"]
            t_gate = rows["gated_mm"][-1]["ms"]
            arms = {"skip-time": (t_full / t_skip, f"> {WIN_THRESHOLD}"),
                    "gate-time": (t_full / t_gate, f"<= {GATE_NEUTRAL}"),
                    "skip-vs-gate": (t_gate / t_skip, f"> {WIN_THRESHOLD}")}
            rows["skip_mm"][-1]["arms"] = {k: v for k, (v, _) in arms.items()}
            print(f"[kernels] block arms {layer} (L2 cold): " + ", ".join(
                f"{k} {v:.3f} ({want})" for k, (v, want) in arms.items()))
    return rows


def phase_nm_kernels(device="cuda", cells=None, timed=True) -> list:
    """K3 against its plain version at 2:4, with int8 and with packed
    offsets; returns one row per (cell, offsets layout)."""
    from repro_torch.kernels.nm_spmm.ops import (H100_SMS, nm_spmm,
                                                 nm_spmm_plain, plan,
                                                 sm_count)
    from repro_torch.sparsity import (nm_prune_dense, offsets_bits,
                                      pack_nm, pack_offsets)
    n, m = NM
    cells = cells or ([(c, M, K, N, torch.float32)
                       for c, M, K, N in QWEN2_CELLS]
                      + [(*BF16_CELL, torch.bfloat16)])
    sms = sm_count(device) if device != "cpu" else H100_SMS
    rows = []
    for layer, M, K, N, dtype in cells:
        rng = np.random.default_rng(SEED)
        a = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).to(device)
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(
            np.float32)).to(device)
        w_nm = nm_prune_dense(w, n, m)
        vals, idx = pack_nm(w_nm, n, m)
        a, vals, w_nm = a.to(dtype), vals.to(dtype), w_nm.to(dtype)
        del w
        elt = a.element_size()
        kc = vals.shape[0]
        for packed, offs in ((False, idx), (True, pack_offsets(idx, m))):
            kw = dict(n=n, m=m, bm=BS, bk=BS, bn=BS, packed=packed)

            def kern(a_, v_, o_):
                return nm_spmm(a_, v_, o_, **kw)

            def plain(a_, v_, o_):
                return nm_spmm_plain(a_, v_, o_, **kw)

            got, want = kern(a, vals, offs), plain(a, vals, offs)
            again = kern(a, vals, offs)
            if device != "cpu":
                torch.cuda.synchronize()
            # both sides multiply the same bf16 or f32 inputs in f32 and
            # sum in f32: only the order of the sums differs, so both
            # types are held to F32_TOL of the largest magnitude
            err, rel, ok = _compare(got, want, torch.float32)
            # the path, K split and grid that ran (ops.plan)
            p = plan(M, K, N, n, m, dtype, sms)
            row = {"cell": layer, "shape": [M, K, N],
                   "dtype": str(dtype).replace("torch.", ""),
                   "packed": packed, "offset_bits": offsets_bits(m)
                   if packed else 8, "bm_bk_bn": [min(BS, M), BS, BS],
                   "path": p.path, "kernel": p.kernel, "split": p.split,
                   "slice_groups": p.slice_groups, "grid": list(p.grid),
                   "waves": p.waves(sms),
                   "max_abs_err": err, "rel_err": rel,
                   "repeat_bit_identical": bool(torch.equal(got, again))}
            if not ok:
                raise AssertionError(f"nm_spmm disagrees with its plain "
                                     f"version on {layer}: {row}")
            if not row["repeat_bit_identical"]:
                raise AssertionError(f"nm_spmm gave other bits on a repeat "
                                     f"launch on {layer}: {row}")
            if timed:
                # the bytes the function must move: A, the kept values,
                # the offsets in the layout used, the f32 output
                byte_count = (M * K * elt + vals.numel() * elt
                              + offs.numel() * offs.element_size()
                              + M * N * 4)
                ops = 2.0 * M * kc * N     # the kept multiply-adds only
                b_ms, b_by = bound_ms(byte_count, ops, dtype)
                per_set = byte_count - M * N * 4
                n_sets = max(1, math.ceil(2 * L2_BYTES / per_set))
                sets = [(a.clone(), vals.clone(), offs.clone())
                        for _ in range(n_sets)]
                row.update(ms=time_ms(kern, sets, graph=True),
                           plain_ms=time_ms(plain, sets, graph=False))
                # the yardstick: the dense product with the pruned W
                sets = [(s[0], w_nm.clone()) for s in sets]
                row.update(library_ms=time_ms(torch.matmul, sets,
                                              graph=True),
                           bound_ms=b_ms, bound_by=b_by, bytes=byte_count,
                           ops=ops, input_sets=n_sets)
                del sets
            rows.append(row)
            print(f"[kernels] nm_spmm {layer} {row}")
    return rows


def phase_flash_kernels(device="cuda", cells=FLASH_CELLS, timed=True
                        ) -> list:
    """K4 against its plain version; one row per cell."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain, kernel_info)
    rows = []
    for name, B, S, H, KV, D, dtype, causal in cells:
        gen = torch.Generator(device=device).manual_seed(SEED)
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=device
                               ).to(dtype) for h in (H, KV, KV))

        def kern(q_, k_, v_):
            return flash_attention(q_, k_, v_, causal=causal)

        def plain(q_, k_, v_):
            return flash_attention_plain(q_, k_, v_, causal=causal)

        got, want = kern(q, k, v), plain(q, k, v)
        if device != "cpu":
            torch.cuda.synchronize()
        err, rel, ok = _compare(got, want, dtype, FLASH_BF16_TOL)
        row = {"cell": name, "shape": [B, S, H, KV, D],
               "dtype": str(dtype).replace("torch.", ""), "causal": causal,
               "max_abs_err": err, "rel_err": rel}
        if device != "cpu":
            row["variant"] = kernel_info(dtype, D, causal)["variant"]
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version on {name}: {row}")
        if timed:
            elt = q.element_size()
            # q, k and v read once (KV heads not repeated), f32 out once
            byte_count = (q.numel() + k.numel() + v.numel()) * elt \
                + q.numel() * 4
            ops = 4.0 * B * H * D * (S * (S + 1) / 2 if causal else S * S)
            b_ms, b_by = bound_ms(byte_count, ops, dtype)
            per_set = (q.numel() + k.numel() + v.numel()) * elt
            n_sets = max(1, math.ceil(2 * L2_BYTES / per_set))
            sets = [(q.clone(), k.clone(), v.clone())
                    for _ in range(n_sets)]
            row.update(ms=time_ms(kern, sets, graph=True),
                       plain_ms=time_ms(plain, sets, graph=False))
            # the yardstick: PyTorch's fused attention on (B, H, S, D)
            # with the KV heads repeated beforehand
            rep = H // KV
            sets = [(s[0].transpose(1, 2),
                     s[1].repeat_interleave(rep, 2).transpose(1, 2),
                     s[2].repeat_interleave(rep, 2).transpose(1, 2))
                    for s in sets]
            row.update(library_ms=time_ms(
                lambda q_, k_, v_: F.scaled_dot_product_attention(
                    q_, k_, v_, is_causal=causal), sets, graph=True),
                bound_ms=b_ms, bound_by=b_by, bytes=byte_count, ops=ops,
                input_sets=n_sets)
            del sets
        rows.append(row)
        print(f"[kernels] flash_attention {name} {row}")
    return rows


def k4_variants(log: str) -> list:
    """Every K4 kernel the library holds, by type, head dim and masking:
    registers and local memory per thread, dynamic shared memory, and
    resident blocks per SM from the CUDA runtime, spill bytes (stores
    plus loads) from the compiler's report ``log`` (None where the
    library was cached and there is no report)."""
    import re
    from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS,
                                                         kernel_info)
    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(wg|fma)_kernelILi(\d+)"
                      r"ELb([01])E", line)
        if m:
            name = (m.group(1), int(m.group(2)), m.group(3) == "1")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills[name] = int(m.group(1)) + int(m.group(2))
            name = None
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for D in HEAD_DIMS:
            kind = "fma" if dtype == torch.float32 else "wg"
            for causal in (True, False):
                rows.append({"dtype": str(dtype).replace("torch.", ""),
                             "D": D, "causal": causal,
                             **kernel_info(dtype, D, causal),
                             "spill_bytes": spills.get((kind, D, causal))})
                print(f"[build] flash_attention variant {rows[-1]}")
    return rows


def block_mm_variants(log: str) -> list:
    """Every K1/K2 kernel the library holds, by path, type, tile columns
    and SKIP or GATE: k rows per stage, registers and local memory per
    thread, dynamic shared memory, resident blocks per SM from the CUDA
    runtime, spill bytes (stores plus loads) from the compiler's report
    ``log`` (None where the library was cached and there is no report)."""
    import re
    from repro_torch.kernels.block_mm.ops import kernel_info
    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(narrow|wide)_kernelI"
                      r"(f|13__nv_bfloat16)?Li(\d+)ELb([01])E", line)
        if m:
            name = ("narrow" if m.group(1) == "narrow" else "wide128",
                    m.group(2) != "f", int(m.group(3)), m.group(4) == "1")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills[name] = int(m.group(1)) + int(m.group(2))
            name = None
    rows = []
    for kernel, dtypes in (("narrow", (torch.float32, torch.bfloat16)),
                           ("wide128", (torch.bfloat16,))):
        for dtype in dtypes:
            for tn in (32, 64):
                for gate in (False, True):
                    rows.append({
                        "kernel": kernel,
                        "dtype": str(dtype).replace("torch.", ""),
                        "tile_cols": tn, "op": "gate" if gate else "skip",
                        **kernel_info(kernel, tn, dtype, gate),
                        "spill_bytes": spills.get(
                            (kernel, dtype == torch.bfloat16, tn, gate))})
                    print(f"[build] block_mm variant {rows[-1]}")
    bad = [r for r in rows if r["local_bytes"] or r["spill_bytes"]]
    if bad:
        raise AssertionError(f"K1/K2 variants with local memory or "
                             f"spills: {bad}")
    return rows


def nm_variants(log: str) -> list:
    """Every K3 kernel the library holds, by path, type, (n, m) and
    offsets layout: m-groups per stage, registers and local memory per
    thread, dynamic shared memory, resident blocks per SM from the CUDA
    runtime, spill bytes (stores plus loads) from the compiler's report
    ``log`` (None where the library was cached and there is no report)."""
    import re
    from repro_torch.kernels.nm_spmm.ops import NM_PAIRS, kernel_info
    spills, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?(narrow|wide)_kernelILi"
                      r"(\d)ELi(\d)E(?:(f|13__nv_bfloat16)|Li(\d+)E)Lb([01])E",
                      line)
        if m:
            name = (m.group(1) + (m.group(5) or ""), m.group(4) != "f",
                    int(m.group(2)), int(m.group(3)), m.group(6) == "1")
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills[name] = int(m.group(1)) + int(m.group(2))
            name = None
    rows = []
    for kernel, dtypes in (("narrow", (torch.float32, torch.bfloat16)),
                           ("wide64", (torch.bfloat16,)),
                           ("wide128", (torch.bfloat16,))):
        for dtype in dtypes:
            for n, m in NM_PAIRS:
                for packed in (False, True):
                    rows.append({
                        "kernel": kernel,
                        "dtype": str(dtype).replace("torch.", ""),
                        "nm": f"{n}:{m}", "packed": packed,
                        **kernel_info(kernel, dtype, n, m, packed),
                        "spill_bytes": spills.get(
                            (kernel, dtype == torch.bfloat16, n, m, packed))})
                    print(f"[build] nm_spmm variant {rows[-1]}")
    return rows


def mapspace_size(M, K, N, spatial_n=8) -> int:
    from repro_torch.core.mapping import factor_splits
    return (len(list(factor_splits(M, 3))) * len(list(factor_splits(K, 3)))
            * len(list(factor_splits(N // spatial_n, 3))))


def lowered_mapspace(design, wl, cons):
    """The (template, bucket, bounds) population that
    ``mapper._search_lowered`` evaluates for a permutation-constrained
    search: every candidate of the budget, in the search's order."""
    from repro_torch.core.batched import bucket_for
    from repro_torch.core.mapper import _full_template, _split_combos
    levels = design.arch.num_levels
    template = _full_template(wl, levels, cons)
    combos = np.asarray(_split_combos(wl, levels, cons)[: cons.budget],
                        np.int64)
    ranks = list(wl.rank_bounds)
    bounds = np.ones((len(combos), template.num_slots), np.int64)
    for j, (r, lvl, sp) in enumerate(template.slots):
        bounds[:, j] = (cons.spatial.get(lvl, {}).get(r, 1) if sp
                        else combos[:, ranks.index(r), lvl])
    return template, bucket_for(template, tuple(ranks)), bounds


def phase_model(device="cuda", layers=RESNET50_LAYERS,
                sizes=MAPSPACE_SIZES, samples=SAMPLES) -> dict:
    """Whole-mapspace search of each ResNet50 layer on ``device``."""
    from repro_torch.core import Sparseloop, compile_stats, matmul
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints, search
    from repro_torch.core.presets import scnn_like, three_level_arch
    design = scnn_like(three_level_arch())
    clear_caches()
    out = {"layers": []}
    with compile_stats.track() as st:
        results = []
        for name, M, K, N, dA, dB in layers:
            size = mapspace_size(M, K, N)
            if sizes is not None and size != sizes[name]:
                raise AssertionError(f"{name}: mapspace has {size} "
                                     f"candidates, expected {sizes[name]}")
            wl = matmul(M, K, N, densities={"A": ("uniform", dA),
                                            "B": ("uniform", dB)},
                        name=name)
            cons = MapspaceConstraints(seed=0, spatial={1: {"n": 8}},
                                       permutations=PERMUTATIONS,
                                       budget=size)
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            with compile_stats.track() as layer_st:
                res = search(design, wl, cons,
                             device=None if device == "cuda" else device)
            dt = time.perf_counter() - t0
            engine_s = layer_st.compile_seconds + layer_st.eval_seconds
            if res.evaluated != size or res.best is None:
                raise AssertionError(f"{name}: evaluated {res.evaluated} "
                                     f"of {size}, best {res.best}")
            results.append((name, wl, cons, size, res, dt, engine_s))
    if st.programs != 1 or st.program_shares < len(layers) - 1:
        raise AssertionError(f"expected one program shared by the "
                             f"layers: {st.as_dict()}")
    oracle = Sparseloop(design)
    label = torch.cuda.get_device_name(0) if device != "cpu" else "cpu"
    for name, wl, cons, size, res, dt, engine_s in results:
        # the winner, re-validated by the scalar oracle
        again = oracle.evaluate(wl, res.best_nest)
        if not (res.best.result.valid and again.result.valid
                and again.edp == res.best.edp):
            raise AssertionError(f"{name}: winner not confirmed by the "
                                 f"scalar oracle")
        # sampled candidates through the same program vs the oracle
        template, bucket, bounds = lowered_mapspace(design, wl, cons)
        pick = np.random.default_rng(0).choice(len(bounds),
                                               min(samples, len(bounds)),
                                               replace=False)
        padded, ids = bucket.lower_population(template, bounds[pick])
        got = Sparseloop(design, device=device).bucketed_model(
            wl, bucket).evaluate(padded, ids)
        worst = 0.0
        for row, i in enumerate(pick):
            nest = template.nest_with(bounds[i])
            ev = oracle.evaluate(wl, nest)
            if bool(got["valid"][row]) != ev.result.valid:
                raise AssertionError(f"{name}: validity differs at {i}")
            if not ev.result.valid:
                # the oracle reports no metrics for a mapping that does
                # not fit; the engine's are held to its unchecked ones
                ev = oracle.evaluate(wl, nest, check_capacity=False)
            for key, ref in (("cycles", ev.cycles),
                             ("energy_pj", ev.energy_pj),
                             ("edp", ev.edp)):
                worst = max(worst, abs(got[key][row] - ref)
                            / max(abs(ref), 1e-300))
        if worst > 1e-6:
            raise AssertionError(f"{name}: sampled candidates differ from "
                                 f"the scalar oracle by {worst:.3e}")
        layer = {"layer": name, "device": label, "candidates": size,
                 "valid": res.valid,
                 "seconds": dt, "candidates_per_s": size / dt,
                 "engine_seconds": engine_s,
                 "best_edp": res.best.edp, "sampled": len(pick),
                 "max_rel_err_sampled": worst}
        out["layers"].append(layer)
        print(f"[model] {json.dumps(layer)}")
    out["compile_stats"] = st.as_dict()
    print(f"[model] compile_stats {json.dumps(st.as_dict())}")
    return out


def phase_profile(layer=RESNET50_LAYERS[0], device="cuda") -> dict:
    """Where one warm engine evaluation of a whole layer's mapspace goes
    on the card: wall seconds, device-busy seconds and kernel launches
    from a ``torch.profiler`` trace."""
    from repro_torch.core import Sparseloop, matmul
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.core.presets import scnn_like, three_level_arch
    name, M, K, N, dA, dB = layer
    design = scnn_like(three_level_arch())
    wl = matmul(M, K, N, densities={"A": ("uniform", dA),
                                    "B": ("uniform", dB)}, name=name)
    cons = MapspaceConstraints(seed=0, spatial={1: {"n": 8}},
                               permutations=PERMUTATIONS,
                               budget=mapspace_size(M, K, N))
    template, bucket, bounds = lowered_mapspace(design, wl, cons)
    padded, ids = bucket.lower_population(template, bounds)
    model = Sparseloop(design, device=device).bucketed_model(wl, bucket)
    model.evaluate(padded, ids)
    t0 = time.perf_counter()
    model.evaluate(padded, ids)
    warm = time.perf_counter() - t0
    out = {"layer": name, "candidates": len(bounds), "warm_s": warm,
           **_device_busy(lambda: model.evaluate(padded, ids), device)}
    print(f"[profile] {json.dumps(out)}")
    return out


def _search_run(fn, device) -> tuple:
    """(result, wall seconds, compile_stats delta) of one search call,
    the card drained before and after."""
    from repro_torch.core import compile_stats
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with compile_stats.track() as st:
        res = fn()
    if device != "cpu":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0, st


def _revalidated(design, wl, res, what: str) -> float:
    """The winner's EDP from a fresh scalar oracle, which must confirm
    the search's mapping as valid with the same EDP to 1e-6."""
    from repro_torch.core import Sparseloop
    if res.best is None:
        raise AssertionError(f"{what}: no valid mapping found")
    again = Sparseloop(design).evaluate(wl, res.best_nest)
    if not (again.result.valid and abs(again.edp - res.best.edp)
            <= ORACLE_REL * abs(again.edp)):
        raise AssertionError(f"{what}: winner not confirmed by the scalar "
                             f"oracle ({again.edp} vs {res.best.edp})")
    return again.edp


def phase_search(device="cuda", layer=RESNET50_LAYERS[0],
                 budget=SEARCH_BUDGET, pop=SEARCH_POP, seeds=SEARCH_SEEDS,
                 layers=RESNET50_LAYERS, es_pop=ES_POP, es_gens=ES_GENS,
                 trace_gens=SEARCH_TRACE_GENS, out_dir=None) -> dict:
    """Sparseloop's mapspace search on ``device``.

    The Table-5 convergence setup on ``layer`` (ResNet50 conv2_x under
    ``scnn_like(three_level_arch())``, spatial n = 8): enumeration at
    ``budget`` and 10x ``budget``, and the four strategies at ``budget``
    with population ``pop`` and key 0.  ES at ``budget`` over
    ``seeds``, as a ratio to enumeration at 10x ``budget``, must be
    drawn from the JAX package's distribution of that ratio
    (``REFERENCE_ES_RATIOS``, two-sample KS at ``SEARCH_KS_ALPHA``; the
    port's random stream is torch's, so a single key is one draw of a
    ratio whose median is near 1 in both packages), and every seed's
    run must beat enumeration at equal budget.  Then one production-scale
    ES per ResNet50 layer through the ``hillclimb`` CLI (population
    ``es_pop``, ``es_gens`` generations), and a traced ES run of
    ``trace_gens`` generations for the device's idle share.  Every
    winner is re-validated by the scalar oracle."""
    from repro_torch.core import compile_stats, matmul
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.core.presets import scnn_like, three_level_arch
    from repro_torch.search import run_search
    dev = None if device == "cuda" else device
    design = scnn_like(three_level_arch())
    card = card_line() if device != "cpu" else "cpu"
    name, M, K, N, dA, dB = layer
    wl = matmul(M, K, N, densities={"A": ("uniform", dA),
                                    "B": ("uniform", dB)}, name=name)
    spatial = {1: {"n": 8}}
    clear_caches()
    out = {"card": card, "layer": name, "enumeration": {},
           "strategies": {}}
    with compile_stats.track() as phase_st:
        _search_convergence(out, design, wl, dev, device, budget, pop,
                            seeds, spatial)
        _search_production(out, design, dev, device, layers, es_pop,
                           es_gens, card, out_dir)
    # programs built over the phase: enumeration and every strategy
    # run, on every layer, lower into one bucket
    out["programs"] = phase_st.programs
    out["compiles"] = phase_st.compiles
    print(f"[search] programs {phase_st.programs} compiles "
          f"{phase_st.compiles} scalar evals {phase_st.scalar_evals}")
    if trace_gens:
        clear_caches()
        tcons = MapspaceConstraints(budget=es_pop * trace_gens, seed=0,
                                    spatial=spatial)
        run_search(design, wl, tcons, strategy="es", key=1,
                   pop_size=es_pop, device=dev)      # first call untraced
        out["traced"] = _device_busy(lambda: run_search(
            design, wl, tcons, strategy="es", key=0, pop_size=es_pop,
            device=dev), device)
        out["traced"]["generations"] = trace_gens
        print(f"[search] traced {json.dumps({'card': card, **out['traced']})}")
    return out


def _search_row(design, workload, res, dt, st, what) -> dict:
    """One search run's numbers; its winner re-validated."""
    engine = st.compile_seconds + st.eval_seconds
    return {"evaluated": res.evaluated, "valid": res.valid,
            "best_edp": res.best.edp if res.best else None,
            "revalidated_edp": _revalidated(design, workload, res, what),
            "seconds": dt, "candidates_per_s": res.evaluated / dt,
            "programs": st.programs, "compiles": st.compiles,
            "scalar_evals": st.scalar_evals,
            "host_share": 1.0 - engine / dt}


def _search_convergence(out, design, wl, dev, device, budget, pop, seeds,
                        spatial) -> None:
    """The Table-5 convergence cell of ``phase_search``."""
    from repro_torch.core.mapper import MapspaceConstraints, search
    from repro_torch.search import run_search
    for mult in (1, 10):
        cons = MapspaceConstraints(budget=budget * mult, seed=0,
                                   spatial=spatial)
        res, dt, st = _search_run(
            lambda: search(design, wl, cons, device=dev), device)
        out["enumeration"][budget * mult] = _search_row(
            design, wl, res, dt, st, f"enumeration@{budget * mult}")
    cons = MapspaceConstraints(budget=budget, seed=0, spatial=spatial)
    for strat in ("random", "hillclimb", "annealing", "es"):
        res, dt, st = _search_run(
            lambda: run_search(design, wl, cons, strategy=strat, key=0,
                               pop_size=pop, device=dev), device)
        traj = res.log.trajectory("best_edp")
        if any(a < b for a, b in zip(traj, traj[1:])):
            raise AssertionError(f"{strat}: trajectory not monotone")
        if st.programs > 1 or st.scalar_evals:
            raise AssertionError(f"{strat}: {st.as_dict()}, expected one "
                                 f"program and no scalar evaluations")
        out["strategies"][strat] = _search_row(design, wl, res, dt, st,
                                               f"{strat}@{budget}")
    enum1 = out["enumeration"][budget]["best_edp"]
    enum10 = out["enumeration"][budget * 10]["best_edp"]
    es_edp = [run_search(design, wl, cons, strategy="es", key=k,
                         pop_size=pop, device=dev).best.edp for k in seeds]
    from scipy.stats import ks_2samp
    ratios = [e / enum10 for e in es_edp]
    ref = REFERENCE_ES_RATIOS[:len(seeds)]
    out["es_vs_enum10x"] = {
        "key0": out["strategies"]["es"]["best_edp"] / enum10,
        "seeds": len(seeds), "median": float(np.median(ratios)),
        "at_or_below": sum(r <= 1.0 for r in ratios), "ratios": ratios,
        "reference_median": float(np.median(ref)),
        "reference_at_or_below": sum(r <= 1.0 for r in ref),
        "ks_p": float(ks_2samp(ratios, ref).pvalue)}
    out["es_vs_enum1x"] = [e / enum1 for e in es_edp]
    print(f"[search] {json.dumps(out)}")
    print(f"[search] ES@{budget} / enumeration@{budget * 10} at key 0: "
          f"{out['es_vs_enum10x']['key0']:.4f} (not asserted: a single "
          f"key is one draw of a ratio whose median is "
          f"{out['es_vs_enum10x']['median']:.4f} here and "
          f"{out['es_vs_enum10x']['reference_median']:.4f} in the JAX "
          f"package over the same {len(seeds)} seeds)")
    if not len(ref) == len(seeds) or not (
            out["es_vs_enum10x"]["ks_p"] >= SEARCH_KS_ALPHA):
        raise AssertionError(f"ES@{budget} over seeds not drawn from the "
                             f"JAX package's distribution: "
                             f"{out['es_vs_enum10x']}")
    if not max(out["es_vs_enum1x"]) <= 1.0:
        raise AssertionError(f"ES@{budget} above enumeration at equal "
                             f"budget: {out['es_vs_enum1x']}")


def _search_production(out, design, dev, device, layers, es_pop, es_gens,
                       card, out_dir) -> None:
    """``phase_search``'s production-scale ES: the hillclimb CLI, one
    run per ResNet50 layer."""
    import contextlib
    import io
    from repro_torch.core import matmul
    from repro_torch.launch import hillclimb
    out["production"] = []
    logs = Path(out_dir) if out_dir else _root() / "chiprun_out"
    logs.mkdir(exist_ok=True)
    for lname, M, K, N, dA, dB in layers:
        argv = ["--design", "scnn", "--mkn", str(M), str(K), str(N),
                "--densities", str(dA), str(dB), "--strategy", "es",
                "--budget", str(es_pop * es_gens), "--pop", str(es_pop),
                "--seed", "0", "--spatial-n", "8",
                "--out", str(logs / f"search_{lname}.json")]
        if dev is not None:
            argv += ["--device", dev]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            res, dt, st = _search_run(lambda: hillclimb.main(argv), device)
        r = {"layer": lname, "generations": len(res.log.records),
             **_search_row(design, matmul(M, K, N, densities={
                 "A": ("uniform", dA), "B": ("uniform", dB)}),
                 res, dt, st, f"hillclimb es {lname}")}
        if res.evaluated != es_pop * es_gens or st.scalar_evals:
            raise AssertionError(f"{lname}: {res.evaluated} evaluated, "
                                 f"{st.as_dict()}")
        out["production"].append(r)
        print(f"[search] {json.dumps({'card': card, **r})}")


def _layer_cell(layer=RESNET50_LAYERS[0]):
    """(design, workload) of a ResNet50 layer's Table-5 cell (conv2_x
    by default)."""
    from repro_torch.core import matmul
    from repro_torch.core.presets import scnn_like, three_level_arch
    name, M, K, N, dA, dB = layer
    return scnn_like(three_level_arch()), matmul(
        M, K, N, densities={"A": ("uniform", dA), "B": ("uniform", dB)},
        name=name)


def _warm_gens_per_s(res) -> float:
    """Warm generations/s of a search: a host run drops its first
    generation record, a fused run its first chunk (each holds the
    first call: allocations, and on the card the graph capture)."""
    if res.log.timing.get("fused"):
        warm = res.log.timing["chunks"][1:]
        return sum(c["generations"] for c in warm) / sum(
            c["wall_s"] for c in warm)
    warm = res.log.records[1:]
    return len(warm) / sum(r.wall_time_s for r in warm)


def phase_fused(device="cuda", pop=FUSED_POP, gens=FUSED_GENS,
                chunk=FUSED_CHUNK, layers=RESNET50_LAYERS,
                prod_pop=ES_POP, prod_gens=ES_GENS,
                prod_chunk=ES_FUSED_CHUNK,
                host_production=None) -> dict:
    """The device-resident fused search on ``device`` against the host
    loop, on ``bench_fused``'s cell (ResNet50 conv2_x,
    ``scnn_like(three_level_arch())``, spatial n = 8, free
    permutations, key 0): ES at ``pop`` for ``gens`` generations, host
    loop and fused path (chunks of ``chunk``).  The fused path must beat
    the host loop's warm generations/s (printed beside the JAX
    package's own bar, ``FUSED_SPEEDUP_BOUND``), capture one graph for
    the run and run no scalar evaluation; a same-key rerun must give
    the same log and capture nothing; the winner is re-validated by the
    scalar oracle.  Then fused ES at ``prod_pop`` x ``prod_gens`` on
    each ResNet50 layer (phase 5's production cell; its host numbers
    ``host_production`` printed beside), and the device's idle share
    over one traced warm chunk."""
    from repro_torch.core import Sparseloop, compile_stats
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.search import (MapspaceEncoding, SearchConfig,
                                    get_fused_program, make_strategy,
                                    run_search)
    from repro_torch.search.fused import graph_captures
    from repro_torch.search.runner import ARCHIVE_SIZE
    dev = None if device == "cuda" else device
    cuda = device != "cpu"
    card = card_line() if cuda else "cpu"
    design, wl = _layer_cell()
    cons = MapspaceConstraints(budget=pop * gens, seed=0,
                               spatial={1: {"n": 8}})
    cfg = SearchConfig(fused_chunk=chunk)
    kw = dict(strategy="es", key=0, pop_size=pop, generations=gens,
              device=dev)
    clear_caches()
    host, dt_host, _ = _search_run(
        lambda: run_search(design, wl, cons, fused=False, **kw), device)
    clear_caches()
    fused, dt_fused, st = _search_run(
        lambda: run_search(design, wl, cons, fused=True, config=cfg,
                           **kw), device)
    captures = graph_captures()
    again, _, st2 = _search_run(
        lambda: run_search(design, wl, cons, fused=True, config=cfg,
                           **kw), device)
    out = {"card": card, "pop": pop, "generations": gens, "chunk": chunk,
           "host_warm_gens_per_s": _warm_gens_per_s(host),
           "fused_warm_gens_per_s": _warm_gens_per_s(fused),
           "host_wall_s": dt_host, "fused_wall_s": dt_fused,
           "host_best_edp": _revalidated(design, wl, host, "host es"),
           "fused_best_edp": _revalidated(design, wl, fused, "fused es"),
           "graph_captures": captures,
           "rerun_graph_captures": graph_captures() - captures,
           "fused_compiles": st.compiles_by_kind.get("fused", 0),
           "rerun_fused_compiles": st2.compiles_by_kind.get("fused", 0),
           "scalar_evals": st.scalar_evals,
           "rerun_identical": again.log.to_json(timing=False)
           == fused.log.to_json(timing=False),
           "chunks": fused.log.timing["chunks"]}
    out["speedup"] = (out["fused_warm_gens_per_s"]
                      / out["host_warm_gens_per_s"])
    print(f"[fused] {json.dumps(out)}")
    print(f"[fused] warm generations/s: host {out['host_warm_gens_per_s']:.1f}"
          f", fused {out['fused_warm_gens_per_s']:.1f}: "
          f"{out['speedup']:.2f}x (the JAX package's bar: >= "
          f"{FUSED_SPEEDUP_BOUND}x)")
    if cuda and not out["speedup"] > 1.0:
        raise AssertionError(f"fused path not faster than the host loop: "
                             f"{out}")
    if (out["graph_captures"] != (1 if cuda else 0)
            or out["rerun_graph_captures"] or out["fused_compiles"] != 1
            or out["rerun_fused_compiles"] or out["scalar_evals"]
            or not out["rerun_identical"]
            or fused.log.evaluations != pop * gens):
        raise AssertionError(f"fused contracts broken: {out}")

    # production: fused ES per ResNet50 layer, host numbers beside
    out["production"] = []
    host_by_layer = {r["layer"]: r for r in host_production or ()}
    pcfg = SearchConfig(fused_chunk=prod_chunk)
    for lname, M, K, N, dA, dB in layers:
        design, lwl = _layer_cell((lname, M, K, N, dA, dB))
        pcons = MapspaceConstraints(budget=prod_pop * prod_gens, seed=0,
                                    spatial={1: {"n": 8}})
        res, dt, lst = _search_run(lambda: run_search(
            design, lwl, pcons, strategy="es", key=0, pop_size=prod_pop,
            fused=True, config=pcfg, device=dev), device)
        hrow = host_by_layer.get(lname, {})
        row = {"layer": lname, "evaluated": res.evaluated, "seconds": dt,
               "candidates_per_s": res.evaluated / dt,
               "warm_candidates_per_s": _warm_gens_per_s(res) * prod_pop,
               "host_candidates_per_s": hrow.get("candidates_per_s"),
               "best_edp": _revalidated(design, lwl, res,
                                        f"fused es {lname}"),
               "host_best_edp": hrow.get("best_edp"),
               "scalar_evals": lst.scalar_evals}
        if res.evaluated != prod_pop * prod_gens or lst.scalar_evals:
            raise AssertionError(f"fused {lname}: {row}")
        out["production"].append(row)
        print(f"[fused] {json.dumps({'card': card, **row})}")
    # one traced warm chunk of the last layer's program
    enc = MapspaceEncoding(lwl, 3, pcons)
    bm = Sparseloop(design, device=device).bucketed_model(lwl, enc.bucket)
    fp = get_fused_program(bm, enc, make_strategy("es", pop_size=prod_pop),
                           archive_k=ARCHIVE_SIZE)
    carry, _ = fp.invoke_chunk(fp.init_carry(1), prod_chunk)
    out["traced"] = _device_busy(
        lambda: fp.invoke_chunk(carry, prod_chunk), device)
    out["traced"].update(generations=prod_chunk, pop=prod_pop,
                         layer=layers[-1][0])
    print(f"[fused] traced {json.dumps({'card': card, **out['traced']})}")
    return out


def _hybrid_space():
    from repro_torch.search import DesignSpace
    return DesignSpace(
        capacity_steps={"GLB": (6 * 1024, 48 * 1024, 96 * 1024,
                                192 * 1024),
                        "SPad": (64, 256, 512)},
        bandwidth_steps={"DRAM": (2.0, 8.0, 32.0)})


def phase_hybrid(device="cuda", seeds=SEARCH_SEEDS, gens=HYBRID_GENS,
                 pop=FUSED_POP, lr=HYBRID_LR, grad_pop=ES_POP) -> dict:
    """Hybrid ES+SGD on ``device``: ``bench_codesign``'s provisioning
    space (GLB and SPad capacities, DRAM bandwidth) co-searched with
    conv2_x's mappings, fused ES at ``pop`` for ``gens`` generations,
    with the SGD step (``lr``) and without, over ``seeds``.  The ratios
    hybrid / pure must be drawn from the JAX package's distribution
    (``REFERENCE_HYBRID_RATIOS``, two-sample KS at
    ``SEARCH_KS_ALPHA``), every winner re-validated under its own
    design.  Then ``evaluate_with_arch_grad`` on ``grad_pop`` random
    genomes of the space, raw and surrogate, on ``device`` against the
    port on the CPU (``HYBRID_GRAD_REL``)."""
    from scipy.stats import ks_2samp

    from repro_torch.core import Sparseloop
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.search import CoSearchEncoding, SearchConfig, run_search
    dev = None if device == "cuda" else device
    card = card_line() if device != "cpu" else "cpu"
    design, wl = _layer_cell()
    space = _hybrid_space()
    cons = MapspaceConstraints(budget=pop * gens, seed=0,
                               spatial={1: {"n": 8}})
    kw = dict(strategy="es", pop_size=pop, generations=gens,
              design_space=space, fused=True,
              config=SearchConfig(fused_chunk=gens), device=dev)
    out = {"card": card, "pure": [], "hybrid": [], "seconds": {}}
    for name, rate in (("pure", 0.0), ("hybrid", lr)):
        t0 = time.perf_counter()
        for k in seeds:
            res = run_search(design, wl, cons, key=k, sgd_lr=rate, **kw)
            again = Sparseloop(res.best_design).evaluate(wl, res.best_nest)
            if not (again.result.valid and abs(again.edp - res.best.edp)
                    <= ORACLE_REL * abs(again.edp)):
                raise AssertionError(f"{name} seed {k}: winner not "
                                     f"confirmed by the scalar oracle")
            out[name].append(res.best.edp)
        out["seconds"][name] = time.perf_counter() - t0
    ratios = [h / p for h, p in zip(out["hybrid"], out["pure"])]
    ref = REFERENCE_HYBRID_RATIOS[:len(seeds)]
    out.update(ratios=ratios, median=float(np.median(ratios)),
               at_or_below=sum(r <= 1.0 for r in ratios),
               reference_median=float(np.median(ref)),
               reference_at_or_below=sum(r <= 1.0 for r in ref),
               ks_p=float(ks_2samp(ratios, ref).pvalue))
    # the architecture gradient at population scale, card vs CPU
    enc = CoSearchEncoding(wl, 3, cons, space, design)
    g = enc.repair(np.random.default_rng(0).integers(
        0, 1 << 30, (grad_pop, enc.genome_size)))
    bucket, bounds, ids = enc.decode_bucketed(g)
    ap = enc.arch_params_of(g)
    worst = {}
    fwd = [Sparseloop(design, device=d).bucketed_model(wl, bucket).evaluate(
        bounds, ids, arch_params=ap)["edp"] for d in (device, "cpu")]
    worst["forward.edp"] = float(np.max(np.abs(fwd[0] - fwd[1])
                                        / np.abs(fwd[1])))
    for surrogate in (False, True):
        got, want = (Sparseloop(design, device=d).bucketed_model(
            wl, bucket).evaluate_with_arch_grad(
                bounds, ids, arch_params=ap, surrogate=surrogate)
            for d in (device, "cpu"))
        for key in ("loss", "grad_storage", "grad_compute"):
            a, b = got[key], want[key]
            fin = np.isfinite(b)
            if not (np.array_equal(fin, np.isfinite(a))):
                raise AssertionError(f"arch grad {key}: finiteness differs")
            rel = np.abs(a[fin] - b[fin]) / np.maximum(
                np.abs(b[fin]), 1e-300)
            tiny = np.abs(b[fin]) <= 1e-12 * np.abs(b[fin]).max()
            worst[f"{'surrogate' if surrogate else 'raw'}.{key}"] = float(
                np.where(tiny, 0.0, rel).max(initial=0.0))
    out["arch_grad_max_rel"] = worst
    out["grad_pop"] = grad_pop
    print(f"[hybrid] {json.dumps(out)}")
    if not (len(ref) == len(seeds) and out["ks_p"] >= SEARCH_KS_ALPHA):
        raise AssertionError(f"hybrid / pure over seeds not drawn from the "
                             f"JAX package's distribution: {out}")
    if max(worst.values()) > HYBRID_GRAD_REL:
        raise AssertionError(f"arch gradient on {device} differs from the "
                             f"CPU's: {worst}")
    return out


def phase_service(device="cuda", n_islands=ISLANDS, pop=FUSED_POP,
                  gens=ISLAND_GENS, migrate_every=ISLAND_MIGRATE) -> dict:
    """The DSE service on ``device``: ``n_islands`` ES islands (population
    ``pop``, ``gens`` generations, ring migration every
    ``migrate_every``) through one service against the same searches run
    one after another on their own, on the conv2_x cell.  The islands
    must run one program and one first call in total (one bucket, one
    shape) and every island's winner is re-validated by the scalar
    oracle; the candidates/s ratio is printed.  Then fused island mode
    with migration (every chunk through the service's evaluator
    thread), and fused islands without migration held to fused
    ``run_search`` on the same seeds on this thread: the graph replayed
    from the service's thread must give the same trajectories."""
    from repro_torch.core import compile_stats
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.dse import run_islands
    from repro_torch.dse.islands import island_seeds
    from repro_torch.search import SearchConfig, run_search
    dev = None if device == "cuda" else device
    card = card_line() if device != "cpu" else "cpu"
    design, wl = _layer_cell()
    cons = MapspaceConstraints(budget=pop * gens, seed=0,
                               spatial={1: {"n": 8}})
    seeds = island_seeds(0, n_islands)
    clear_caches()
    alone, dt_alone, _ = _search_run(lambda: [run_search(
        design, wl, cons, strategy="es", key=s, pop_size=pop,
        generations=gens, device=dev) for s in seeds], device)
    clear_caches()
    with compile_stats.track() as st:
        isl, dt_isl, _ = _search_run(lambda: run_islands(
            design, wl, cons, n_islands=n_islands, key=0, pop_size=pop,
            generations=gens, migrate_every=migrate_every, device=dev),
            device)
    for i, r in enumerate(isl.per_island):
        _revalidated(design, wl, r, f"island {i}")
    evals = n_islands * pop * gens
    out = {"card": card, "islands": n_islands, "pop": pop,
           "generations": gens, "programs": st.programs,
           "compiles": st.compiles, "scalar_evals": st.scalar_evals,
           "service": isl.service_stats,
           "islands_candidates_per_s": evals / dt_isl,
           "alone_candidates_per_s": evals / dt_alone,
           "islands_best_edp": isl.best.best.edp,
           "alone_best_edp": min(r.best.edp for r in alone)}
    out["candidates_per_s_ratio"] = (out["islands_candidates_per_s"]
                                     / out["alone_candidates_per_s"])
    if (st.programs > 1 or st.compiles > 1 or st.scalar_evals
            or isl.evaluations != evals):
        raise AssertionError(f"islands: {out}")
    fused, dt_fused, _ = _search_run(lambda: run_islands(
        design, wl, cons, n_islands=n_islands, key=0, pop_size=pop,
        generations=gens, migrate_every=migrate_every, fused=True,
        device=dev), device)
    for i, r in enumerate(fused.per_island):
        _revalidated(design, wl, r, f"fused island {i}")
    out["fused"] = {"service": fused.service_stats, "seconds": dt_fused,
                    "candidates_per_s": evals / dt_fused,
                    "best_edp": fused.best.best.edp}
    chunks = n_islands * -(-gens // migrate_every)
    if (fused.service_stats["fused_chunks"] != chunks
            or fused.service_stats["batches"]
            or fused.evaluations != evals):
        raise AssertionError(f"fused islands: {out['fused']}")
    free = run_islands(design, wl, cons, n_islands=n_islands, key=0,
                       pop_size=pop, generations=gens, migrate_every=0,
                       fused=True, config=SearchConfig(fused_chunk=gens),
                       device=dev)
    direct = [run_search(design, wl, cons, strategy="es", key=s,
                         pop_size=pop, generations=gens, fused=True,
                         config=SearchConfig(fused_chunk=gens), device=dev)
              for s in seeds]
    same = [a.to_dict(timing=False)["records"]
            == b.log.to_dict(timing=False)["records"]
            for a, b in zip(free.logs, direct)]
    out["fused"]["threads_same_as_direct"] = same
    print(f"[service] {json.dumps(out)}")
    if not all(same):
        raise AssertionError(f"fused islands replayed on the service's "
                             f"thread differ from direct runs: {same}")
    return out


def phase_validation(device="cuda", layers=RESNET50_LAYERS,
                     sides=REFSIM_SIDES, samples=REFSIM_SAMPLES) -> dict:
    """The paper's validation on the port: Fig. 11-13's errors of the
    analytical model against the copied refsim (host-side model
    outputs), then Table 5: the batched engine's CPHC over ``TEMPLATE3``
    tilings of the ResNet50 layers on ``device``, and its speedup over
    refsim on the same mappings at the cube ``sides``."""
    from repro_torch import validation
    dev = None if device == "cuda" else device
    card = card_line() if device != "cpu" else "cpu"
    out = {"card": card}
    t0 = time.perf_counter()
    figs = {"fig11": validation.fig11_scnn(),
            "fig12": validation.fig12_eyerissv2(),
            "fig13": validation.fig13_dstc()}
    out["figures_s"] = time.perf_counter() - t0
    out["fig11_max_err_pct"] = figs["fig11"]["max_err_pct"]
    out["fig11_mean_err_pct"] = figs["fig11"]["mean_err_pct"]
    out["fig12_uniform_mean_err_pct"] = \
        figs["fig12"]["uniform_mean_err_pct"]
    out["fig12_actual_mean_err_pct"] = figs["fig12"]["actual_mean_err_pct"]
    out["fig13_avg_err_pct"] = figs["fig13"]["avg_err_pct"]
    for key, v in out.items():
        if key.endswith("_pct") and not (0.0 <= v < 100.0):
            raise AssertionError(f"validation: {key} = {v}")
    out["table5"] = validation.engine_cphc(layers, device=dev)
    out["refsim"] = validation.refsim_speedup(sides, samples, device=dev)
    print(f"[validation] {json.dumps(out)}")
    return out


def _oracle_nest(M: int, K: int, N: int):
    """``tpu_mapping(M, K, N)`` as the scalar oracle must see it: with its
    unit-bound loops dropped, which is how the batched engine lowers a
    bound-1 slot (``NestTemplate.nest_with``)."""
    from repro_torch.core.advisor import tpu_mapping
    from repro_torch.core.mapping import LoopNest
    nest = tpu_mapping(M, K, N)
    return LoopNest(loops=tuple(lp for lp in nest.loops if lp.bound > 1),
                    num_levels=nest.num_levels)


def _device_busy(fn, device, detail=None) -> dict:
    """Wall seconds, device-busy seconds and device events of one call
    of ``fn``, from a ``torch.profiler`` trace, and the device window
    (first device event's start to the last one's end): the idle time
    inside it is gaps between device operations, the rest is the host
    before and after them.  ``detail(prof)`` adds its dict of figures
    read from the same trace.  A profiler range's own span on the device
    timeline (a user annotation) is not device work and is left out."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if device != "cpu":
            torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    window = (max(e.time_range.end for e in dev)
              - min(e.time_range.start for e in dev)) / 1e6 if dev else 0.0
    return {"traced_s": traced, "device_busy_s": busy,
            "device_window_s": window, "device_events": len(dev),
            "idle_share": 1.0 - busy / traced if traced else None,
            **(detail(prof) if detail else {})}


def phase_fleet(device="cuda", configs=None, reduced=False,
                samples=FLEET_SAMPLES, expect=(178, 142)) -> dict:
    """The fleet sweep at full width on ``device``: every architecture,
    prefill + decode, production mesh, crossover grid; sampled rows held
    to the scalar oracle; the advisor's verdicts for qwen2-0.5b."""
    from repro_torch import obs
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.core import Sparseloop, compile_stats, matmul
    from repro_torch.core.advisor import advise, describe
    from repro_torch.core.batched import clear_caches
    from repro_torch.fleet.sweep import (_evaluate_shapes, default_options,
                                         fleet_sweep)
    dev = None if device == "cuda" else device
    configs = tuple(configs or ARCH_NAMES)
    clear_caches()
    obs.enable()
    try:
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with compile_stats.track() as st:
            rep = fleet_sweep(configs, reduced=reduced, crossover=True,
                              device=dev)
        wall = time.perf_counter() - t0
        spans = {name: obs.tracer().total(name) for name in
                 ("fleet.extract", "fleet.option", "fleet.crossover")}
    finally:
        obs.disable()
    if expect and (rep.total_entries, rep.unique_shapes) != expect:
        raise AssertionError(f"fleet: {rep.total_entries} entries, "
                             f"{rep.unique_shapes} unique shapes; expected "
                             f"{expect}")
    if (st.programs > rep.compile_bound or st.compiles > rep.compile_bound
            or st.scalar_evals):
        raise AssertionError(f"fleet: programs {st.programs}, compiles "
                             f"{st.compiles}, scalar evals "
                             f"{st.scalar_evals} against the bound "
                             f"{rep.compile_bound}")
    print(f"[fleet] {rep.summary()}")
    # sampled rows, every option, against the scalar oracle
    opts = {o.name: o for o in default_options()}
    pick = np.random.default_rng(0).choice(
        len(rep.rows), min(samples, len(rep.rows)), replace=False)
    worst, checked = 0.0, 0
    for i in pick:
        r = rep.rows[i]
        for name, got in r.options.items():
            o = opts[name]
            ev = Sparseloop(o.design).evaluate(
                matmul(r.M, r.K, r.N, densities=o.densities),
                _oracle_nest(r.M, r.K, r.N), check_capacity=False)
            for key, ref in (("cycles", ev.cycles),
                             ("energy_pj", ev.energy_pj),
                             ("edp", ev.edp)):
                worst = max(worst, abs(got[key] - ref)
                            / max(abs(ref), 1e-300))
            checked += 1
    if worst > ORACLE_REL:
        raise AssertionError(f"fleet: sampled rows differ from the scalar "
                             f"oracle by {worst:.3e}")
    t0 = time.perf_counter()
    adv = advise(get_config(configs[0] if reduced else "qwen2-0.5b",
                            reduced=reduced), device=dev)
    adv_s = time.perf_counter() - t0
    print(describe(adv))
    # where the evaluations go: a trace of one option over a slice of
    # the unique shapes (the profiler's own bookkeeping grows with the
    # ~1,000 device events of each single-shape evaluation)
    shapes = sorted({(r.M, r.K, r.N) for r in rep.rows})[:PROFILE_SHAPES]
    busy = _device_busy(lambda: _evaluate_shapes(
        opts["dense"], shapes, device=dev), device)
    busy["shapes"] = len(shapes)
    out = {"device": torch.cuda.get_device_name(0) if device != "cpu"
           else "cpu", "configs": len(configs),
           "entries": rep.total_entries, "unique_shapes": rep.unique_shapes,
           "options": list(rep.option_names),
           "compile_bound": rep.compile_bound, "programs": st.programs,
           "compiles": st.compiles, "wall_s": wall,
           "compile_s": st.compile_seconds, "eval_s": st.eval_seconds,
           "evaluations": st.batched_evals, "dedup_evals": st.dedup_evals,
           "spans_s": spans,
           "crossover_kn": len(rep.crossover),
           "compress_rows": sum(r.verdict == "compress" for r in rep.rows),
           "sampled_rows": len(pick), "sampled_evals": checked,
           "max_rel_err_sampled": worst, "advise_s": adv_s,
           "advise": [dict(layer=a.layer, shape=[a.M, a.K, a.N],
                           bottleneck=a.dense_bottleneck, best=a.best_name,
                           speedup=a.speedup) for a in adv],
           "traced_pass": busy}
    print(f"[fleet] {json.dumps(out)}")
    return out


def _serve_model(device, arch, layers=None, dtype=None, reduced=False):
    """The port's model of ``arch`` at full width (``layers`` cuts the
    depth, the encoder's too, ``dtype`` overrides the configuration's),
    weights drawn from a generator seeded ``SEED`` on ``device``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_api
    cfg = get_config(arch, reduced=reduced)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  enc_layers=layers if cfg.enc_dec else 0)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    api = get_api(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    return cfg, api, api.init(cfg, gen, device)


def phase_serve(device="cuda", arch=SERVE["arch"], reduced=False,
                batch=SERVE["batch"], prompt_len=SERVE["prompt_len"],
                gen=SERVE["gen"], requests=SERVE["requests"],
                trace_steps=SERVE_TRACE_STEPS) -> dict:
    """``ServeLoop`` over ``arch``: every request served in full, K4
    launched once per layer and prefill on the card; prefill and
    decode-step times, tokens/s and latency from an untraced run, then
    the device's idle share over ``trace_steps`` decode steps of a
    second loop (one wave) on the same weights, and the device time of
    a third loop's traced first-wave prefill."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.serve import ServeLoop
    cfg, api, model = _serve_model(device, arch, reduced=reduced)
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, size=(requests, prompt_len)).astype(np.int32)

    def new_loop(n, gen_):
        loop = ServeLoop(api, cfg, model, batch=batch,
                         prompt_len=prompt_len, gen=gen_,
                         device=None if device == "cuda" else device)
        for r in range(n):
            loop.submit(r, prompts[r])
        t0 = time.perf_counter()
        loop.start()                    # synchronises inside its span
        return loop, (time.perf_counter() - t0) * 1e3

    loop, prefill_ms = new_loop(requests, gen)
    step_ms, more = [], True
    while more:
        t0 = time.perf_counter()
        more = loop.step()              # ends by reading the tokens back
        step_ms.append((time.perf_counter() - t0) * 1e3)
    res = loop.result()
    if (loop.served != requests
            or any(len(v) != gen for v in res["outputs"].values())):
        raise AssertionError(f"serve: {loop.served} of {requests} requests "
                             f"served in full")
    tokens = np.concatenate([np.asarray(v) for v in res["outputs"].values()])
    if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError("serve: token ids outside the vocabulary")
    # the traced stretch: one wave, its decode steps after the first
    traced, warm_prefill_ms = new_loop(batch, trace_steps + 1)
    traced.step()
    busy = _device_busy(lambda: [traced.step()
                                 for _ in range(trace_steps)], device)
    busy["steps"] = trace_steps
    # one more warm first-wave prefill, traced: the device time that the
    # host-bound wall time hides, K4's 24 launches among it
    waves = []
    prefill_busy = _device_busy(lambda: waves.append(new_loop(batch, 1)),
                                device)
    prefills = loop.prefills + traced.prefills + waves[0][0].prefills
    want = cfg.num_layers * prefills
    if device != "cpu" and flash_attention.launches != want:
        raise AssertionError(f"serve: K4 launched {flash_attention.launches}"
                             f" times, expected {cfg.num_layers} layers x "
                             f"{prefills} prefills = {want}")
    lat = res["latency_s"]
    out = {"arch": cfg.name, "device": torch.cuda.get_device_name(0)
           if device != "cpu" else "cpu", "dtype": cfg.dtype,
           "layers": cfg.num_layers, "batch": batch,
           "prompt_len": prompt_len, "gen": gen, "requests": requests,
           "prefills": loop.prefills, "decode_steps": loop.decode_steps,
           "k4_launches": flash_attention.launches,
           "k4_launches_expected": want,
           "prefill_ms": prefill_ms, "prefill_ms_warm": warm_prefill_ms,
           "decode_step_ms_median": float(np.median(step_ms)),
           "decode_step_ms_max": max(step_ms),
           "tokens_per_s": res["tokens_per_s"],
           "latency_p50_s": lat["p50_s"], "latency_p99_s": lat["p99_s"],
           "latency_max_s": lat["max_s"], "traced_decode": busy,
           "traced_prefill": prefill_busy}
    print(f"[serve] {json.dumps(out)}")
    return out


def phase_serve_logits(device="cuda", arch=SERVE["arch"], layers=2,
                       batch=2, prompt_len=128, tol=SERVE_LOGITS_TOL,
                       reduced=False) -> dict:
    """The card's prefill (K4 in f32) against the port's CPU path on the
    same weights: logits of the last position and the KV cache, relative
    to their largest magnitudes."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    cfg, api, model = _serve_model(device, arch, layers=layers,
                                   dtype="float32", reduced=reduced)
    toks = np.random.default_rng(SEED + 1).integers(
        1, cfg.vocab_size, size=(batch, prompt_len)).astype(np.int32)
    before = flash_attention.launches
    logits, cache = api.prefill(model, torch.as_tensor(toks, device=device),
                                cfg, prompt_len + 1)
    launched = flash_attention.launches - before
    logits, cache = logits.cpu(), [c.cpu() for c in cache]
    if device != "cpu" and launched != cfg.num_layers:
        raise AssertionError(f"serve check: K4 launched {launched} times "
                             f"for {cfg.num_layers} layers")
    want, want_cache = api.prefill(model.to("cpu"), torch.as_tensor(toks),
                                   cfg, prompt_len + 1)
    if tuple(logits.shape) != (batch, 1, cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"serve check: logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    err = float((logits - want).abs().max() / want.abs().max())
    cache_err = max(float((c - w).abs().max() / w.abs().max())
                    for c, w in zip(cache, want_cache))
    out = {"arch": cfg.name, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "batch": batch, "prompt_len": prompt_len, "k4_launches": launched,
           "logits_rel_err": err, "cache_rel_err": cache_err, "tol": tol}
    print(f"[serve check] {json.dumps(out)}")
    if err > tol or cache_err > tol:
        raise AssertionError(f"serve check: the card's prefill differs from "
                             f"the CPU path's: {out}")
    return out


def _free(device) -> None:
    """Give the card back what the last model held."""
    import gc
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()


def _sync(device) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def _family_loop(device, cfg, api, model, batch, prompt_len, gen,
                 requests, trace_steps) -> dict:
    """``ServeLoop`` over ``requests`` prompts: every request served in
    full; then a second, one-wave loop on the same weights, whose
    first-wave prefill is the warm one, and with ``trace_steps`` the
    device's idle share over that many of its decode steps."""
    from repro_torch.launch.serve import ServeLoop
    prompts = np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, size=(requests, prompt_len)).astype(np.int32)

    def new_loop(n, gen_):
        loop = ServeLoop(api, cfg, model, batch=batch, prompt_len=prompt_len,
                         gen=gen_, device=None if device == "cuda" else device)
        for r in range(n):
            loop.submit(r, prompts[r])
        t0 = time.perf_counter()
        loop.start()                    # synchronises inside its span
        return loop, (time.perf_counter() - t0) * 1e3

    loop, prefill_ms = new_loop(requests, gen)
    step_ms, more = [], True
    while more:
        t0 = time.perf_counter()
        more = loop.step()              # ends by reading the tokens back
        step_ms.append((time.perf_counter() - t0) * 1e3)
    res = loop.result()
    if (loop.served != requests
            or any(len(v) != gen for v in res["outputs"].values())):
        raise AssertionError(f"families: {cfg.name}: {loop.served} of "
                             f"{requests} requests served in full")
    row = {"batch": batch, "prompt_len": prompt_len, "gen": gen,
           "requests": requests, "prefills": loop.prefills,
           "decode_steps": loop.decode_steps, "prefill_ms": prefill_ms,
           "decode_step_ms_median": float(np.median(step_ms)),
           "tokens_per_s": res["tokens_per_s"],
           # this loop's own requests (the metrics' histogram is shared)
           "latency_p50_s": float(np.percentile(loop.latencies, 50)),
           "latency_max_s": max(loop.latencies),
           "tokens": np.concatenate([np.asarray(v) for v in
                                     res["outputs"].values()])}
    warm, row["prefill_ms_warm"] = new_loop(batch, trace_steps + 1)
    row["prefills"] += warm.prefills
    if trace_steps:
        warm.step()
        busy = _device_busy(lambda: [warm.step()
                                     for _ in range(trace_steps)], device)
        row["traced_decode"] = dict(busy, steps=trace_steps)
    return row


def _family_greedy(device, cfg, api, model, inputs, S_max, start, steps,
                   **kw) -> dict:
    """One prefill of ``inputs`` and ``steps`` greedy decode steps from
    position ``start``, each timed on the host around a synchronise."""
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = api.prefill(model, inputs, cfg, S_max, **kw)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok, tokens, step_ms = logits[:, -1].argmax(-1)[:, None], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        logits, cache = api.decode_step(model, tok, cache, start + i, cfg)
        tok = logits[:, -1].argmax(-1)[:, None]
        tokens.append(tok.cpu().numpy())     # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"families: {cfg.name}: logits not finite")
    total_s = (prefill_ms + sum(step_ms)) / 1e3
    return {"batch": int(tok.shape[0]), "decode_steps": steps,
            "prefills": 1, "prefill_ms": prefill_ms,
            "decode_step_ms_median": float(np.median(step_ms)),
            "tokens_per_s": tok.shape[0] * steps / total_s,
            "tokens": np.concatenate(tokens).ravel()}


def _slstm_launches(device, cfg, model, batch, steps=32) -> float:
    """Device kernels per position of one sLSTM layer's Python loop."""
    from repro_torch.models.ssm import slstm_fwd
    x = torch.randn((batch, steps, cfg.d_model), device=device).to(
        getattr(torch, cfg.dtype))
    slstm = model["pairs"][0]["slstm"]
    slstm_fwd(slstm, x, cfg)
    busy = _device_busy(lambda: slstm_fwd(slstm, x, cfg), device)
    return busy["device_events"] / steps


def phase_families(device="cuda", cells=FAMILY_CELLS, reduced=False,
                   loop=FAMILY_LOOP, vlm=FAMILY_VLM, encdec=FAMILY_ENCDEC,
                   trace_steps=SERVE_TRACE_STEPS) -> list:
    """Every family but the dense one, one model at a time at full width
    in bf16 (``reduced``: the reduced configurations, for a rehearsal):
    MoE + MLA (deepseek-v2-lite, full depth), MoE + GQA (llama4-scout, 2
    of 48 layers), xLSTM and the Mamba2 hybrid (full depth) through
    ``ServeLoop``; internvl2 (2 of 80 layers) through a prefill of patch
    embeddings and tokens; whisper through ``encdec_prefill``.  Each: a
    prefill's and the median decode step's wall ms, tokens/s, the peak
    of allocated device memory, K4's launches against one per decoder
    layer and prefill where its prefill reaches K4 (none otherwise);
    deepseek's device idle share over ``trace_steps`` traced decode
    steps; xLSTM's kernels per sLSTM position."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    rows = []
    for name, arch, layers, how, k4 in cells:
        _free(device)
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        before = flash_attention.launches
        t_cell = time.perf_counter()
        cfg, api, model = _serve_model(device, arch,
                                       layers=None if reduced else layers,
                                       reduced=reduced)
        gen = torch.Generator(device=device).manual_seed(SEED + 2)
        dtype = getattr(torch, cfg.dtype)
        if how == "loop":
            row = _family_loop(device, cfg, api, model,
                               trace_steps=trace_steps
                               if name == FAMILY_TRACED else 0, **loop)
        elif how == "prefix":
            toks = torch.randint(1, cfg.vocab_size,
                                 (vlm["batch"], vlm["prompt_len"]),
                                 generator=gen, device=device)
            patches = 0.02 * torch.randn(
                (vlm["batch"], vlm["prefix"], cfg.d_model), generator=gen,
                device=device)
            start = vlm["prefix"] + vlm["prompt_len"]
            row = _family_greedy(device, cfg, api, model, toks,
                                 start + vlm["steps"], start, vlm["steps"],
                                 prefix_embeds=patches.to(dtype))
            row.update(prefix=vlm["prefix"], prompt_len=vlm["prompt_len"])
        else:
            frames = torch.randn((encdec["batch"], encdec["frames"],
                                  cfg.d_model), generator=gen, device=device)
            toks = torch.randint(1, cfg.vocab_size,
                                 (encdec["batch"], encdec["prompt_len"]),
                                 generator=gen, device=device)
            start = encdec["prompt_len"]
            row = _family_greedy(device, cfg, api, model,
                                 (frames.to(dtype), toks),
                                 start + encdec["steps"] + 1, start,
                                 encdec["steps"])
            row.update(frames=encdec["frames"], prompt_len=start)
        if cfg.family == "ssm":
            row["slstm_kernels_per_position"] = _slstm_launches(
                device, cfg, model, loop["batch"])
        tokens = row.pop("tokens")
        if not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
            raise AssertionError(f"families: {cfg.name}: token ids outside "
                                 f"the vocabulary")
        launched = flash_attention.launches - before
        want = cfg.num_layers * row["prefills"] if k4 else 0
        row = {"cell": name, "arch": cfg.name, "layers": cfg.num_layers,
               "dtype": cfg.dtype, "k4_launches": launched,
               "k4_launches_expected": want, **row,
               "params": sum(p.numel() for p in model.parameters()),
               "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30
               if device != "cpu" else None,
               "seconds": time.perf_counter() - t_cell}
        print(f"[families] {json.dumps(row)}")
        if device != "cpu" and launched != want:
            raise AssertionError(f"families: {name}: K4 launched {launched} "
                                 f"times, expected {want}")
        rows.append(row)
        del model
    _free(device)
    return rows


def _k4_archs() -> set:
    """The architectures whose prefill reaches K4."""
    return {arch for _, arch, _, _, k4 in FAMILY_CELLS if k4}


def _tree_cpu(tree) -> list:
    """Copies of the tree's leaves in f32 on the CPU (a copy even of a
    CPU tensor: decode writes the cache in place)."""
    if isinstance(tree, torch.Tensor):
        return [tree.to("cpu", torch.float32, copy=True)]
    return [leaf for t in tree for leaf in _tree_cpu(t)]


def phase_families_check(device="cuda", checks=FAMILY_CHECKS,
                         prompt_len=128, tol=SERVE_LOGITS_TOL) -> list:
    """Each family on the card against the port's CPU path on the same
    weights, in f32: prefill logits of the last position, every cache or
    state leaf, and one decode step's logits and cache, relative to each
    one's largest magnitude.  Prompts of 128 (internvl2: 64 patch
    embeddings + 64 tokens; whisper: 256 frames), so K4 runs in f32
    where the family reaches it."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    rows = []
    for arch, layers, reduced in checks:
        _free(device)
        cfg, api, model = _serve_model(device, arch, layers=layers,
                                       dtype="float32", reduced=reduced)
        rng = np.random.default_rng(SEED + 3)
        n_tok = prompt_len // 2 if cfg.family == "vlm" else prompt_len
        toks = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, size=(2, n_tok)).astype(np.int32))
        nxt = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, size=(2, 1)).astype(np.int32))
        kw = {}
        if cfg.enc_dec:
            toks = (torch.from_numpy(rng.normal(size=(2, 256, cfg.d_model))
                                     .astype(np.float32)), toks)
        elif cfg.family == "vlm":
            kw["prefix_embeds"] = torch.from_numpy(0.02 * rng.normal(
                size=(2, prompt_len - n_tok, cfg.d_model)).astype(np.float32))

        def run(dev):
            inp = (tuple(t.to(dev) for t in toks) if cfg.enc_dec
                   else toks.to(dev))
            lg, cache = api.prefill(model, inp, cfg, prompt_len + 2,
                                    **{k: v.to(dev) for k, v in kw.items()})
            out = _tree_cpu((lg, cache))
            lg, cache = api.decode_step(model, nxt.to(dev), cache,
                                        prompt_len, cfg)
            return out + _tree_cpu((lg, cache))

        before = flash_attention.launches
        got = run(device)
        launched = flash_attention.launches - before
        expect = cfg.num_layers if arch in _k4_archs() else 0
        model.to("cpu")
        want = run("cpu")
        errs = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
                for g, w in zip(got, want, strict=True)]
        n_leaves = len(got) // 2 - 1
        row = {"arch": cfg.name, "layers": cfg.num_layers,
               "width": "reduced" if reduced else "full", "dtype": cfg.dtype,
               "prompt_len": prompt_len, "k4_launches": launched,
               "k4_launches_expected": expect,
               "prefill_logits_rel_err": errs[0],
               "prefill_cache_rel_err": max(errs[1:1 + n_leaves]),
               "decode_logits_rel_err": errs[1 + n_leaves],
               "decode_cache_rel_err": max(errs[2 + n_leaves:]),
               "tol": tol}
        print(f"[families check] {json.dumps(row)}")
        finite = all(torch.isfinite(g).all() for g in got)
        if device != "cpu" and launched != expect:
            raise AssertionError(f"families check: {cfg.name}: K4 launched "
                                 f"{launched} times, expected {expect}")
        if not finite or max(errs) > tol:
            raise AssertionError(f"families check: the card differs from "
                                 f"the CPU path: {row}")
        rows.append(row)
        del model
    _free(device)
    return rows


def _k4_applications(cfg, S: int) -> int:
    """K4 launches of one forward pass of ``cfg``'s training loss on the
    card at self-attention length ``S``: each causal self-attention with
    no window, no MLA, a head dim K4 takes and S % 128 == 0 (the
    hybrid's shared block once per super-block; whisper's decoder, not
    its non-causal encoder)."""
    from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
    if (cfg.mla or cfg.family == "ssm" or cfg.attn_window or S % 128
            or cfg.head_dim not in HEAD_DIMS):
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid.period
    return cfg.num_layers


def _train_trace_detail(prof) -> dict:
    """K4's device ms and kernels, and the device ms of the kernels
    launched under the backward of its autograd Function (plain
    PyTorch; the host-side ranges), in one traced step."""
    from repro_torch.kernels.flash_attention.ops import BACKWARD_RANGE
    k4 = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and ("wg_kernel" in e.name or "fma_kernel" in e.name)]
    bwd = [e for e in prof.events() if e.name == BACKWARD_RANGE
           and e.device_type == torch.autograd.DeviceType.CPU]
    dev_us = [e.device_time_total if hasattr(e, "device_time_total")
              else e.cuda_time_total for e in bwd]
    return {"k4_device_ms": sum(e.time_range.elapsed_us() for e in k4) / 1e3,
            "k4_kernels": len(k4),
            "attention_backward_device_ms": sum(dev_us) / 1e3,
            "attention_backward_ranges": len(bwd)}


def phase_train(device="cuda", arch=TRAIN["arch"], reduced=False,
                batch=TRAIN["batch"], seq=TRAIN["seq"],
                steps=TRAIN["steps"]) -> dict:
    """LM training through the CLI (``launch/train.main``): ``arch`` with
    random seeded weights, ``steps`` steps of ``batch`` x ``seq`` tokens,
    remat "full", no checkpoints.  The loss must be finite and the mean
    of the last 5 below the first 5's minus 0.1 (the JAX package's
    contract); K4 launches twice a layer and step on the card (the
    forward and its recompute).  First-step and median warm-step ms,
    tokens/s, peak allocated memory and ``train_mfu``: 6 x parameters x
    tokens plus causal attention (3 x 4 B H D S(S+1)/2 a layer: forward
    and backward, no recompute) over the warm step and the bf16 dense
    peak.  Then one traced warm step of a second model: the device's
    idle share, K4's device ms and the backward attention's.  Then the
    restart contract on the reduced configuration (``TRAIN_RESTART``):
    ``steps`` with a checkpoint every ``every``, the same command to
    ``resume_to``: it runs the steps left, and its last loss is below
    the first run's first."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import train
    from repro_torch.launch.steps import abstract_params, make_train_step
    from repro_torch.models import get_api
    from repro_torch.optim import adamw_init
    cfg = get_config(arch, reduced=reduced)
    on_card = device != "cpu"
    dev_args = [] if device == "cuda" else ["--device", str(device)]
    per_step = 2 * _k4_applications(cfg, seq) if on_card else 0
    _free(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = flash_attention.launches
    t0 = time.perf_counter()
    out = train.main(["--arch", arch, "--steps", str(steps), "--batch",
                      str(batch), "--seq", str(seq), "--log-every", "10",
                      "--mesh", "none"]
                     + (["--reduced"] if reduced else []) + dev_args)
    wall = time.perf_counter() - t0
    launched = flash_attention.launches - before
    losses = np.asarray(out["losses"])
    step_ms = np.asarray(out["step_s"]) * 1e3
    warm_ms = float(np.median(step_ms[1:]))
    tokens = batch * seq
    n_params = sum(p.numel() for p in abstract_params(cfg)[0].parameters())
    attn = 3 * cfg.num_layers * 4 * batch * cfg.num_heads * cfg.head_dim \
        * seq * (seq + 1) / 2
    flops = 6 * n_params * tokens + attn
    row = {"arch": cfg.name, "device": torch.cuda.get_device_name(0)
           if on_card else "cpu", "dtype": cfg.dtype,
           "layers": cfg.num_layers, "params": n_params, "batch": batch,
           "seq": seq, "steps": steps, "remat": "full",
           "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
           "first5_mean": float(losses[:5].mean()),
           "last5_mean": float(losses[-5:].mean()),
           "first_step_ms": float(step_ms[0]), "warm_step_ms_median": warm_ms,
           "warm_step_ms_max": float(step_ms[1:].max()),
           "tokens_per_s": tokens / warm_ms * 1e3,
           "model_tflop_per_step": flops / 1e12,
           "train_mfu": flops / (warm_ms / 1e3) / PEAK_OPS[torch.bfloat16],
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30
           if on_card else None,
           "k4_launches": launched, "k4_launches_expected": per_step * steps,
           "stragglers": len(out["stragglers"]), "wall_s": wall}
    print(f"[train] {json.dumps(row)}")
    if not np.isfinite(losses).all() or len(losses) != steps:
        raise AssertionError(f"train: {len(losses)} losses, finite "
                             f"{bool(np.isfinite(losses).all())}")
    if not row["last5_mean"] < row["first5_mean"] - 0.1:
        raise AssertionError(f"train: the loss did not fall: {row}")
    if launched != per_step * steps:
        raise AssertionError(f"train: K4 launched {launched} times, "
                             f"expected {per_step} a step x {steps}")
    _free(device)
    model = get_api(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    opt = adamw_init(model)
    step = make_train_step(cfg, lr=1e-3)
    pipe = make_pipeline(cfg, seq, batch, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in next(pipe).items()} for _ in range(3)]
    before = flash_attention.launches
    for b in batches[:2]:               # warm
        float(step(model, opt, b)[2]["loss"])
    row["traced_step"] = _device_busy(
        lambda: float(step(model, opt, batches[2])[2]["loss"]), device,
        detail=_train_trace_detail)
    traced = flash_attention.launches - before
    print(f"[train] traced warm step {json.dumps(row['traced_step'])}")
    if traced != 3 * per_step:
        raise AssertionError(f"train: K4 launched {traced} times in 3 "
                             f"steps, expected {3 * per_step}")
    del model, opt
    _free(device)
    restart = TRAIN_RESTART
    ck = _root() / "chiprun_out" / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    base = ["--arch", arch, "--reduced", "--batch", str(restart["batch"]),
            "--seq", str(restart["seq"]), "--ckpt-dir", str(ck),
            "--ckpt-every", str(restart["every"]), "--mesh", "none"] + dev_args
    before = flash_attention.launches
    first = train.main(base + ["--steps", str(restart["steps"])])
    second = train.main(base + ["--steps", str(restart["resume_to"])])
    shutil.rmtree(ck, ignore_errors=True)
    left = restart["resume_to"] - restart["steps"]
    small = get_config(arch, reduced=True)
    want = (2 * _k4_applications(small, restart["seq"]) * restart["resume_to"]
            if on_card else 0)
    row["restart"] = {"first_losses": first["losses"],
                      "resumed_losses": second["losses"],
                      "k4_launches": flash_attention.launches - before,
                      "k4_launches_expected": want}
    print(f"[train] restart {json.dumps(row['restart'])}")
    if len(second["losses"]) != left \
            or not second["losses"][-1] < first["losses"][0]:
        raise AssertionError(f"train: the restart did not resume: "
                             f"{row['restart']}")
    if row["restart"]["k4_launches"] != want:
        raise AssertionError(f"train: restart K4 launches {row['restart']}")
    return row


#: the dry-run phase's cells: (arch, shape, mesh); qwen2's must be ok
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", "single"),
                ("qwen2-0.5b", "prefill_32k", "single"),
                ("qwen2-0.5b", "decode_32k", "single"),
                ("qwen2-0.5b", "train_4k", "multi"),
                ("deepseek-v2-lite-16b", "train_4k", "single"))
#: the mesh-train phase: the train CLI at full width, cut in depth, f32
MESH_TRAIN = dict(arch="qwen2-0.5b", layers=2, dtype="float32", batch=2,
                  seq=512, steps=3)
#: the compression phase: draws of one leaf for the bias
COMPRESS_DRAWS = 30


def _dryrun_cell(cell_and_overrides) -> dict:
    """One dry-run cell in a process of its own (the fake process group
    is per process)."""
    (arch, shape, mesh), overrides = cell_and_overrides
    sys.path.insert(0, str(_root() / "src"))
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, mesh, verbose=False,
                          cfg_overrides=overrides)
    rec.pop("trace", None)
    return rec


def phase_dryrun(cells=DRYRUN_CELLS, cfg_overrides=None) -> list:
    """The dry run of ``cells``, each in its own process, all at once,
    on the CPU: the fake process group of the mesh's
    ranks, DTensors on the meta device.  Prints each cell's per-rank dot
    FLOPs and bytes, collective GiB by kind, peak bytes, seconds and its
    roofline; qwen2-0.5b's cells must be ``ok``."""
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import roofline
    t0 = time.perf_counter()
    with ProcessPoolExecutor(len(cells),
                             mp_context=mp.get_context("spawn")) as ex:
        recs = list(ex.map(_dryrun_cell,
                           [(c, cfg_overrides) for c in cells]))
    rows = []
    for rec in recs:
        row = {k: rec.get(k) for k in ("arch", "shape", "mesh", "ranks",
                                       "status", "dot_flops", "dot_bytes",
                                       "world1_dot_flops", "gathered_ops",
                                       "where", "error")}
        if rec["status"] == "ok":
            row["collective_gib"] = {
                k: v / 2 ** 30 for k, v in rec["collectives"].items()
                if k != "count" and v}
            row["collective_count"] = rec["collectives"]["count"]
            row["peak_bytes"] = rec["memory"]["peak_bytes"]
            row["argument_bytes"] = rec["memory"]["argument_bytes"]
            row["seconds"] = rec["place_s"] + rec["run_s"]
            row["replicated_flops_share"] = (
                1 - rec["world1_dot_flops"]
                / (rec["dot_flops"] * rec["ranks"])
                if rec["world1_dot_flops"] else None)
            row["roofline"] = roofline.cell_roofline(rec)
        row["error"] = (row["error"] or "")[:300] or None
        print(f"[dryrun] {json.dumps(row)}")
        rows.append(row)
    bad = [r for r in rows if r["arch"] == "qwen2-0.5b"
           and r["status"] != "ok"]
    if bad:
        raise AssertionError(f"dryrun: qwen2 cells not ok: {bad}")
    for r in rows:
        if r["status"] == "ok" and r["world1_dot_flops"] and \
                r["dot_flops"] * r["ranks"] < r["world1_dot_flops"]:
            raise AssertionError(f"dryrun: per-rank FLOPs x ranks below "
                                 f"the world-1 count: {r}")
    print(f"[dryrun] {len(rows)} cells in "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


def phase_counted_step(device="cuda", arch=TRAIN["arch"],
                       batch=TRAIN["batch"], seq=TRAIN["seq"],
                       reduced=False) -> dict:
    """One warm step of phase 14's training cell counted on the card by
    ``CostMode`` and at world size 1 on the meta device
    (``dryrun.world1_costs``).  Attention is K4 on the card (counted by
    its formula) and its plain-PyTorch backward, batched products on
    meta: with ``flash_attention`` and ``bmm`` taken out of both, the
    dot FLOPs and bytes must be equal.  The roofline bound of the card's
    count (its dot FLOPs over the bf16 peak, its dot bytes over HBM)
    against the measured warm step."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch.costanalysis import CostMode
    from repro_torch.launch.steps import ShapeSpec, make_train_step
    from repro_torch.models import get_api
    from repro_torch.optim import adamw_init
    cfg = get_config(arch, reduced=reduced)
    on_card = device != "cpu"
    _free(device)
    model = get_api(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    opt = adamw_init(model)
    step = make_train_step(cfg, lr=1e-3)
    pipe = make_pipeline(cfg, seq, batch, seed=SEED)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in next(pipe).items()} for _ in range(4)]
    for b in batches[:2]:                                 # warm
        float(step(model, opt, b)[2]["loss"])
    _sync(device)
    t0 = time.perf_counter()
    float(step(model, opt, batches[2])[2]["loss"])
    _sync(device)
    warm_ms = (time.perf_counter() - t0) * 1e3
    before = flash_attention.launches
    with CostMode() as cm:
        float(step(model, opt, batches[3])[2]["loss"])
    launched = flash_attention.launches - before
    card = cm.costs
    meta = dryrun.world1_costs(cfg, ShapeSpec("train", "train", seq, batch))
    attn_card = ("flash_attention", "bmm")
    f_card, b_card = card.without(*attn_card)
    f_meta, b_meta = meta.without("bmm")
    bound_s = max(card.dot_flops / roofline.PEAK_FLOPS,
                  card.dot_bytes / roofline.HBM_BW)
    row = {"arch": cfg.name, "batch": batch, "seq": seq,
           "card": {"dot_flops": card.dot_flops, "dot_bytes": card.dot_bytes,
                    "by_op": {k: v for k, v in card.by_op.items()}},
           "meta": {"dot_flops": meta.dot_flops, "dot_bytes": meta.dot_bytes,
                    "by_op": {k: v for k, v in meta.by_op.items()}},
           "no_attention": {"card": [f_card, b_card],
                            "meta": [f_meta, b_meta]},
           "k4_launches": launched, "warm_step_ms": warm_ms,
           "bound_ms": bound_s * 1e3,
           "measured_over_bound": warm_ms / (bound_s * 1e3)}
    print(f"[counted] {json.dumps(row)}")
    want = 2 * _k4_applications(cfg, seq) if on_card else 0
    if launched != want:
        raise AssertionError(f"counted: K4 launched {launched}, want {want}")
    if on_card and "flash_attention" not in card.by_op:
        raise AssertionError("counted: K4 was not counted on the card")
    if (f_card, b_card) != (f_meta, b_meta):
        raise AssertionError(f"counted: the card's count without attention "
                             f"{(f_card, b_card)} differs from the meta "
                             f"device's {(f_meta, b_meta)}")
    del model, opt
    _free(device)
    return row


def phase_mesh_train(device="cuda", cell=MESH_TRAIN) -> dict:
    """The train CLI on the one-rank (1, 1) ``DeviceMesh`` (NCCL on the
    card) against the same steps with no mesh: the losses within 1e-6
    and K4 launched as often.  Then the mesh run's checkpoint restored
    with ``shardings=`` onto the mesh (the CLI's resume) and one more
    step.  Step ms of both."""
    import shutil
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import train
    ck = _root() / "chiprun_out" / "mesh_train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    def base(steps):
        return (["--arch", cell["arch"], "--layers", str(cell["layers"]),
                 "--dtype", cell["dtype"], "--batch", str(cell["batch"]),
                 "--seq", str(cell["seq"]), "--steps", str(steps),
                 "--log-every", "1"]
                + ([] if device == "cuda" else ["--device", str(device)]))

    runs = {}
    for mesh in ("none", "debug"):
        _free(device)
        before = flash_attention.launches
        extra = ["--ckpt-dir", str(ck)] if mesh == "debug" else []
        out = train.main(base(cell["steps"]) + ["--mesh", mesh] + extra)
        runs[mesh] = {"losses": out["losses"],
                      "step_ms": [t * 1e3 for t in out["step_s"]],
                      "k4_launches": flash_attention.launches - before}
    before = flash_attention.launches
    resumed = train.main(base(cell["steps"] + 1)
                         + ["--mesh", "debug", "--ckpt-dir", str(ck)])
    shutil.rmtree(ck, ignore_errors=True)
    diff = max(abs(a - b) for a, b in zip(runs["none"]["losses"],
                                          runs["debug"]["losses"]))
    row = {"cell": cell, "runs": runs, "max_loss_diff": diff,
           "resumed_losses": resumed["losses"],
           "resumed_k4_launches": flash_attention.launches - before}
    print(f"[mesh_train] {json.dumps(row)}")
    if diff > 1e-6:
        raise AssertionError(f"mesh_train: losses differ by {diff}")
    if runs["none"]["k4_launches"] != runs["debug"]["k4_launches"]:
        raise AssertionError(f"mesh_train: K4 launches differ: {runs}")
    if len(resumed["losses"]) != 1 or not np.isfinite(resumed["losses"][0]):
        raise AssertionError(f"mesh_train: the resharded restore did not "
                             f"step: {resumed}")
    return row


def phase_compression(device="cuda", arch=TRAIN["arch"],
                      batch=TRAIN["batch"], seq=TRAIN["seq"], reduced=False,
                      draws=COMPRESS_DRAWS) -> dict:
    """``compressed_grad_allreduce`` on a one-rank group (NCCL on the
    card) over the full gradient tree of one backward of phase 14's cell,
    the leaves in f32: every leaf within 1.01 quanta (amax / 127), and
    the mean of ``draws`` draws of the largest leaf within 0.2 quanta of
    it (its mean absolute bias).  ms of the compressed reduce against a
    plain ``all_reduce`` of the same tree."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch.steps import make_loss_fn
    from repro_torch.models import get_api
    from repro_torch.runtime import compressed_grad_allreduce
    cfg = get_config(arch, reduced=reduced)
    _free(device)
    model = get_api(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device)
    batch_t = {k: torch.from_numpy(v).to(device) for k, v in
               next(make_pipeline(cfg, seq, batch, seed=SEED)).items()}
    model.requires_grad_(True)
    make_loss_fn(cfg)(model, batch_t).backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    del model
    _free(device)
    backend = "nccl" if device != "cpu" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh(torch.device(device).type, (1, 1),
                                mesh_dim_names=("data", "model"))
        gen = torch.Generator(device=device).manual_seed(SEED)
        compressed_grad_allreduce(grads, mesh, generator=gen)   # warm
        _sync(device)
        t0 = time.perf_counter()
        out = compressed_grad_allreduce(grads, mesh, generator=gen)
        _sync(device)
        comp_ms = (time.perf_counter() - t0) * 1e3

        def plain():
            res = {n: g.clone() for n, g in grads.items()}
            for g in res.values():
                dist.all_reduce(g)
            return res

        plain()
        _sync(device)
        t0 = time.perf_counter()
        plain()
        _sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        worst = max(float((out[n] - g).abs().max())
                    / max(float(g.abs().max()) / 127.0, 1e-30)
                    for n, g in grads.items())
        name = max(grads, key=lambda n: grads[n].numel())
        g = grads[name]
        acc = torch.zeros_like(g, dtype=torch.float64)
        for i in range(draws):
            acc += compressed_grad_allreduce(
                [g], mesh, generator=torch.Generator(device=device)
                .manual_seed(i))[0].double() / draws
        bias = float((acc - g.double()).abs().mean()) / (
            float(g.abs().max()) / 127.0)
    finally:
        dist.destroy_process_group()
    row = {"leaves": len(grads), "elements": sum(g.numel()
                                                 for g in grads.values()),
           "worst_error_quanta": worst, "bias_leaf": name,
           "bias_quanta": bias, "draws": draws, "compressed_ms": comp_ms,
           "plain_allreduce_ms": plain_ms}
    print(f"[compression] {json.dumps(row)}")
    if worst > 1.01:
        raise AssertionError(f"compression: a leaf is {worst} quanta off")
    if bias >= 0.2:
        raise AssertionError(f"compression: bias {bias} quanta")
    return row


def _loss_and_grads(model, cfg, np_batch, device) -> tuple:
    """(loss, gradients copied to the CPU) of ``model`` on ``device``."""
    from repro_torch.launch.steps import make_loss_fn
    batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()}
    model.requires_grad_(True)
    loss = make_loss_fn(cfg)(model, batch)
    loss.backward()
    return float(loss.detach()), {n: p.grad.to("cpu", copy=True)
                                  for n, p in model.named_parameters()}


def _adamw_step(model, grads, lr: float) -> dict:
    """The parameters of ``model`` after one AdamW step from zero moments
    with ``grads`` (copied to its device), copied to the CPU."""
    from repro_torch.optim import adamw_init, adamw_update
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    adamw_update({n: g.to(dev) for n, g in grads.items()},
                 adamw_init(model), params, lr=lr)
    return {n: p.detach().to("cpu", copy=True) for n, p in params.items()}


def phase_train_check(device="cuda", checks=TRAIN_CHECKS) -> list:
    """Training on the card against the port's CPU path on the same
    weights and batch (numpy from a seed), in f32: the loss (relative)
    and every gradient, then every parameter after one AdamW step from
    zero moments with the same (the CPU's) gradients on both (relative
    to each leaf's largest magnitude).  The step takes one gradient on
    both because Adam's first step is g / (|g| + 1e-8), a sign for most
    elements: a gradient difference of 1e-6 at an element near 1e-8
    moves it by up to lr (measured 1.7e-3 of ``mlp.wo``'s largest
    magnitude at qwen2-0.5b's full width).  Sequences of 128 (internvl2:
    256 patch embeddings before them; whisper: 64 frames), so K4 runs in
    f32 wherever a family reaches it, twice a layer (forward,
    recompute)."""
    import copy
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.steps import VLM_PATCHES
    rows = []
    shape, lr = TRAIN_CHECK_SHAPE, 1e-3
    B, S = shape["batch"], shape["seq"]
    for arch, layers, reduced in checks:
        _free(device)
        cfg, _, model = _serve_model(device, arch, layers=layers,
                                     dtype="float32", reduced=reduced)
        rng = np.random.default_rng(SEED + 4)

        def ints():
            return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(
                np.int32)

        nb, S_attn = {"targets": ints()}, S
        if cfg.enc_dec:
            nb["frames"] = rng.normal(
                size=(B, shape["frames"], cfg.d_model)).astype(np.float32)
            nb["dec_tokens"] = ints()
        else:
            nb["tokens"] = ints()
            if cfg.frontend == "vision_stub":
                nb["patches"] = 0.02 * rng.normal(
                    size=(B, VLM_PATCHES, cfg.d_model)).astype(np.float32)
                S_attn += VLM_PATCHES
        cpu_model = copy.deepcopy(model).to("cpu")
        before = flash_attention.launches
        loss, grads = _loss_and_grads(model, cfg, nb, device)
        launched = flash_attention.launches - before
        want_loss, want_grads = _loss_and_grads(cpu_model, cfg, nb, "cpu")
        stepped = _adamw_step(model, want_grads, lr)
        want_params = _adamw_step(cpu_model, want_grads, lr)
        expect = 2 * _k4_applications(cfg, S_attn) if device != "cpu" else 0

        def worst(a, b):
            errs = {n: float((a[n] - w).abs().max()
                             / w.abs().max().clamp_min(1e-30))
                    for n, w in b.items()}
            name = max(errs, key=errs.get)
            return errs[name], name

        grad_err, grad_leaf = worst(grads, want_grads)
        param_err, param_leaf = worst(stepped, want_params)
        row = {"arch": cfg.name, "layers": cfg.num_layers,
               "width": "reduced" if reduced else "full", "batch": B,
               "seq": S_attn, "k4_launches": launched,
               "k4_launches_expected": expect, "loss": loss,
               "loss_rel_err": abs(loss - want_loss) / abs(want_loss),
               "grad_rel_err": grad_err, "grad_worst_leaf": grad_leaf,
               "param_rel_err": param_err, "param_worst_leaf": param_leaf,
               "tol": [TRAIN_LOSS_TOL, TRAIN_GRAD_TOL]}
        print(f"[train check] {json.dumps(row)}")
        finite = all(bool(torch.isfinite(g).all())
                     for tree in (grads, stepped) for g in tree.values())
        if device != "cpu" and launched != expect:
            raise AssertionError(f"train check: {cfg.name}: K4 launched "
                                 f"{launched} times, expected {expect}")
        if (not finite or row["loss_rel_err"] > TRAIN_LOSS_TOL
                or grad_err > TRAIN_GRAD_TOL or param_err > TRAIN_GRAD_TOL):
            raise AssertionError(f"train check: the card differs from the "
                                 f"CPU path: {row}")
        rows.append(row)
        del model, cpu_model
    _free(device)
    return rows


def phase_agreement(device="cuda", configs=("qwen2-0.5b",),
                    reduced=False, reps=5, cells=QWEN2_CELLS) -> list:
    """``validate_fleet`` with all five arms on ``device``."""
    from repro_torch.fleet.validate import (ALL_ARMS, agreement_summary,
                                            validate_fleet)
    rows = validate_fleet(configs, reduced=reduced, batch=8,
                          arms=ALL_ARMS, reps=reps,
                          device=None if device == "cuda" else device)
    got = sorted({(r.layer, r.M, r.K, r.N) for r in rows})
    if cells is not None and got != sorted(cells):
        raise AssertionError(f"agreement cells {got}, expected {cells}")
    if len(rows) != len(ALL_ARMS) * len(got):
        raise AssertionError(f"{len(rows)} agreement rows for {len(got)} "
                             f"cells")
    for r in rows:
        print(f"[agreement] {json.dumps(r.as_dict())}")
        if r.arm == "nm-correct" and not r.measured < 1e-3:
            raise AssertionError(f"nm_spmm error {r.measured:.3e} on "
                                 f"{r.layer}")
    print(agreement_summary(rows))
    return rows


#: (name, what, replaces, source, headline cell)
KERNELS = (
    ("skip_mm", "K1 SKIP block-sparse matmul (narrow path on the CUDA "
     "cores at M <= 32 and f32, wide bf16 path on the tensor cores "
     "(mma.sync); each column's run of nonzero blocks split into K-slices "
     "reduced in a fixed order inside a cluster)",
     "src/repro/kernels/block_mm/kernel.py:95",
     "src/repro_torch/kernels/block_mm/csrc/block_mm.cu", "lm_head"),
    ("gated_mm", "K2 GATE block-sparse matmul (K1's paths and split over "
     "every k block; every tile copied, only the products under the mask)",
     "src/repro/kernels/block_mm/kernel.py:49",
     "src/repro_torch/kernels/block_mm/csrc/block_mm.cu", "lm_head"),
    ("nm_spmm", "K3 N:M structured-sparse matmul (2:4, int8 offsets; "
     "packed offsets in cells; narrow path on the CUDA cores at M <= 32 "
     "and f32, wide bf16 path on the tensor cores (mma.sync); split K "
     "reduced in a fixed order inside a cluster)",
     "src/repro/kernels/nm_spmm/kernel.py:66",
     "src/repro_torch/kernels/nm_spmm/csrc/nm_spmm.cu", "lm_head"),
    ("flash_attention", "K4 flash attention (causal SKIP at the diagonal; "
     "GQA by head sharing; bf16: wgmma on the tensor cores fed by a TMA "
     "ring; f32: FMA)",
     "src/repro/kernels/flash_attention/kernel.py:76",
     "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
     "serve_prefill"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(_root() / "src"))
    from repro_torch.kernels.block_mm import ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.nm_spmm import ops as nm_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    t_start = time.perf_counter()
    build = phase_build()
    build["k1_k2_variants"] = block_mm_variants(ops.LIBRARY.log)
    build["k4_variants"] = k4_variants(fa_ops.LIBRARY.log)
    build["k3_variants"] = nm_variants(nm_ops.LIBRARY.log)
    kernel_rows = phase_kernels()
    kernel_rows["nm_spmm"] = phase_nm_kernels()
    kernel_rows["flash_attention"] = phase_flash_kernels()

    # ---- the main path: each phase's counters from 0, read right after
    counters = {"skip_mm": ops.skip_mm, "gated_mm": ops.gated_mm,
                "nm_spmm": nm_ops.nm_spmm,
                "flash_attention": fa_ops.flash_attention}
    per_phase: dict = {}

    def main_path(name, fn):
        for wrapper in counters.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        out = fn()
        per_phase[name] = {k: w.launches for k, w in counters.items()}
        per_phase[name]["seconds"] = time.perf_counter() - t0
        return out

    model = main_path("model", phase_model)
    search = main_path("search", phase_search)
    fused = main_path("fused", lambda: phase_fused(
        host_production=search["production"]))
    hybrid = main_path("hybrid", phase_hybrid)
    service = main_path("service", phase_service)
    validation = main_path("validation", phase_validation)
    fleet = main_path("fleet", phase_fleet)
    rows = main_path("agreement", phase_agreement)
    serve = main_path("serve", phase_serve)
    families = main_path("families", phase_families)
    train = main_path("train", phase_train)
    dryrun = main_path("dryrun", phase_dryrun)
    counted = main_path("counted", phase_counted_step)
    mesh_train = main_path("mesh_train", phase_mesh_train)
    compression = main_path("compression", phase_compression)
    launches = {k: sum(p[k] for p in per_phase.values()) for k in counters}
    print(f"[main path] launches per phase {json.dumps(per_phase)}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    disagree = [r.as_dict() for r in rows if not r.agree]
    serve_check = phase_serve_logits()
    families_check = phase_families_check()
    train_check = phase_train_check()
    profile = phase_profile()

    kernels = []
    for name, what, replaces, source, cell in KERNELS:
        head = next(r for r in kernel_rows[name] if r["cell"] == cell
                    and not r.get("packed"))
        kernels.append({
            "name": name, "what": what, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in kernel_rows[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "headline_cell": cell,
            "cells": kernel_rows[name]})
    summary = {"build_s": build["seconds"],
               "k1_k2_variants": build["k1_k2_variants"],
               "k4_variants": build["k4_variants"],
               "k3_variants": build["k3_variants"], "model": model,
               "search": search, "fused": fused, "hybrid": hybrid,
               "service": service, "validation": validation,
               "fleet": fleet, "serve": serve,
               "serve_check": serve_check, "families": families,
               "families_check": families_check, "train": train,
               "dryrun": dryrun, "counted": counted,
               "mesh_train": mesh_train, "compression": compression,
               "train_check": train_check, "profile": profile,
               "main_path": per_phase,
               "agreement": [r.as_dict() for r in rows],
               "disagreements": disagree,
               "total_s": time.perf_counter() - t_start}
    out_dir = _root() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "kernels": kernels, **summary}, indent=1))
    print(f"[summary] {json.dumps(summary)}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
