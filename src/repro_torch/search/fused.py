"""Device-resident fused ES: one generation as one captured CUDA graph.

The host search loop (``runner.run_search``) pays a host<->device round
trip per generation: numpy ask/tell in ``strategies.py``, a host-side
``decode_bucketed``, one batched evaluation whose few thousand small
kernels are each launched from Python, then argsort and archive upkeep
back on the host.  Everything the cost model consumes is already device
data (``ArchParams`` rows, ``WorkloadParams`` leaves, bucket-relative
rank ids), so nothing in that loop needs the host: this module runs the
ES generation step (tournament selection, factor-swap crossover,
per-gene mutation, immigrants, the ``(mu+lambda)`` survivor fold) as
tensor operations on integer genome arrays, decodes genomes to bucket
bounds and rank ids with gathers and exact float64 products, calls the
shared batched program through ``BucketedModel.traced_single`` (the
same program the host path runs, so the model cannot drift), and
writes each generation's outputs into a device buffer.

On the CUDA card one generation is captured once as a
``torch.cuda.CUDAGraph`` per program (after one eager warm-up
generation on scratch state, which fills every cached device tensor),
and a chunk of ``L`` generations is ``L`` replays with no host
synchronization, then one device-to-host copy of the chunk's outputs.
A capture or replay that fails raises: there is no eager fallback on
the card.  On the CPU (``device="cpu"``) the same step runs eagerly.

Measurement: each capture observes the graph's kernel-node count on the
always-on histogram ``fused.graph_kernels``, and a capture whose program
evaluates a tensor of a kind past the JAX package's (``causal``,
``causal_topk``, ``causal_block_topk``) also on
``fused.graph_kernels.<kind>``; with
tracing on (``obs.enable()`` / ``REPRO_TRACE``) each chunk's
``engine.eval`` span carries ``device_s``, the replays' time on the
device's own clock (two CUDA events around them, read after the chunk's
readback), ``generations`` and ``density_kinds``, the sorted names of the
density kinds the program's workload holds.

Randomness is counter-based: every draw is a hash of (seed, generation
index, draw stream, element index), computed with 32-bit integer
arithmetic in int64 tensors, so it lives on the device, is safe to
capture, and depends on the seed and the generation alone, never on
the chunking (chunk invariance holds by construction) — and the CPU
and the card draw the same numbers.  A generation's draws are hashed in
one pass (``FusedProgram._draws``): the carried key is mixed once, the
eight stream keys in one mix, and every stream's counters in one
tensor, so each draw is the hash it would be with its stream alone.

Hybrid ES+SGD: for co-search genomes (``CoSearchEncoding``) the step
optionally takes a Lamarckian gradient step on the design genes after
each evaluation — ``torch.autograd.grad`` of the smooth surrogate loss
(``core.batched.surrogate_loss``) with respect to the decoded knob
values, a log-space step, then a snap back to the nearest knob step.
The hard validity mask still gates fitness, and the emitted
per-generation outputs describe the evaluated (pre-nudge) genomes, so
the archive and the scalar-oracle walk stay consistent; nudged genomes
enter the survivor fold with their parent's fitness and are
re-evaluated when selection picks them.

Reproducibility contract: a fused run is bit-reproducible from its seed
(same seed => identical trajectory, whatever the chunking), but it is
not genome-for-genome identical to the host loop — both implement the
same (mu+lambda) ES, with different random streams.  Its winner is
re-validated through the scalar oracle, as host winners are.
"""
from __future__ import annotations

import ctypes
import threading
import time

import numpy as np
import torch

from .. import obs
from ..core import compile_stats
from ..core.arch import COMPUTE_FIELDS, STORAGE_FIELDS, pack_arch_params
from ..core.density import ACTUAL_ID, MODEL_KINDS
from ..core.batched import (BucketedModel, DeviceLeaves, _ProgramRecord,
                            _device_arch_rows, register_cache_clearer,
                            surrogate_loss)
from .encoding import (COMPUTE_KNOB_LEVEL, CoSearchEncoding,
                       MapspaceEncoding, TopologyCoSearchEncoding,
                       generator)
from .log import GenerationRecord, SearchLog
from .strategies import EvolutionStrategy, init_population

#: per-generation outputs, in emit order
YS_FIELDS = ("fitness", "cycles", "energy_pj", "edp", "valid", "genomes")
#: per-generation outputs in device-archive (``archive_k``) mode —
#: reduced scalars; the population-sized rows stay on the device in the
#: carried top-K buffer
YS_TOPK_FIELDS = ("best_fitness", "best_cycles", "best_energy_pj",
                  "best_edp", "valid_count")

_M32 = 0xFFFFFFFF
#: the carry's tensors, in order (the last two only with ``archive_k``)
_CARRY = ("key", "pop", "fit", "pending", "afit", "agen")
#: draw streams of one generation (each hashes to its own sequence)
_TOURNAMENT_A, _TOURNAMENT_B, _CROSS, _PICK, _FLIP, _FORCED, _FRESH, \
    _IMMIGRANT = range(8)


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` with no
    intermediate above 2**49 (the multiplier in 16-bit halves)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit integer finalizer (the "lowbias32" constants) on int64
    tensors holding values in ``[0, 2**32)``."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _kernel_nodes(raw_graph: int) -> int | None:
    """Kernel nodes of a captured ``cudaGraph_t``, counted through the
    CUDA runtime library this process has loaded; None where none is
    loaded or a call fails."""
    with open("/proc/self/maps") as maps:
        lib = next((line.split()[-1] for line in maps
                    if "/libcudart.so" in line), None)
    if lib is None:
        return None
    runtime = ctypes.CDLL(lib)
    nodes_of = runtime.cudaGraphGetNodes
    type_of = runtime.cudaGraphNodeGetType
    nodes_of.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.POINTER(ctypes.c_size_t)]
    type_of.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    nodes_of.restype = type_of.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    if nodes_of(raw_graph, None, ctypes.byref(n)):
        return None
    nodes = (ctypes.c_void_p * n.value)()
    if nodes_of(raw_graph, nodes, ctypes.byref(n)):
        return None
    kind, kernels = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        if type_of(node, ctypes.byref(kind)):
            return None
        kernels += kind.value == 0      # cudaGraphNodeTypeKernel
    return kernels


def fused_supported(enc: MapspaceEncoding) -> bool:
    """True when every gene family of the encoding has a device decode.

    Mapping genes always do; co-search design genes do iff every knob
    steps an ``ArchParams`` scalar (a :data:`STORAGE_FIELDS` column or a
    ``ComputeLevel`` field) — a knob on a static field like
    ``word_bits`` changes the program itself and must take the host
    path.  Topology genes never do: the level count shapes the program
    (a mixed-topology population needs one program per topology group),
    so topology co-search always takes the host loop."""
    if isinstance(enc, TopologyCoSearchEncoding):
        return False
    if not isinstance(enc, CoSearchEncoding):
        return True
    for field, lvl, _ in enc.space.knobs:
        if lvl == COMPUTE_KNOB_LEVEL:
            if field not in COMPUTE_FIELDS:
                return False
        elif field not in STORAGE_FIELDS:
            return False
    return True


def _encoding_key(enc: MapspaceEncoding) -> tuple:
    """Structural identity of everything the device decode closes
    over."""
    spatial = enc.cons.spatial or {}
    key = (
        tuple(enc._gene_prime),
        tuple((r, enc._rank_block[r].start, enc._rank_block[r].stop)
              for r in enc.ranks),
        tuple(enc.ranks), enc.num_levels, tuple(enc.perm_levels),
        tuple(sorted((lvl, order)
                     for lvl, order in enc.fixed_order.items())),
        tuple(sorted((lvl, tuple(d.items()))
                     for lvl, d in spatial.items())),
        enc.genome_size,
    )
    if isinstance(enc, CoSearchEncoding):
        key += (enc.num_map_genes, enc.space.knobs,
                enc.base_design.arch.canonical())
    return key


def seed_of(key) -> int:
    """An int seed from an int or a ``torch.Generator`` (which is
    advanced by one draw)."""
    if isinstance(key, (int, np.integer)):
        return int(key)
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator(key)))


class FusedProgram:
    """One device-resident search program.

    Built by :func:`get_fused_program` for a (bucket program record,
    encoding structure, ES hyper-parameters, metric, SGD config) tuple,
    on the bucket facade's device.  The carry is ``(key, pop (P,G),
    fit (P,), pending (P,G))`` of device tensors — ``key`` the int64
    ``[seed low 32 bits, seed high bits, generation]`` counter of the
    draws, ``pending`` the not-yet-evaluated children the next
    generation starts by scoring.

    With ``archive_k > 0`` the carry grows a device top-K archive
    ``(arch_fit (K,), arch_gen (K,G))``: each generation merges its
    evaluated rows into it (masking rows already held), the
    per-generation outputs shrink to best-of-generation scalars
    (:data:`YS_TOPK_FIELDS`), and the host fold ingests K rows once per
    chunk instead of ``pop_size`` rows per generation.

    The step runs on static state tensors, so that one captured graph
    serves every carry: :meth:`invoke_chunk` copies a carry in, replays,
    and copies the new carry out (device to device)."""

    def __init__(self, bm: BucketedModel, enc: MapspaceEncoding,
                 strat: EvolutionStrategy, *, metric: str = "edp",
                 sgd_lr: float = 0.0, sgd_tau: float = 0.05,
                 archive_k: int = 0):
        self.bm = bm
        self.enc = enc
        self.device = bm.device
        self.metric = metric
        self.sgd_lr = float(sgd_lr)
        self.sgd_tau = float(sgd_tau)
        self.archive_k = int(archive_k)
        self.pop_size = int(strat.pop_size)
        self.tournament = int(strat.tournament)
        self.crossover_rate = float(strat.crossover_rate)
        self.mutation_rate = float(strat.mutation_rate)
        self.n_immigrants = int(round(strat.immigrants * strat.pop_size))
        self.cosearch = isinstance(enc, CoSearchEncoding)
        if enc.genome_size == 0:
            raise ValueError("fused search needs at least one gene")
        if not fused_supported(enc):
            raise ValueError(
                "encoding has design knobs without a device decode "
                "(non-ArchParams fields) — use the host search loop")

        #: per-shape bookkeeping for THIS program family ("fused" kind),
        #: separate from the bucket record it calls
        self.rec = _ProgramRecord(kind="fused", fn=None)
        compile_stats.record_program("fused")
        #: CUDA graph captures made (0 on the CPU)
        self.captures = 0
        self._lock = threading.Lock()
        self._consts: dict = {}
        #: the static state, workload leaves and arch rows the step (and
        #: its graph) read; each invocation copies its inputs in
        self._state: dict | None = None
        self._wp: DeviceLeaves | None = None
        #: sorted names of the density kinds ``_wp`` holds (spans)
        self.density_kinds: tuple = ()
        self._graph = None
        #: the two timing events around a chunk's replays (traced runs)
        self._events: tuple | None = None

        dev = self.device
        P, G = self.pop_size, enc.genome_size
        F, R, L = enc.num_factor_genes, len(enc.ranks), enc.num_levels
        self._F, self._R, self._L = F, R, L
        self._card = torch.as_tensor(enc.cardinality, dtype=torch.int64,
                                     device=dev)
        self._gene_block = torch.as_tensor(enc.gene_block,
                                           dtype=torch.int64, device=dev)
        self.num_blocks = enc.num_blocks
        self._primes = torch.as_tensor(enc._gene_prime,
                                       dtype=torch.float64, device=dev)
        self._levels = torch.arange(L, device=dev)
        self._blocks = [(enc._rank_block[r].start, enc._rank_block[r].stop)
                        for r in enc.ranks]
        self._perm_table = torch.as_tensor(
            np.asarray(enc.perms, np.int64).reshape(-1, R), device=dev)
        ridx = {r: i for i, r in enumerate(enc.ranks)}
        spatial = enc.cons.spatial or {}
        #: outermost level first, matching decode_bucketed's assembly:
        #: per level a fixed order row or the perm gene to gather, then
        #: the spatial constants (rank ids, bounds)
        self._layout: list[tuple] = []
        for lvl in range(L - 1, -1, -1):
            if lvl in enc.fixed_order:
                order = torch.as_tensor(
                    [ridx[r] for r in enc.fixed_order[lvl]],
                    dtype=torch.int64, device=dev)
            else:
                order = F + enc.perm_levels.index(lvl)
            sp = [(ridx[r], float(b))
                  for r, b in spatial.get(lvl, {}).items() if b > 1]
            sp_ids = torch.as_tensor([i for i, _ in sp], dtype=torch.int64,
                                     device=dev)
            sp_b = torch.as_tensor([b for _, b in sp], dtype=torch.float64,
                                   device=dev)
            self._layout.append((lvl, order, sp_ids, sp_b))

        # ---------- co-search design-gene tables ----------
        if self.cosearch:
            self.num_map_genes = enc.num_map_genes
            base_arch = enc.base_design.arch
            base = pack_arch_params(base_arch)
            knobs = enc.space.knobs
            explicit = {(lvl, field) for field, lvl, _ in knobs}
            self._knob_steps = [torch.as_tensor(s, dtype=torch.float64,
                                                device=dev)
                                for _, _, s in knobs]
            #: per knob: list of scatter cells ("storage", s, j, coef) or
            #: ("compute", j, coef) — the mirror of
            #: DesignSpace._replace_level incl. derived-default coupling
            self._knob_cells: list[list[tuple]] = []
            #: knobs the SGD step may move: all-positive step values
            #: (the log-space step needs log(v))
            self._knob_sgd = [all(v > 0 for v in s) for _, _, s in knobs]
            self._sgd_mask = torch.as_tensor(self._knob_sgd, device=dev)
            self._knob_log_steps = [
                torch.log(steps) if ok else None
                for ok, steps in zip(self._knob_sgd, self._knob_steps)]
            for field, lvl, _ in knobs:
                if lvl == COMPUTE_KNOB_LEVEL:
                    self._knob_cells.append(
                        [("compute", COMPUTE_FIELDS.index(field), 1.0)])
                    continue
                s = base_arch.level_index(lvl)
                cells = [("storage", s, STORAGE_FIELDS.index(field), 1.0)]
                if field == "read_energy_pj":
                    lv = base_arch.level(s)
                    if ((lvl, "write_energy_pj") not in explicit
                            and lv.write_energy_pj == lv.read_energy_pj):
                        cells.append(("storage", s, STORAGE_FIELDS.index(
                            "write_energy_pj"), 1.0))
                    if ((lvl, "metadata_read_energy_pj") not in explicit
                            and lv.metadata_read_energy_pj
                            == 0.25 * lv.read_energy_pj):
                        cells.append(("storage", s, STORAGE_FIELDS.index(
                            "metadata_read_energy_pj"), 0.25))
                self._knob_cells.append(cells)
        else:
            self.num_map_genes = G
            base = bm.arch_params
        # copies, never views: ``_bind`` writes the bound facade's rows
        # in here, and on the CPU ``as_tensor`` would share the first
        # facade's own numpy rows
        self._base_storage = torch.tensor(
            np.asarray(base.storage, np.float64), device=dev)
        self._base_comp = torch.tensor(
            np.asarray(base.compute, np.float64), device=dev)

    def _const(self, key, make):
        """A structural device constant, made once (before any
        capture: the eager warm-up generation makes them all)."""
        out = self._consts.get(key)
        if out is None:
            out = self._consts[key] = make()
        return out

    # ------------------------------------------------------------------
    # counter-based draws: hash(seed, generation, stream, element)
    # ------------------------------------------------------------------
    def _draws(self, key, requests: dict) -> dict:
        """float64 uniforms in [0, 1), 53 bits each, for every
        ``{stream: shape}`` of ``requests``, from the carried ``key``, in
        one hashing pass: the key is mixed once, the eight stream keys
        in one mix, and every request's counters in one tensor."""
        shapes = [(s, tuple(shape)) for s, shape in requests.items()]
        sizes = [int(np.prod(shape)) for _, shape in shapes]

        def make():
            dev = self.device
            salts = torch.as_tensor([0x9E3779B9 * (s + 1) & _M32
                                     for s in range(_IMMIGRANT + 1)],
                                    dtype=torch.int64, device=dev)
            counters = torch.cat([_mix32(torch.arange(
                2 * n, dtype=torch.int64, device=dev)) for n in sizes])
            sid = torch.cat([torch.full((2 * n,), s, dtype=torch.int64,
                                        device=dev)
                             for (s, _), n in zip(shapes, sizes)])
            return salts, counters, sid

        salts, counters, sid = self._const(("draws", tuple(shapes)), make)
        k = _mix32(key[0] ^ 0x5BD1E995)
        k = _mix32(k ^ key[1])
        k = _mix32(k ^ key[2])
        h = _mix32(_mix32(k ^ salts).index_select(0, sid) ^ counters)
        u = ((h[0::2] << 21) | (h[1::2] >> 11)).to(torch.float64) \
            * 2.0 ** -53
        return {s: part.reshape(shape) for (s, shape), part
                in zip(shapes, torch.split(u, sizes))}

    @staticmethod
    def _below(u, high) -> torch.Tensor:
        """Integers in ``[0, high)`` from uniforms ``u`` (``high``
        broadcasts, so each gene draws within its own cardinality), as
        the host strategies' ``randint``: ``floor(u * high)``."""
        x = torch.floor(u * high).long()
        if isinstance(high, torch.Tensor):
            return torch.minimum(x, high - 1)
        return torch.clamp(x, max=high - 1)

    # ------------------------------------------------------------------
    # device decode: genome -> (bounds, rank_ids) bucket-relative rows
    # ------------------------------------------------------------------
    def _decode_map(self, g):
        """(C, G) int64 genomes -> ((C, num_slots) float64 bounds,
        (C, num_slots) int64 rank ids): the device mirror of
        ``decode_bucketed``.  Each rank's per-level bound is the exact
        float64 product of its primes assigned to the level."""
        F, R, L = self._F, self._R, self._L
        C = g.shape[0]
        if F:
            assigned = g[:, :F, None] == self._levels
            contrib = torch.where(assigned, self._primes[:, None], 1.0)
            fb = torch.stack(
                [contrib[:, a:b].prod(1) if b > a
                 else torch.ones((C, L), dtype=torch.float64,
                                 device=g.device)
                 for a, b in self._blocks], 1)          # (C, R, L)
        else:
            fb = torch.ones((C, R, L), dtype=torch.float64, device=g.device)
        ids_parts, bound_parts = [], []
        for lvl, order, sp_ids, sp_b in self._layout:
            if isinstance(order, int):                # free level: gathered
                order = self._perm_table[g[:, order]]
            else:
                order = order.expand(C, R)
            ids_parts += [order, sp_ids.expand(C, len(sp_ids))]
            bound_parts += [torch.gather(fb[:, :, lvl], 1, order),
                            sp_b.expand(C, len(sp_b))]
        return torch.cat(bound_parts, 1), torch.cat(ids_parts, 1)

    def _design_vals(self, g):
        """Design genes -> (C, K) knob values (step-table gathers)."""
        return torch.stack([steps[g[:, self.num_map_genes + k]]
                            for k, steps in enumerate(self._knob_steps)], 1)

    def _rows_of(self, vals):
        """Knob values onto the base arch rows: the device mirror of
        ``DesignSpace.arch_of`` + ``pack_arch_params``."""
        C = vals.shape[0]
        storage = self._base_storage.expand(
            (C,) + tuple(self._base_storage.shape)).clone()
        comp = self._base_comp.expand(
            (C,) + tuple(self._base_comp.shape)).clone()
        for k, cells in enumerate(self._knob_cells):
            for cell in cells:
                if cell[0] == "storage":
                    _, s, j, coef = cell
                    storage[:, s, j] = coef * vals[:, k]
                else:
                    _, j, coef = cell
                    comp[:, j] = coef * vals[:, k]
        return storage, comp

    # ------------------------------------------------------------------
    def _evaluate(self, g, wp):
        """Evaluate a (C, G) population; returns (fitness, cycles,
        energy, edp, valid, possibly SGD-nudged genomes)."""
        g = torch.remainder(g, self._card)
        b, ids = self._decode_map(g)
        single = self.bm.traced_single
        C = g.shape[0]

        if not self.cosearch:
            rows = (self._base_storage.expand(
                        (C,) + tuple(self._base_storage.shape)),
                    self._base_comp.expand(
                        (C,) + tuple(self._base_comp.shape)))
            out = single(b, ids, wp, rows)
            fit = torch.where(out["valid"], out[self.metric], torch.inf)
            return (fit, out["cycles"], out["energy_pj"], out["edp"],
                    out["valid"], g)

        vals = self._design_vals(g)
        if self.sgd_lr <= 0.0:
            out = single(b, ids, wp, self._rows_of(vals))
            fit = torch.where(out["valid"], out[self.metric], torch.inf)
            return (fit, out["cycles"], out["energy_pj"], out["edp"],
                    out["valid"], g)

        with torch.enable_grad():
            v = vals.detach().requires_grad_()
            storage, comp = self._rows_of(v)
            out = single(b, ids, wp, (storage, comp))
            loss = surrogate_loss(out, storage, self.metric, self.sgd_tau)
            (gvals,) = torch.autograd.grad(loss.sum(), (v,))
        out = {k: t.detach() for k, t in out.items()}
        fit = torch.where(out["valid"], out[self.metric], torch.inf)
        # Lamarckian log-space step, normalized so the largest component
        # moves by exactly sgd_lr log-units, then snapped back to the
        # nearest step index of each (all-positive) knob.  Invalid /
        # non-finite candidates take no step.
        glog = gvals * vals                       # d loss / d log(v)
        scale = torch.where(self._sgd_mask, glog.abs(), 0.0).amax(1) \
            + 1e-30
        step_ok = out["valid"] & torch.isfinite(scale)
        u2 = (torch.log(torch.where(self._sgd_mask, vals, 1.0))
              - self.sgd_lr * glog / scale[:, None])
        g2 = g.clone()
        for k, log_steps in enumerate(self._knob_log_steps):
            if log_steps is None:
                continue
            idx = torch.argmin((log_steps - u2[:, k, None]).abs(), 1)
            pos = self.num_map_genes + k
            g2[:, pos] = torch.where(step_ok, idx, g[:, pos])
        return (fit, out["cycles"], out["energy_pj"], out["edp"],
                out["valid"], g2)

    # ------------------------------------------------------------------
    # ES generation step (mirrors strategies.EvolutionStrategy)
    # ------------------------------------------------------------------
    def _select(self, stream: int, fit, drawn):
        """Tournament selection: one winner (an index into ``fit``) per
        row of ``drawn[stream]``, the fittest of its ``tournament``
        uniform draws (the first of equals)."""
        draws = self._below(drawn[stream], len(fit))
        win = torch.argmin(fit[draws], 1)
        return torch.gather(draws, 1, win[:, None])[:, 0]

    def _crossover(self, pa, pb, drawn):
        """Factor-swap crossover: each child takes every gene block from
        parent A or B w.p. 1/2 (``drawn[_PICK]``)."""
        return torch.where((drawn[_PICK] < 0.5)[:, self._gene_block],
                           pa, pb)

    def _mutate(self, g, drawn):
        """Resample each gene w.p. ``mutation_rate`` (uniform over its
        cardinality), plus one forced gene per genome (``drawn[_FLIP]``,
        ``drawn[_FORCED]``, ``drawn[_FRESH]``)."""
        G = g.shape[1]
        genes = self._const(("genes", G),
                            lambda: torch.arange(G, device=self.device))
        flip = drawn[_FLIP] < self.mutation_rate
        forced = self._below(drawn[_FORCED], G)
        flip = flip | (genes == forced[:, None])
        fresh = self._below(drawn[_FRESH], self._card)
        return torch.where(flip, fresh, g)

    def _ask(self, key, pop, fit):
        """The next ``pop_size`` children of the parents ``(pop, fit)``:
        tournament, crossover at ``crossover_rate``, mutation, and the
        last ``immigrants`` share replaced by uniform genomes.  Every
        draw of the step comes from one :meth:`_draws` pass."""
        P, G = self.pop_size, self.enc.genome_size
        requests = {_TOURNAMENT_A: (P, self.tournament),
                    _TOURNAMENT_B: (P, self.tournament), _CROSS: (P,),
                    _PICK: (P, self.num_blocks), _FLIP: (P, G),
                    _FORCED: (P,), _FRESH: (P, G)}
        if self.n_immigrants:
            requests[_IMMIGRANT] = (self.n_immigrants, G)
        drawn = self._draws(key, requests)
        pa = pop[self._select(_TOURNAMENT_A, fit, drawn)]
        pb = pop[self._select(_TOURNAMENT_B, fit, drawn)]
        do_cross = drawn[_CROSS] < self.crossover_rate
        children = torch.where(do_cross[:, None],
                               self._crossover(pa, pb, drawn), pa)
        children = self._mutate(children, drawn)
        if self.n_immigrants:
            imm = self._below(drawn[_IMMIGRANT], self._card)
            children = torch.cat([children[:-self.n_immigrants], imm])
        return children

    def _step(self, st: dict, wp) -> None:
        """One generation on the static state ``st``, in place: score
        ``pending``, fold into the archive (``archive_k``), write this
        generation's outputs into row ``st["slot"]`` of ``st["ys"]``,
        take the (mu+lambda) fold and ask the next children."""
        key, pop, fit, pending = (st["key"], st["pop"], st["fit"],
                                  st["pending"])
        P, K = self.pop_size, self.archive_k
        pf, cyc, en, edp, valid, nudged = self._evaluate(pending, wp)
        if K:
            # merge PRE-nudge (evaluated) rows into the top-K buffer;
            # rows already held (finite slot with an identical genome)
            # are masked out, matching the host fold's seen-set dedup
            afit, agen = st["afit"], st["agen"]
            dup = ((pending[:, None, :] == agen[None, :, :]).all(-1)
                   & torch.isfinite(afit)[None, :]).any(1)
            cat_f = torch.cat([afit, torch.where(dup, torch.inf, pf)])
            cat_g = torch.cat([agen, pending])
            keep = torch.argsort(cat_f, stable=True)[:K]
            new_f, new_g = cat_f[keep], cat_g[keep]
            i = torch.argmin(pf).view(1)
            row = torch.cat([pf[i], cyc[i], en[i], edp[i],
                             valid.sum().to(torch.float64).view(1)])
        else:
            # PRE-nudge genomes with their true fitness: the archive and
            # the oracle walk must see evaluated pairs
            row = torch.cat([pf, cyc, en, edp, valid.to(torch.float64),
                             pending.reshape(-1).to(torch.float64)])
        allp = torch.cat([pop, nudged])
        allf = torch.cat([fit, pf])
        order = torch.argsort(allf, stable=True)[:P]  # (mu+lambda) fold
        pop2, fit2 = allp[order], allf[order]
        pending2 = self._ask(key, pop2, fit2)
        st["ys"].index_copy_(0, st["slot"], row[None])
        st["slot"].add_(1)
        pop.copy_(pop2)
        fit.copy_(fit2)
        pending.copy_(pending2)
        key[2:].add_(1)
        if K:
            st["afit"].copy_(new_f)
            st["agen"].copy_(new_g)

    # ------------------------------------------------------------------
    def _width(self) -> int:
        if self.archive_k:
            return len(YS_TOPK_FIELDS)
        return self.pop_size * (5 + self.enc.genome_size)

    def _bind(self) -> tuple:
        """The facade's workload leaves (and, for a mapping-only search,
        its design's arch rows) copied into the static inputs: facades
        that share this program differ in exactly these.  A different
        set of density kinds changes the step's operations, so it drops
        the captured graph."""
        leaves = self.bm._bind_params(None)
        if self._wp is None or self._wp.kinds != leaves.kinds:
            rb, ids, dp, hist, tables = (t.clone()
                                         for t in leaves.tensors())
            self._wp = DeviceLeaves(rb, ids, dp, hist, leaves.kinds, tables)
            self.density_kinds = tuple(sorted({MODEL_KINDS[k]
                                               for k in leaves.kinds}))
            self._graph = None
        for dst, src in zip(self._wp.tensors(), leaves.tensors()):
            dst.copy_(src)
        if not self.cosearch:
            storage, comp = _device_arch_rows(self.bm.arch_params,
                                              self.device)
            self._base_storage.copy_(storage)
            self._base_comp.copy_(comp)
        return self._wp

    def _static(self, carry, rows: int) -> dict:
        """The static state the step (and its graph) run on, holding
        ``carry`` and an output buffer of at least ``rows``
        generations."""
        if self._state is None or len(self._state["ys"]) < rows:
            # room for longer chunks than the first: a new buffer means
            # a new capture
            rows = max(rows, 64)
            st = {name: t.clone() for name, t in zip(_CARRY, carry)}
            st["slot"] = torch.zeros(1, dtype=torch.int64,
                                     device=self.device)
            st["ys"] = torch.zeros((rows, self._width()),
                                   dtype=torch.float64, device=self.device)
            self._state, self._graph = st, None
        return self._state

    def _load(self, st: dict, carry) -> None:
        for name, t in zip(_CARRY, carry):
            st[name].copy_(t)
        st["slot"].zero_()

    def _captured(self, st: dict, carry, wp):
        """The generation's CUDA graph: one eager warm-up generation on
        the state (discarded: the carry is loaded again), then one
        capture."""
        if self._graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._step(st, wp)
            torch.cuda.current_stream(self.device).wait_stream(side)
            self._load(st, carry)
            # keep the cudaGraph_t to count its kernels, then
            # instantiate, so that the first replay pays nothing new
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                self._step(st, wp)
            kernels = _kernel_nodes(graph.raw_cuda_graph())
            graph.instantiate()
            if kernels is not None:
                self._observe_kernels(kernels, wp)
            self._graph = graph
            self.captures += 1
        return self._graph

    @staticmethod
    def _observe_kernels(kernels: int, wp) -> None:
        """A capture's kernel count, on ``fused.graph_kernels`` and, for
        each kind past the JAX package's (an id past ``ACTUAL_ID``) that
        the program evaluates, on ``fused.graph_kernels.<kind>``."""
        obs.metrics.histogram("fused.graph_kernels").observe(kernels)
        for kind in sorted(set(wp.kinds)):
            if kind > ACTUAL_ID:
                obs.metrics.histogram(
                    f"fused.graph_kernels.{MODEL_KINDS[kind]}").observe(
                        kernels)

    # ------------------------------------------------------------------
    def init_carry(self, key) -> tuple:
        """Initial carry from an int seed or a ``torch.Generator``: the
        host strategies' half-structured / half-uniform initial
        population as ``pending``, parents empty (+inf fitness
        placeholders the first survivor fold discards)."""
        seed = seed_of(key)
        dev = self.device
        pop0 = self.enc.repair(init_population(seed, self.enc,
                                               self.pop_size))
        pop0 = torch.as_tensor(pop0, dtype=torch.int64, device=dev)
        carry = (torch.as_tensor([seed & _M32, (seed >> 32) & _M32, 0],
                                 dtype=torch.int64, device=dev),
                 pop0, torch.full((self.pop_size,), torch.inf,
                                  dtype=torch.float64, device=dev),
                 pop0.clone())
        if self.archive_k:
            # +inf placeholder rows: the dup mask ignores them
            # (non-finite slot) and every real row sorts above them
            carry += (torch.full((self.archive_k,), torch.inf,
                                 dtype=torch.float64, device=dev),
                      torch.zeros((self.archive_k, self.enc.genome_size),
                                  dtype=torch.int64, device=dev))
        return carry

    def inject(self, carry, genomes, fitness) -> tuple:
        """Host-side migrant fold (island search between chunks): merge
        (genomes, fitness) into the carried population with the same
        stable best-of ``(mu+lambda)`` rule as ``strat.tell``.  The
        archive buffer (``archive_k`` mode) is left untouched — migrants
        were evaluated on their home island and enter its archive
        there."""
        key, pop, fit, pending, *buffer = carry
        g = self.enc.repair(np.asarray(genomes, np.int64))
        allp = np.concatenate([pop.cpu().numpy(), g])
        allf = np.concatenate([fit.cpu().numpy(),
                               np.asarray(fitness, np.float64)])
        order = np.argsort(allf, kind="stable")[: self.pop_size]
        return (key, torch.as_tensor(allp[order], device=self.device),
                torch.as_tensor(allf[order], device=self.device), pending,
                *buffer)

    def invoke_chunk(self, carry, length: int) -> tuple:
        """Run ``length`` generations.  Returns ``(new_carry, ys)`` where
        ``ys`` maps :data:`YS_FIELDS` (or :data:`YS_TOPK_FIELDS` plus the
        archive snapshot) to host arrays with a leading generation axis.

        On the card each generation is one replay of the captured graph,
        all on the calling thread's current stream, with one
        device-to-host copy at the end; on the CPU the step runs
        eagerly.  The first sighting of a (device, pop, genome) shape is
        an ``engine.compile`` span and ``compile_seconds`` (the warm-up
        and capture), later chunks ``engine.eval``; either span carries
        the program's ``density_kinds``.  With tracing on, on the card,
        the span's ``device_s`` is the replays' device time, from two
        CUDA events read after the readback synchronised."""
        length = int(length)
        if length < 1:
            raise ValueError(f"chunk length must be >= 1, got {length}")
        P, G = self.pop_size, self.enc.genome_size
        shape_key = (str(self.device), P, G)
        with self._lock:
            is_new = self.rec.note_compile(shape_key)
            compile_stats.record_batched_evals(
                length * P, shared=self.bm.program_shared)
            name = "engine.compile" if is_new else "engine.eval"
            t0 = time.perf_counter()
            with obs.span(name, kind="fused",
                          workload=self.bm.workload.name,
                          candidates=length * P, shape=shape_key,
                          generations=length) as sp, \
                    torch.no_grad():
                wp = self._bind()
                sp.set(density_kinds=self.density_kinds)
                st = self._static(carry, length)
                self._load(st, carry)
                cuda = st["ys"].is_cuda
                graph = self._captured(st, carry, wp) if cuda else None
                timed = cuda and obs.enabled()
                if timed:
                    stream = torch.cuda.current_stream(self.device)
                    if self._events is None:
                        self._events = (torch.cuda.Event(enable_timing=True),
                                        torch.cuda.Event(enable_timing=True))
                    self._events[0].record(stream)
                for _ in range(length):
                    if cuda:
                        graph.replay()
                    else:
                        self._step(st, wp)
                if timed:
                    self._events[1].record(stream)
                new = tuple(st[n].clone() for n in _CARRY[:len(carry)])
                host = [st["ys"][:length].reshape(-1)]
                if self.archive_k:
                    host += [st["afit"], st["agen"].reshape(-1)
                             .to(torch.float64)]
                host = torch.cat(host).cpu().numpy()
                if timed:
                    sp.set(device_s=self._events[0].elapsed_time(
                        self._events[1]) / 1e3)
            dt = time.perf_counter() - t0
            if is_new:
                compile_stats.record_compile_seconds(dt)
            else:
                compile_stats.record_eval_seconds(dt)
        return new, self._unpack(host, length)

    def _unpack(self, host: np.ndarray, length: int) -> dict:
        P, G, K = self.pop_size, self.enc.genome_size, self.archive_k
        rows = host[:length * self._width()].reshape(length, -1)
        if K:
            ys = {k: rows[:, i].copy()
                  for i, k in enumerate(YS_TOPK_FIELDS)}
            ys["valid_count"] = ys["valid_count"].astype(np.int64)
            tail = host[length * self._width():]
            ys["archive_fitness"] = tail[:K].copy()
            ys["archive_genomes"] = tail[K:].reshape(K, G).astype(np.int64)
            return ys
        ys = {k: rows[:, i * P:(i + 1) * P].copy()
              for i, k in enumerate(YS_FIELDS[:5])}
        ys["valid"] = ys["valid"] != 0
        ys["genomes"] = rows[:, 5 * P:].reshape(length, P, G) \
            .astype(np.int64)
        return ys


# ----------------------------------------------------------------------
# program cache: a program holds device tables and, on the card, a
# captured graph, and is fully determined by (bucket program record,
# encoding structure, ES hyper-parameters, metric, SGD config) — share
# programs the way _PROGRAM_CACHE shares bucket programs
# ----------------------------------------------------------------------
_FUSED_CACHE: dict = {}
_FUSED_CACHE_CAP = 64
_FUSED_LOCK = threading.RLock()


def clear_fused_cache() -> None:
    with _FUSED_LOCK:
        _FUSED_CACHE.clear()


register_cache_clearer(clear_fused_cache)


def graph_captures() -> int:
    """CUDA graph captures made by the cached programs (0 on the
    CPU)."""
    with _FUSED_LOCK:
        return sum(fp.captures for _, fp in _FUSED_CACHE.values())


def get_fused_program(bm: BucketedModel, enc: MapspaceEncoding,
                      strat: EvolutionStrategy, *, metric: str = "edp",
                      sgd_lr: float = 0.0,
                      sgd_tau: float = 0.05,
                      archive_k: int = 0) -> FusedProgram:
    """Memoized :class:`FusedProgram` constructor.  Keyed by the
    IDENTITY of the bucket facade's shared program record (which already
    encodes arch topology, SAF structure, workload structure, density
    caps, bucket and check_capacity) plus the facade's device, the
    encoding structure and the search hyper-parameters; the cached
    value holds a strong reference to the record, so an id can never be
    recycled while its entry lives."""
    key = (id(bm._prog), str(bm.device), _encoding_key(enc),
           strat.pop_size, strat.tournament, strat.crossover_rate,
           strat.mutation_rate, strat.immigrants, metric, float(sgd_lr),
           float(sgd_tau), int(archive_k))
    with _FUSED_LOCK:
        hit = _FUSED_CACHE.get(key)
        if hit is not None:
            rec_ref, fp = hit
            if rec_ref is bm._prog:
                fp.bm = bm   # rebind: same program, freshest facade
                compile_stats.record_program_share("fused")
                return fp
        fp = FusedProgram(bm, enc, strat, metric=metric, sgd_lr=sgd_lr,
                          sgd_tau=sgd_tau, archive_k=archive_k)
        if len(_FUSED_CACHE) >= _FUSED_CACHE_CAP:
            _FUSED_CACHE.pop(next(iter(_FUSED_CACHE)))
        _FUSED_CACHE[key] = (bm._prog, fp)
        return fp


# ----------------------------------------------------------------------
class ChunkAbsorber:
    """Host-side fold of fused-chunk outputs into the runner's search
    state: archive, best-so-far, evaluation counters and per-generation
    :class:`SearchLog` records (with ``wall_time_s=None`` — a
    generation inside a replayed chunk has no individually measurable
    wall-clock; chunk timing lives in ``SearchLog.timing``).  Mirrors
    ``runner.run_search``'s host-loop bookkeeping exactly, so the
    scalar-oracle validation walk downstream is path-independent.

    Handles both chunk-output shapes: the full-population outputs
    (:data:`YS_FIELDS`) fold per generation, and the device-archive
    mode (:data:`YS_TOPK_FIELDS` + the K-row buffer snapshot, from a
    program built with ``archive_k > 0``) — which needs ``pop_size``
    to keep the evaluation counters honest."""

    def __init__(self, metric: str, archive_size: int,
                 pop_size: int | None = None):
        self.metric = metric
        self.archive_size = archive_size
        self.pop_size = pop_size
        self.archive_fit: list[float] = []
        self.archive_gen: list[np.ndarray] = []
        self.seen: set[bytes] = set()
        self.best = {"fitness": np.inf, "cycles": np.inf,
                     "energy_pj": np.inf, "edp": np.inf}
        self.n_eval = 0
        self.n_valid = 0
        self.gen = 0

    def absorb(self, ys: dict, log: SearchLog | None = None) -> None:
        if "genomes" not in ys:
            return self._absorb_topk(ys, log)
        fits = np.asarray(ys["fitness"], np.float64)
        genomes = np.asarray(ys["genomes"], np.int64)
        for t in range(len(fits)):
            fitness = fits[t]
            self.n_eval += len(fitness)
            self.n_valid += int(np.asarray(ys["valid"][t]).sum())
            i = int(np.argmin(fitness))
            if fitness[i] < self.best["fitness"]:
                self.best = {
                    "fitness": float(fitness[i]),
                    "cycles": float(ys["cycles"][t][i]),
                    "energy_pj": float(ys["energy_pj"][t][i]),
                    "edp": float(ys["edp"][t][i])}
            for j in np.argsort(fitness,
                                kind="stable")[: self.archive_size]:
                if not np.isfinite(fitness[j]):
                    break
                b = genomes[t, j].tobytes()
                if b not in self.seen:
                    self.seen.add(b)
                    self.archive_fit.append(float(fitness[j]))
                    self.archive_gen.append(genomes[t, j].copy())
            if len(self.archive_fit) > 4 * self.archive_size:
                order = np.argsort(self.archive_fit,
                                   kind="stable")[: self.archive_size]
                self.archive_fit = [self.archive_fit[k] for k in order]
                self.archive_gen = [self.archive_gen[k] for k in order]
            if log is not None:
                log.append(GenerationRecord(
                    generation=self.gen, evaluations=self.n_eval,
                    valid=self.n_valid,
                    best_fitness=self.best["fitness"],
                    best_cycles=self.best["cycles"],
                    best_energy_pj=self.best["energy_pj"],
                    best_edp=self.best["edp"], wall_time_s=None))
            self.gen += 1

    def _absorb_topk(self, ys: dict,
                     log: SearchLog | None = None) -> None:
        """Device-archive fold: per-generation best scalars drive the
        best-so-far trajectory and log records; the archive is the
        cumulative K-row device buffer, REPLACED wholesale each chunk
        (the buffer is global-top-K-so-far, a superset of anything a
        previous chunk delivered)."""
        if self.pop_size is None:
            raise ValueError(
                "ChunkAbsorber needs pop_size to absorb device-archive "
                "(archive_k) chunk outputs")
        bf = np.asarray(ys["best_fitness"], np.float64)
        nv = np.asarray(ys["valid_count"], np.int64)
        for t in range(len(bf)):
            self.n_eval += self.pop_size
            self.n_valid += int(nv[t])
            if bf[t] < self.best["fitness"]:
                self.best = {
                    "fitness": float(bf[t]),
                    "cycles": float(ys["best_cycles"][t]),
                    "energy_pj": float(ys["best_energy_pj"][t]),
                    "edp": float(ys["best_edp"][t])}
            if log is not None:
                log.append(GenerationRecord(
                    generation=self.gen, evaluations=self.n_eval,
                    valid=self.n_valid,
                    best_fitness=self.best["fitness"],
                    best_cycles=self.best["cycles"],
                    best_energy_pj=self.best["energy_pj"],
                    best_edp=self.best["edp"], wall_time_s=None))
            self.gen += 1
        afit = np.asarray(ys["archive_fitness"], np.float64)
        agen = np.asarray(ys["archive_genomes"], np.int64)
        self.archive_fit, self.archive_gen = [], []
        self.seen = set()
        for f, g in zip(afit, agen):
            if not np.isfinite(f):
                break       # placeholder rows sort last
            b = g.tobytes()
            if b in self.seen:
                continue
            self.seen.add(b)
            self.archive_fit.append(float(f))
            self.archive_gen.append(g.copy())
