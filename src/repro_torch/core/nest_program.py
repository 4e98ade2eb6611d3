"""The batched program: the three steps of the Sparseloop model over a
population of loop nests, as float64 tensors with a leading candidate
axis.  A :class:`NestProgram` is built from structure alone; rank
bounds, density parameters and architecture scalars arrive with each
call (``core.batched`` caches programs and binds the data).

Each step mirrors one function of the scalar model, and a change to
one must be made to the other (the parity tests hold them together):

* :meth:`NestProgram._dataflow`: ``dataflow.analyze_dataflow``;
* :meth:`NestProgram._sparse`: ``sparse.analyze_sparse``, with the
  format analyzer :meth:`NestProgram._format`
  (``formats.analyze_tile_format``);
* :meth:`NestProgram._microarch`: ``microarch.evaluate_microarch``.

Everything rank-keyed in the scalar model (tile bounds, relevance,
leader windows) becomes a (C, R) tensor masked by the slots' rank
one-hot (:class:`_Slots`).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from .. import obs
from .arch import COMPUTE_FIELDS, STORAGE_FIELDS
from .density import DensityCaps, TracedDensityStats
from .taxonomy import RankFormat, SAFKind, SAFSpec, TensorFormat

WORD_BITS = 16.0  # metadata accounting word width (matches sparse.py)
F64 = torch.float64
#: rank formats that hold every coordinate of a fiber, so their
#: occupancy needs no density statistic
_OCCUPANCY_FREE = (RankFormat.U, RankFormat.UB)


class BatchedUnsupported(NotImplementedError):
    """The (design, workload) pair has no batched path; use the scalar
    engine instead."""


# ----------------------------------------------------------------------
# Elementwise helpers: per-candidate values are (C,) tensors, but parts
# of the model stay Python floats where a static structure makes them
# constant (no spatial loop at a level, an uncompressed format, ...).
# ----------------------------------------------------------------------
def _prod(xs):
    out = 1.0
    for x in xs:
        out = out * x
    return out


def _extreme(a, b, op, clamp_side: str, py):
    """``op`` (``torch.maximum`` / ``torch.minimum``) of tensors and
    Python floats.  On the gradient path a tie splits the gradient in
    half between the two sides, as ``op`` and the JAX package's
    ``jnp.maximum`` do (a Python float side takes its half with it); off
    it, a float side is one ``torch.clamp``, which would pass the whole
    gradient at a tie."""
    if not isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor):
            return py(a, b)
        a, b = b, a
    if not isinstance(b, torch.Tensor):
        if not a.requires_grad:
            return torch.clamp(a, **{clamp_side: b})
        b = torch.full_like(a, b)
    return op(a, b)


def _max(a, b):
    return _extreme(a, b, torch.maximum, "min", max)


def _min(a, b):
    return _extreme(a, b, torch.minimum, "max", min)


def _where(cond, a, b):
    """``torch.where`` that also takes a Python bool condition (a static
    structure, e.g. a format without metadata)."""
    if not isinstance(cond, torch.Tensor):
        return a if cond else b
    return torch.where(cond, a, b)


class _Events:
    """Elimination probabilities keyed by leader tensor, skips and gates
    apart (``sparse.py``'s ``skip_ev`` / ``gate_ev`` of one site).
    Within a leader the finest-granularity event wins (its tiles nest);
    leaders are independent."""

    def __init__(self):
        self.skip: dict = {}
        self.gate: dict = {}

    def add(self, kind: SAFKind, leader: str, p) -> None:
        dst = self.skip if kind == SAFKind.SKIP else self.gate
        dst[leader] = _max(dst.get(leader, 0.0), p)

    def absorb(self, other: "_Events") -> None:
        for kind, events in ((SAFKind.SKIP, other.skip),
                             (SAFKind.GATE, other.gate)):
            for lname, p in events.items():
                self.add(kind, lname, p)

    def shares(self) -> tuple:
        """(skipped, gated) shares: a gate gates what no skip took."""
        sk = _union(self.skip)
        return sk, _max(0.0, _union({**self.gate, **self.skip}) - sk)


def _union(probs_by_leader: dict):
    """P(any leader's tile empty), leaders independent."""
    keep = 1.0
    for p in probs_by_leader.values():
        keep = keep * (1.0 - p)
    return 1.0 - keep


def _fractions(live, gated_above, sk, gt) -> tuple:
    """(actual, gated, skipped) shares of traffic that arrives ``live``
    or ``gated_above`` and meets events skipping ``sk``, gating ``gt``."""
    act = live * _max(0.0, 1.0 - sk - gt)
    gated = live * gt + gated_above
    return act, gated, _max(0.0, 1.0 - act - gated)


@dataclasses.dataclass
class _Breakdown:
    actual: object = 0.0
    gated: object = 0.0
    skipped: object = 0.0


def _breakdown(dense_words, scale, fr) -> _Breakdown:
    fa, fg, fsk = fr
    moved = dense_words * scale
    return _Breakdown(actual=moved * fa, gated=moved * fg,
                      skipped=moved * fsk)


def _format_tile(fmt: TensorFormat, dims) -> tuple:
    """``dims`` in ``fmt``'s ranks (``formats._align_dims_to_format``),
    the tile size and each rank's payload (at least one element)."""
    dims = list(dims) or [1.0]
    nfr = len(fmt.rank_formats)
    if len(dims) < nfr:
        dims = [1.0] * (nfr - len(dims)) + dims
    elif len(dims) > nfr:
        head = _prod(dims[: len(dims) - nfr + 1])
        dims = [head] + dims[len(dims) - nfr + 1:]
    payload = [_max(1.0, _prod(dims[i + 1:])) for i in range(len(dims))]
    return dims, _prod(dims), payload


def _compute_query(lname: str) -> tuple:
    """A compute-level SAF's query: the leader's density at one element."""
    return ("ed", lname, None, 1.0)


class _DensityQueries:
    """The density-statistic queries of one program run, answered in
    batches.

    Every query is asked (:meth:`ask`) before any is answered: one
    statistic of one tensor at one tile, under a static key that
    describes the tile (a Python-number tile is keyed by its value), so
    a query that repeats is asked once.  :meth:`solve` stacks each
    (tensor, statistic)'s tiles along a trailing axis into one (C, Q)
    tensor and evaluates the statistic once on it; :meth:`answer` reads
    a query's column.  The statistics are elementwise in the tile, so a
    column holds what the query alone would have given, and a run
    launches one statistics chain per (tensor, statistic) instead of
    one per query."""

    def __init__(self):
        self._tiles: dict = {}      # (tensor, stat) -> {key: tile}
        self._cols: dict = {}       # (tensor, stat, key) -> (C,) answer
        self.answered = 0
        self.evals = 0

    @staticmethod
    def _key(key, tile):
        return key if isinstance(tile, torch.Tensor) else float(tile)

    def ask(self, stat: str, tname: str, key, tile) -> None:
        self._tiles.setdefault((tname, stat), {}).setdefault(
            self._key(key, tile), tile)

    def solve(self, evaluate, const_row, C: int) -> None:
        """``evaluate(stat, tname, tiles)`` answers a (C, Q) stack;
        ``const_row(values)`` is a cached (Q,) tensor of Python-number
        tiles, so the numbers join the tensor tiles without a fill
        apiece."""
        for (tname, stat), tiles in self._tiles.items():
            held = [(k, t) for k, t in tiles.items()
                    if isinstance(t, torch.Tensor)]
            const = [(k, t) for k, t in tiles.items()
                     if not isinstance(t, torch.Tensor)]
            parts = []
            if held:
                parts.append(torch.stack([t.expand(C) for _, t in held],
                                         -1))
            if const:
                parts.append(const_row(tuple(float(t) for _, t in const))
                             .expand(C, len(const)))
            stack = torch.cat(parts, -1) if len(parts) > 1 else parts[0]
            out = evaluate(stat, tname, stack)
            self.evals += 1
            for (key, _), col in zip(held + const, out.unbind(-1)):
                self._cols[(tname, stat, key)] = col

    def answer(self, stat: str, tname: str, key, tile):
        self.answered += 1
        return self._cols[(tname, stat, self._key(key, tile))]


# ----------------------------------------------------------------------
class _Slots:
    """The slot geometry of one call: bounds ``b`` (C, num_slots), rank
    one-hot ``oh`` ((num_slots, R), or (C, num_slots, R) for a bucket)
    and the products the steps take of them.  Each product is made once
    for every query that reads it, stacked along an axis of its own: the
    resident-tile bounds below every level (:meth:`tile_bounds`), and
    one reuse-prefix pass over every (child level, relevance) pair of
    the program (:attr:`NestProgram._pairs`), which answers
    :meth:`fetch_counts` and :meth:`leader_window_bounds` with column
    views.  Unit-bound slots are inert whatever their rank, which makes
    bucket padding free."""

    def __init__(self, prog: "NestProgram", b, oh):
        self.prog, self.b, self.oh = prog, b, oh
        self.dev = dev = b.device
        self.C = b.shape[0]
        self.levels = prog.slot_levels
        #: per tensor, the (R,) mask of its relevant ranks
        self.rel = {name: prog._const(dev, ("rel", name),
                                      lambda v=v: torch.as_tensor(
                                          v, device=dev))
                    for name, v in prog._rel.items()}
        self._made: dict = {}
        #: the pairs the reuse-prefix pass scanned, and the fetch-count
        #: and leader-window reads answered
        self.scanned = self.reads = 0

    def once(self, key, make):
        if key not in self._made:
            self._made[key] = make()
        return self._made[key]

    def const(self, name: str):
        """The program's structural array ``name`` on this call's
        device."""
        return self.prog._const(self.dev, name, lambda: torch.as_tensor(
            getattr(self.prog, name), device=self.dev))

    def _tiles(self):
        """(C, S + 1, R): at ``[:, l]`` the per-rank bound product of the
        slots below level ``l``, the tensor form of the rank-keyed
        tile-bound dicts."""
        mask = self.const("_below")[:, :, None] & self.oh.unsqueeze(-3)
        return torch.where(mask, self.b[:, None, :, None], 1.0).prod(-2)

    def tile_bounds(self, level: int):
        """(C, R) bounds of the tile below ``level`` (0 to S): the slots
        at lower levels."""
        return self.once("tiles", self._tiles)[:, level]

    def _prefix(self) -> tuple:
        """The reuse-prefix scan of every pair at once, over the temporal
        slots innermost first: their (C, T) bounds and (T, R) or
        (C, T, R) rank one-hot, and as (P, T) or (C, P, T) masks, the
        slots above each pair's child level, which of them are relevant
        to its tensor, and which lie in its reuse prefix (from its outermost slot down to its innermost
        relevant *non-unit* loop: where a running count of those, innermost
        first, is nonzero)."""
        inner = self.const("_inner")
        bs = self.b[:, inner]
        above = self.const("_pair_above")
        oh = self.oh[..., inner, :]
        rel = (oh.unsqueeze(-3) & self.const("_pair_ranks")).any(-1)
        in_prefix = (torch.cumsum(rel & (bs[:, None] > 1), -1) > 0) & above
        self.scanned = len(self.prog._pairs)
        return bs, oh, above, rel, in_prefix

    def _counts(self) -> tuple:
        """(C, P) rounds and distinct fetches of every pair."""
        bs, _, _, rel, in_prefix = self.once("prefix", self._prefix)
        bs = bs[:, None]
        return (torch.where(in_prefix, bs, 1.0).prod(-1),
                torch.where(in_prefix & rel, bs, 1.0).prod(-1))

    def fetch_counts(self, child_level: int, rel_key):
        """``dataflow.fetch_counts``: (rounds, distinct) into
        ``child_level`` of a tensor of relevance ``rel_key``."""
        self.reads += 1
        p = self.prog._pairs.get((child_level, rel_key))
        if p is None:           # no temporal slot above child_level
            return 1.0, 1.0
        rounds, distinct = self.once("counts", self._counts)
        return rounds[:, p], distinct[:, p]

    def tile_dims(self, t, tb):
        ridx = self.prog._ridx
        return tuple(sum(tb[..., ridx[r]] for r in dim) - (len(dim) - 1)
                     for dim in t.projection)

    def tile_size(self, t, tb):
        return _prod(self.tile_dims(t, tb))

    def _windows(self):
        """(C, P, R): each pair's leader window at level ``c + 1``, the
        tile below that level times the slots above ``c`` outside the
        pair's reuse prefix."""
        bs, oh, above, _, in_prefix = self.once("prefix", self._prefix)
        outer = torch.where(
            oh.unsqueeze(-3) & (above & ~in_prefix)[..., None],
            bs[:, None, :, None], 1.0).prod(-2)
        return self.once("tiles", self._tiles)[
            :, self.const("_pair_window_level")] * outer

    def leader_window_bounds(self, level: int, follower_key):
        """``dataflow.leader_tile_bounds`` for a follower of relevance
        ``follower_key``, unit loops treated as absent."""
        self.reads += 1
        p = self.prog._pairs.get((level - 1, follower_key))
        if p is None:           # no temporal slot at or above level
            return self.tile_bounds(level)
        return self.once("windows", self._windows)[:, p]


# ----------------------------------------------------------------------
class NestProgram:
    """The three-step model over one static slot shape, built from
    structure: the SAF spec, the workload's ``(ranks, tensors, output)``,
    the level names, each slot's level and spatiality (outermost first),
    the density caps and ``check_capacity``.  ``onehot`` is an exact
    template's constant (num_slots, R) rank one-hot; None for a bucket,
    whose one-hot comes from per-candidate rank ids."""

    def __init__(self, safs: SAFSpec, structure: tuple, level_names,
                 slot_levels, slot_spatial, caps: DensityCaps,
                 check_capacity: bool = True, onehot=None):
        ranks, tensors, output = structure
        self.ranks: tuple[str, ...] = tuple(ranks)
        self.tensors = tuple(tensors)
        self.output = output
        self.level_names = list(level_names)
        self.slot_levels = tuple(slot_levels)
        self.num_slots = len(self.slot_levels)
        self.check_capacity = check_capacity
        self.onehot = onehot
        self._ridx = {r: i for i, r in enumerate(self.ranks)}
        self._tensor = {t.name: t for t in self.tensors}
        self._tidx = {t.name: i for i, t in enumerate(self.tensors)}
        self._rel = {t.name: np.asarray([r in t.ranks for r in self.ranks])
                     for t in self.tensors}
        self._rel_key = {name: tuple(bool(x) for x in v)
                         for name, v in self._rel.items()}
        self._temporal = [j for j in range(self.num_slots)
                          if not slot_spatial[j]]
        self._spatial = [j for j in range(self.num_slots) if slot_spatial[j]]
        S = len(self.level_names)
        self._geometry(S)
        self._formats = {(t.name, s): safs.format_for(self.level_names[s],
                                                      t.name)
                         for t in self.tensors for s in range(S)}
        #: (kind, follower, level or None for compute, leader) per (SAF,
        #: leader) of the expansion: the walk of both density passes
        self._leaders = tuple(
            (saf.kind, saf.follower,
             None if saf.level == "compute"
             else self.level_names.index(saf.level), lname)
            for saf in safs.expand_double_sided() for lname in saf.leaders)
        stats = TracedDensityStats(caps)
        self._stat_fns = {"pe": stats.prob_empty,
                          "ed": stats.expected_density,
                          "mx": stats.max_nnz}
        self._consts: dict = {}
        self._lock = threading.Lock()

    def _geometry(self, S: int) -> None:
        """The structural arrays of :class:`_Slots`' stacked products:
        the slots below each level, and the reuse-prefix pairs, every
        (child level, relevance key) whose fetch counts have a temporal
        slot to scan, with their slots in the innermost-first order of
        the scan."""
        lv = np.asarray(self.slot_levels, np.int64).reshape(-1)
        #: _below[l, j]: slot j lies below level l (l = 0 .. S)
        self._below = np.arange(S + 1)[:, None] > lv
        self._inner = np.asarray(self._temporal[::-1], np.int64)
        inner_lv = lv[self._inner]
        keys = list(dict.fromkeys(self._rel_key.values()))
        #: (child level, relevance key) -> the pair's column
        self._pairs = {pair: p for p, pair in enumerate(
            (c, k) for c in range(-1, S) if (inner_lv > c).any()
            for k in keys)}
        levels = np.asarray([c for c, _ in self._pairs], np.int64)
        self._pair_window_level = levels + 1
        self._pair_above = inner_lv > levels[:, None]
        #: (P, T, R): the pair's relevant ranks on each of its slots
        self._pair_ranks = self._pair_above[..., None] & np.asarray(
            [k for _, k in self._pairs], bool).reshape(
                len(levels), 1, len(self.ranks))

    def _const(self, dev, key, make):
        """A structural constant (mask, index vector) as a tensor on
        ``dev``, made once per device so evaluations copy nothing."""
        k = (str(dev), key)
        out = self._consts.get(k)
        if out is None:
            with self._lock:
                out = self._consts.get(k)
                if out is None:
                    out = self._consts[k] = make()
        return out

    # ------------------------------------------------------------------
    def __call__(self, args, wp) -> dict:
        """``args``: ``(b, ap)`` for a template, ``(b, rank_ids, ap)`` for
        a bucket, ``ap`` the (storage, compute) rows; ``wp`` the
        workload's ``DeviceLeaves``.  Returns the metric tensors."""
        if self.onehot is None:
            b, ids, ap = args
            ar = self._const(b.device, "arange",
                             lambda: torch.arange(len(self.ranks),
                                                  device=b.device))
            oh = ids.long()[..., None] == ar
        else:
            b, ap = args
            oh = self._const(b.device, "onehot",
                             lambda: torch.as_tensor(self.onehot,
                                                     device=b.device))
        g = _Slots(self, b, oh)
        dense, dense_computes, total_spatial = self._dataflow(
            g, wp.rank_bounds)
        dq = _DensityQueries()
        self._ask(g, dense, dq)
        dq.solve(lambda stat, name, tiles: self._density(wp, stat, name,
                                                         tiles),
                 lambda vals: self._const(g.dev, ("tiles", vals),
                                          lambda: torch.tensor(
                                              vals, dtype=F64, device=g.dev)),
                 g.C)
        sparse, compute = self._sparse(g, dense, dense_computes, dq)
        obs.metrics.histogram("engine.density_queries").observe(
            dq.answered)
        obs.metrics.histogram("engine.density_evals").observe(dq.evals)
        obs.metrics.histogram("engine.prefix_pairs").observe(g.scanned)
        obs.metrics.histogram("engine.prefix_reads").observe(g.reads)
        storage, comp = ap
        return self._microarch(g, sparse, compute, total_spatial,
                               dense_computes, storage, comp)

    # ---------------- step 1: dataflow (dense traffic) ----------------
    def _dataflow(self, g: _Slots, rb) -> tuple:
        """``dataflow.analyze_dataflow`` for the (R,) rank bounds ``rb``:
        ``(dense, dense_computes, total_spatial)``, ``dense[(tensor,
        level)]`` the level's dense traffic per instance."""
        S = len(self.level_names)
        b, levels = g.b, g.levels
        total_temporal = _prod(b[:, j] for j in self._temporal)
        total_spatial = _prod(b[:, j] for j in self._spatial)

        dense: dict[tuple[str, int], dict] = {}
        for t in self.tensors:
            rel, key = g.rel[t.name], self._rel_key[t.name]
            is_out = t.name == self.output
            for s in range(S):
                tdims = g.tile_dims(t, g.tile_bounds(s + 1))
                tsize = _prod(tdims)
                tl = dict(tile_dims=tdims, tile_size=tsize,
                          fill_words=0.0, partial_fill_words=0.0,
                          read_words=0.0, read_rounds=1.0,
                          update_words=0.0, rmw_read_words=0.0,
                          writeback_words=0.0,
                          instances=_prod(b[:, j] for j in self._spatial
                                          if levels[j] > s))

                # ---- fills into this level from the parent ----
                rounds, distinct = g.fetch_counts(s, key)
                if s < S - 1:
                    if not is_out:
                        tl["fill_words"] = rounds * tsize
                    else:
                        tl["partial_fill_words"] = (rounds - distinct) * tsize

                # ---- reads from this level serving the child below ----
                child_tb = g.tile_bounds(s)
                c_rounds, c_distinct = g.fetch_counts(s - 1, key)
                spatial_here = [j for j in self._spatial if levels[j] == s]
                served_tb = child_tb
                for j in spatial_here:
                    served_tb = served_tb * torch.where(
                        g.oh[..., j, :] & rel, b[:, j, None], 1.0)
                served_words = g.tile_size(t, served_tb)
                tl["read_rounds"] = c_rounds
                if not is_out:
                    tl["read_words"] = c_rounds * served_words
                else:
                    child_tile = g.tile_size(t, child_tb)
                    spatial_rel = _prod(
                        torch.where((g.oh[..., j, :] & rel).any(-1),
                                    b[:, j], 1.0)
                        for j in spatial_here)
                    tl["read_words"] = ((c_rounds - c_distinct) * child_tile
                                        * spatial_rel if s > 0 else 0.0)

                # ---- output update flows ----
                if is_out:
                    fanout = _prod(b[:, j] for j in spatial_here)
                    if s == 0:
                        tl["update_words"] = (total_temporal
                                              * _max(1.0, fanout))
                    else:
                        ce, _cd = g.fetch_counts(s - 1, key)
                        child_tile = g.tile_size(t, g.tile_bounds(s))
                        tl["update_words"] = fanout * ce * child_tile
                    if s < S - 1:
                        tl["rmw_read_words"] = _max(
                            0.0, tl["update_words"] - distinct * tsize)
                        tl["writeback_words"] = rounds * tsize
                    else:
                        tl["rmw_read_words"] = _max(
                            0.0, tl["update_words"]
                            - g.tile_size(t, rb) / _max(1.0, tl["instances"]))

                dense[(t.name, s)] = tl
        return dense, total_temporal * total_spatial, total_spatial

    # ---------------- the density queries ----------------
    def _window(self, g: _Slots, lname: str, level, fname: str) -> tuple:
        """(key, dims) of a leader's tile in its intersection window at
        ``level`` for follower ``fname``."""
        key = ("window", level, self._rel_key[fname])
        bounds = g.once(key, lambda: g.leader_window_bounds(level, key[2]))
        return key, g.once((lname,) + key, lambda: g.tile_dims(
            self._tensor[lname], bounds))

    def _leader_query(self, g: _Slots, lname: str, level,
                      fname: str) -> tuple:
        """A SAF leader's emptiness query on its window tile; at level
        ``s + 1`` with the output as follower, the output's level-``s``
        round tile."""
        key, dims = self._window(g, lname, level, fname)
        return ("pe", lname, key,
                g.once((lname, "tile") + key, lambda: _max(1.0, _prod(dims))))

    def _format_queries(self, g: _Slots, tname: str, s: int, src,
                        tile_dims) -> tuple:
        """A tile (keyed ``src``) in ``tname``'s level-``s`` format:
        ``(fmt, dims, tile size, payloads, queries)``, the format
        analyzer's queries keyed ``("pe", i)``, ``"mx"`` and ``"ed"``."""
        fmt = self._formats[tname, s]
        dims, tsize, payload = g.once((tname, "fmt") + src,
                                      lambda: _format_tile(fmt, tile_dims))
        queries = {}
        for i, (rf, sz) in enumerate(zip(fmt.rank_formats, payload)):
            if rf not in _OCCUPANCY_FREE:
                queries["pe", i] = ("pe", tname, src + (i,), sz)
                queries["mx"] = ("mx", tname, src, tsize)
        if fmt.compressed:
            queries["ed"] = ("ed", tname, src, tsize)
            queries["mx"] = ("mx", tname, src, tsize)
        return fmt, dims, tsize, payload, queries

    def _leader_format(self, g: _Slots, lname: str, level,
                       fname: str) -> tuple:
        return self._format_queries(g, lname, level,
                                    *self._window(g, lname, level, fname))

    def _resident_format(self, g: _Slots, dense, tname: str, s: int):
        return self._format_queries(g, tname, s, ("resident", s),
                                    dense[(tname, s)]["tile_dims"])

    def _ask(self, g: _Slots, dense, dq: _DensityQueries) -> None:
        """Ask every query the sparse step will answer."""
        S = len(self.level_names)
        for _, fname, lvl, lname in self._leaders:
            if lvl is None:
                dq.ask(*_compute_query(lname))
                continue
            dq.ask(*self._leader_query(g, lname, lvl, fname))
            for q in self._leader_format(g, lname, lvl, fname)[-1].values():
                dq.ask(*q)
            if fname == self.output:
                for s in range(S):
                    dq.ask(*self._leader_query(g, lname, s + 1, fname))
        for t in self.tensors:
            for s in range(S):
                for q in self._resident_format(g, dense, t.name,
                                               s)[-1].values():
                    dq.ask(*q)

    def _density(self, wp, stat: str, name: str, tiles):
        i = self._tidx[name]
        return self._stat_fns[stat](wp.model_ids[i], wp.density_params[i],
                                    wp.hist[i], tiles, kinds=(wp.kinds[i],),
                                    table=wp.tables[i])

    # ---------------- step 2: sparse filtering ----------------
    def _gating(self, g: _Slots, dq: _DensityQueries) -> tuple:
        """The gating/skipping analyzer: (skipped, gated) shares per
        ``local[(tensor, level)]`` and per output round ``z_round[s]``,
        and the compute's (actual, gated, skipped) shares."""
        S = len(self.level_names)
        events: dict[tuple[str, int], _Events] = {}
        comp_ev = _Events()
        for kind, fname, lvl, lname in self._leaders:
            if lvl is None:
                comp_ev.add(kind, lname,
                            1.0 - dq.answer(*_compute_query(lname)))
            else:
                events.setdefault((fname, lvl), _Events()).add(
                    kind, lname,
                    dq.answer(*self._leader_query(g, lname, lvl, fname)))
        none = _Events()
        local = {(t.name, s): events.get((t.name, s), none).shares()
                 for t in self.tensors for s in range(S)}

        # output writebacks move whole tiles: the same events at the
        # leader window of the whole level-s residency (level s + 1)
        z_round: dict[int, tuple] = {}
        for s in range(S):
            ev = _Events()
            for kind, fname, lvl, lname in self._leaders:
                if fname == self.output and lvl is not None:
                    ev.add(kind, lname, dq.answer(*self._leader_query(
                        g, lname, s + 1, fname)))
            z_round[s] = ev.shares()

        # compute: implicit (every delivery SAF) and explicit events
        impl = _Events()
        for t in self.tensors:
            for s in range(S):
                if (t.name, s) in events:
                    impl.absorb(events[(t.name, s)])
        impl.absorb(comp_ev)
        c_skip, c_gate = impl.shares()
        return local, z_round, (_max(0.0, 1.0 - c_skip - c_gate), c_gate,
                                c_skip)

    def _propagate(self, local) -> tuple:
        """(live_frac, gated_from_above) per (tensor, level), down the
        hierarchy; level -1 is the compute."""
        live_frac: dict[tuple[str, int], object] = {}
        gated_from_above: dict[tuple[str, int], object] = {}
        for t in self.tensors:
            not_skipped, live = 1.0, 1.0
            for s in range(len(self.level_names) - 1, -1, -1):
                live_frac[(t.name, s)] = live
                gated_from_above[(t.name, s)] = not_skipped - live
                sk, gt = local[(t.name, s)]
                not_skipped = not_skipped * (1.0 - sk)
                live = live * _max(0.0, 1.0 - sk - gt)
            live_frac[(t.name, -1)] = live
            gated_from_above[(t.name, -1)] = not_skipped - live
        return live_frac, gated_from_above

    def _format(self, dq: _DensityQueries, tile) -> dict:
        """``formats.analyze_tile_format`` of a :meth:`_format_queries`
        tile."""
        fmt, dims, tsize, payload, queries = tile
        meta_avg = meta_max = 0.0
        fibers_avg, fibers_max = 1.0, 1.0
        for i, (rf, d, sz) in enumerate(
                zip(fmt.rank_formats, dims, payload)):
            coords_avg = fibers_avg * d
            coords_max = fibers_max * d
            if rf in _OCCUPANCY_FREE:
                # every coordinate is held: no density statistic
                occ_avg, occ_max = coords_avg, coords_max
            else:
                p_ne = 1.0 - dq.answer(*queries["pe", i])
                n_blocks = _prod(dims[: i + 1])
                occ_avg = _min(coords_avg, n_blocks * p_ne)
                occ_max = _max(0.0, _min(
                    coords_max,
                    torch.ceil(dq.answer(*queries["mx"]) / sz)))

            cb = float(fmt.coord_bits)
            if rf == RankFormat.U:
                bits_avg = bits_max = 0.0
            elif rf in (RankFormat.B, RankFormat.UB):
                bits_avg = fibers_avg * d
                bits_max = fibers_max * d
            elif rf in (RankFormat.CP, RankFormat.RLE):
                bits_avg = occ_avg * cb
                bits_max = occ_max * cb
            elif rf == RankFormat.UOP:
                bits_avg = fibers_avg * 2.0 * cb
                bits_max = fibers_max * 2.0 * cb
            else:  # pragma: no cover
                raise BatchedUnsupported(f"rank format {rf}")
            meta_avg = meta_avg + bits_avg
            meta_max = meta_max + bits_max
            fibers_avg, fibers_max = occ_avg, occ_max

        if fmt.is_uncompressed:
            data_avg = data_max = tsize * 1.0
        else:
            data_avg = _min(tsize * 1.0, dq.answer(*queries["ed"]) * tsize)
            data_max = _min(tsize * 1.0, dq.answer(*queries["mx"]))
        return dict(meta_avg=meta_avg, meta_max=meta_max,
                    data_avg=data_avg, data_max=data_max, tile_size=tsize)

    def _level(self, t, s: int, tl: dict, fs: dict, fmt, fr: dict) -> dict:
        """The sparse traffic of ``t`` at level ``s`` from its dense
        traffic ``tl``, format statistics ``fs`` and the fractions
        ``fr`` of :meth:`_gating` and :meth:`_propagate`."""
        live, g_above = fr["live"][(t.name, s)], fr["g_above"][(t.name, s)]
        # transfers OUT of this level (reads serving the child): chain
        # from above + local SAF at this level
        out_fr = _fractions(live, g_above, *fr["local"][(t.name, s)])
        # transfers INTO this level (fills from parent): SAFs above
        in_fr = (live, g_above, _max(0.0, 1.0 - live - g_above))
        # compression shrinks the words actually moved per access
        scale = (fs["data_avg"] / _max(1.0, fs["tile_size"])
                 if fmt.compressed else 1.0)

        if t.name == self.output:
            # updates from below: per MAC at s == 0, per child-tile
            # eviction above
            upd_fr = fr["compute"] if s == 0 else _fractions(
                fr["live"][(t.name, s - 1)], fr["g_above"][(t.name, s - 1)],
                *fr["z_round"][s - 1])
            updates = _breakdown(tl["update_words"], scale, upd_fr)
            # read-modify-write: recomputed from the scaled updates
            distinct_words = tl["update_words"] - tl["rmw_read_words"]
            rmw = _max(0.0, updates.actual - distinct_words)
            # writebacks / partial refetches move whole tiles
            wb_fr = _fractions(live, g_above, *fr["z_round"][s])
            wb = _breakdown(tl["writeback_words"], scale, wb_fr)
            fills = _breakdown(tl["partial_fill_words"], scale, wb_fr)
            reads = _Breakdown(actual=wb.actual + rmw, gated=wb.gated,
                               skipped=wb.skipped)
        else:
            reads = _breakdown(tl["read_words"], scale, out_fr)
            fills = _breakdown(tl["fill_words"], scale, in_fr)
            updates = _Breakdown()

        # metadata moves with actual AND gated accesses, per compressed
        # data word moved; skipped tiles move none
        meta_per_word = fs["meta_avg"] / _max(1e-9, fs["data_avg"]) / WORD_BITS
        has_meta = fs["meta_avg"] > 0
        meta_reads = _where(
            has_meta, (reads.actual + reads.gated) * meta_per_word, 0.0)
        meta_fills = _where(
            has_meta,
            (fills.actual + fills.gated
             + updates.actual + updates.gated) * meta_per_word,
            0.0)
        return dict(reads=reads, fills=fills, updates=updates,
                    meta_reads=meta_reads, meta_fills=meta_fills,
                    occ_max=fs["data_max"] + fs["meta_max"] / WORD_BITS,
                    instances=tl["instances"])

    def _sparse(self, g: _Slots, dense, dense_computes,
                dq: _DensityQueries) -> tuple:
        """``sparse.analyze_sparse``: per-instance ``sparse[(tensor,
        level)]`` traffic and the compute's :class:`_Breakdown`."""
        local, z_round, c_fr = self._gating(g, dq)
        live, g_above = self._propagate(local)
        fr = dict(live=live, g_above=g_above, local=local, z_round=z_round,
                  compute=c_fr)
        sparse: dict[tuple[str, int], dict] = {}
        for t in self.tensors:
            for s in range(len(self.level_names)):
                tile = self._resident_format(g, dense, t.name, s)
                sparse[(t.name, s)] = self._level(
                    t, s, dense[(t.name, s)], self._format(dq, tile),
                    tile[0], fr)

        # intersection-check overhead: every follower access round at a
        # SAF's level reads the leader's metadata (or a 1-bit mask of an
        # uncompressed leader), charged to the follower's level
        for _, fname, lvl, lname in self._leaders:
            if lvl is None:
                continue
            rounds = dense[(fname, lvl)]["read_rounds"]
            ls = self._format(dq, self._leader_format(g, lname, lvl, fname))
            bits = _where(ls["meta_avg"] > 0, ls["meta_avg"],
                          ls["tile_size"] * 1.0)
            sparse[(fname, lvl)]["meta_reads"] = (
                sparse[(fname, lvl)]["meta_reads"]
                + rounds * bits / WORD_BITS)

        c_act, c_gate, c_skip = c_fr
        return sparse, _Breakdown(actual=dense_computes * c_act,
                                  gated=dense_computes * c_gate,
                                  skipped=dense_computes * c_skip)

    # ---------------- step 3: micro-architecture ----------------
    def _microarch(self, g: _Slots, sparse, compute: _Breakdown,
                   total_spatial, dense_computes, storage, comp) -> dict:
        """``microarch.evaluate_microarch`` on per-candidate ``storage``
        (C, S, F) and ``comp`` (C, 4) rows (innermost level first)."""
        C, dev = g.C, g.dev
        valid = torch.ones(C, dtype=torch.bool, device=dev)
        energy = 0.0
        worst_cycles = 0.0
        occupancies = []
        for s in range(len(self.level_names)):
            cap, bw, e_read, e_write, e_gated, e_meta = (
                storage[:, s, c] for c in range(len(STORAGE_FIELDS)))
            ra = rg = wa = wg = meta = occ = 0.0
            inst = 1.0
            for t in self.tensors:
                st = sparse[(t.name, s)]
                inst = _max(inst, st["instances"])
                ra = ra + st["reads"].actual
                rg = rg + st["reads"].gated
                wa = wa + st["fills"].actual + st["updates"].actual
                wg = wg + st["fills"].gated + st["updates"].gated
                meta = meta + st["meta_reads"] + st["meta_fills"]
                occ = occ + st["occ_max"]
            occupancies.append(occ * torch.ones(C, dtype=F64, device=dev))
            if self.check_capacity:
                # an infinite level passes trivially, matching the
                # scalar engine's skip-inf-levels behavior
                valid = valid & (occ <= cap)
            energy = energy + inst * (
                ra * e_read + wa * e_write + (rg + wg) * e_gated
                + meta * e_meta)
            cyc = (ra + rg + wa + wg + meta) / bw
            worst_cycles = _max(worst_cycles, cyc)

        pe_inst, pe_mac_e, pe_gated_e, pe_throughput = (
            comp[:, c] for c in range(len(COMPUTE_FIELDS)))
        n_inst = torch.minimum(
            torch.clamp(total_spatial * torch.ones(C, dtype=F64,
                                                   device=dev), min=1.0),
            pe_inst)
        compute_cycles = ((compute.actual + compute.gated)
                          / (n_inst * pe_throughput))
        energy = energy + (compute.actual * pe_mac_e
                           + compute.gated * pe_gated_e)
        cycles = _max(worst_cycles, compute_cycles)

        def col(x):
            return x * torch.ones(C, dtype=F64, device=dev)

        return {
            "cycles": col(cycles),
            "energy_pj": col(energy),
            "edp": col(cycles * energy),
            "valid": valid,
            "compute_actual": col(compute.actual),
            "compute_gated": col(compute.gated),
            "compute_skipped": col(compute.skipped),
            "dense_computes": col(dense_computes),
            # per-storage-level words held at peak (innermost-first):
            # what the capacity check compares against
            "occupancy": torch.stack(occupancies, 1),
        }
