"""The batched engine's slot geometry (``core.nest_program._Slots``)
against the per-pair formulas it stacks.

One reuse-prefix pass answers every fetch-count and leader-window query
of a program call, and one masked product every level's resident-tile
bounds.  The formulas they replaced scanned each (child level,
relevance) pair's slots on their own; they are kept here as the oracle
(:class:`PerPair`).  Every factor is an integer-valued float64 loop
bound and every partial product stays below 2**53, so the stacked
answers are held to the per-pair ones bitwise (``torch.equal``), not to
a tolerance: on the bucket program and an exact template of every layer
of the benchmark's three configurations, for every pair and level, for
every output of the program, and for the arch gradient."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import nest_program  # noqa: E402
from repro_torch.core.batched import (NestTemplate,  # noqa: E402
                                      TemplateBucket, get_batched_model,
                                      get_bucketed_model)
from repro_torch.core.mapper import MapspaceConstraints  # noqa: E402
from repro_torch.search import SearchConfig, run_search  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("scnn-resnet50", "eyeriss-v2saf-mobilenet",
           "deepseek-v2-lite-stc")
LAYERS = [(c, i, lay["name"]) for c in CONFIGS for i, lay in enumerate(
    json.loads((ROOT / "portbench" / "configs" / f"{c}.json")
               .read_text())["layers"])]


def _suffix_any(mask):
    return torch.flip(torch.cumsum(torch.flip(mask, (-1,)).to(torch.int32),
                                   -1), (-1,)) > 0


class PerPair(nest_program._Slots):
    """Each query scans its own slots, as ``dataflow.fetch_counts`` and
    ``dataflow.leader_tile_bounds`` read: the per-pair formulas."""

    def masked_prod(self, js):
        if not js:
            return torch.ones(len(self.prog.ranks), dtype=torch.float64)
        sel = torch.as_tensor(js)
        return torch.where(self.oh[..., sel, :], self.b[:, sel, None],
                           1.0).prod(-2)

    def tile_bounds(self, level):
        return self.masked_prod([j for j in range(self.prog.num_slots)
                                 if self.levels[j] < level])

    def _reuse_prefix(self, js, rel_key):
        sel = torch.as_tensor(js)
        bs = self.b[:, sel]
        rel_arr = (self.oh[..., sel, :] & torch.as_tensor(rel_key)).any(-1)
        return sel, bs, rel_arr, _suffix_any(rel_arr & (bs > 1))

    def fetch_counts(self, child_level, rel_key):
        js = [j for j in self.prog._temporal if self.levels[j] > child_level]
        if not js:
            return 1.0, 1.0
        _, bs, rel_arr, in_prefix = self._reuse_prefix(js, rel_key)
        return (torch.where(in_prefix, bs, 1.0).prod(-1),
                torch.where(in_prefix & rel_arr, bs, 1.0).prod(-1))

    def leader_window_bounds(self, level, follower_key):
        bounds = self.tile_bounds(level)
        outer = [j for j in self.prog._temporal if self.levels[j] >= level]
        if outer:
            sel, bs, _, in_prefix = self._reuse_prefix(outer, follower_key)
            bounds = bounds * torch.where(
                self.oh[..., sel, :] & ~in_prefix[..., None], bs[..., None],
                1.0).prod(-2)
        return bounds


def _config(name):
    """The benchmark's configuration ``name`` (its harness reads the
    file; the benchmark is no package these tests import otherwise)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness.config import Config
    return Config.load(name)


def _programs(monkeypatch, name: str, index: int) -> tuple:
    """(program, args, workload leaves) of layer ``index`` of ``name``:
    the bucket program of a small fused CPU search as it was called, and
    an exact template of the most common loop order of that population
    on the same candidates' bounds and arch rows; and the bucket's
    facade."""
    cfg = _config(name)
    design = cfg.program_design()
    wl = cfg.program_workload(cfg.layers[index])
    calls = []
    real = nest_program.NestProgram.__call__

    def spy(prog, args, wp):
        calls.append((prog, args, wp))
        return real(prog, args, wp)

    with monkeypatch.context() as m:
        m.setattr(nest_program.NestProgram, "__call__", spy)
        run_search(design, wl, MapspaceConstraints(
            spatial=cfg.spatial(design), budget=64), strategy="es", key=3,
            generations=2, pop_size=32, fused=True,
            config=SearchConfig(fused_chunk=1),
            check_capacity=cfg.check_capacity, mesh=None, device="cpu")
    prog, (b, ids, (storage, comp)), wp = calls[-1]
    assert prog.onehot is None
    orders, counts = torch.unique(ids, dim=0, return_counts=True)
    order = orders[counts.argmax()]
    rows = (ids == order).all(1)
    ranks = prog.ranks
    template = NestTemplate(slots=tuple(
        (ranks[int(r)], lvl, j in prog._spatial) for j, (r, lvl) in
        enumerate(zip(order, prog.slot_levels))),
        num_levels=len(prog.level_names))
    bm = get_batched_model(design, wl, template,
                           check_capacity=cfg.check_capacity, device="cpu")
    S = len(prog.level_names)
    bucket = TemplateBucket(ranks=ranks, **{
        kind: tuple(sum(lv == s and (j in prog._spatial) == spatial
                        for j, lv in enumerate(prog.slot_levels))
                    for s in range(S))
        for kind, spatial in (("temporal_slots", False),
                              ("spatial_slots", True))})
    facade = get_bucketed_model(design, wl, bucket,
                                check_capacity=cfg.check_capacity,
                                device="cpu")
    return [(prog, (b, ids, (storage, comp)), wp),
            (bm._prog.fn, (b[rows], (storage[rows], comp[rows])),
             bm._bind_params(None))], facade


def _onehot(prog, args):
    if prog.onehot is not None:
        return torch.as_tensor(prog.onehot)
    return args[1].long()[..., None] == torch.arange(len(prog.ranks))


def _run(monkeypatch, prog, args, wp, slots):
    """The program's outputs with ``slots`` as its geometry, and the
    gradient of the summed EDP with respect to the arch rows."""
    storage, comp = (x.detach().clone().requires_grad_()
                     for x in args[-1])
    with monkeypatch.context() as m:
        m.setattr(nest_program, "_Slots", slots)
        out = prog((*args[:-1], (storage, comp)), wp)
    grads = torch.autograd.grad(out["edp"].sum(), (storage, comp),
                                allow_unused=True)
    return {k: v.detach() for k, v in out.items()}, grads


def _same(a, b) -> bool:
    if not isinstance(a, torch.Tensor):
        return not isinstance(b, torch.Tensor) and a == b
    return torch.equal(a, b.expand_as(a))


@pytest.mark.parametrize("name,index", [(c, i) for c, i, _ in LAYERS],
                         ids=[f"{c}-{lay}" for c, _, lay in LAYERS])
def test_stacked_geometry_is_the_per_pair_answers(monkeypatch, name, index):
    """Bucket and exact template of one layer: every pair's fetch counts
    and leader window, every level's tile bounds, every output and the
    arch gradient equal the per-pair formulas' bitwise."""
    programs, facade = _programs(monkeypatch, name, index)
    for prog, args, wp in programs:
        b, oh = args[0], _onehot(prog, args)
        stacked = nest_program._Slots(prog, b, oh)
        per_pair = PerPair(prog, b, oh)
        S = len(prog.level_names)
        keys = set(prog._rel_key.values())
        for level in range(S + 1):
            assert _same(stacked.tile_bounds(level),
                         per_pair.tile_bounds(level))
            for key in keys:
                assert _same(stacked.leader_window_bounds(level, key),
                             per_pair.leader_window_bounds(level, key))
                for got, want in zip(stacked.fetch_counts(level - 1, key),
                                     per_pair.fetch_counts(level - 1, key)):
                    assert _same(got, want), (level - 1, key)
        assert stacked.scanned == len(prog._pairs) > 0

        out, grads = _run(monkeypatch, prog, args, wp, nest_program._Slots)
        ref, ref_grads = _run(monkeypatch, prog, args, wp, PerPair)
        assert out.keys() == ref.keys()
        for k in out:
            assert torch.equal(out[k], ref[k]), k
        assert any(g is not None for g in grads)
        for g, r in zip(grads, ref_grads):
            assert (g is None and r is None) or torch.equal(g, r)

    # the bucket's facade: one evaluate_with_arch_grad call each way
    b, ids = (programs[0][1][i].numpy().astype(np.int64) for i in (0, 1))
    grads = []
    for slots in (nest_program._Slots, PerPair):
        with monkeypatch.context() as m:
            m.setattr(nest_program, "_Slots", slots)
            grads.append(facade.evaluate_with_arch_grad(
                b, ids, metric="edp", surrogate=True))
    got, want = grads
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slots_out_of_level_order_are_the_per_pair_answers(seed):
    """The stacked scan keeps to each pair's own slots, so a template
    whose slots are not ordered outermost level first (no ``LoopNest``
    is, but a program takes any layout) gets the per-pair answers too:
    every pair's fetch counts and leader window and every level's tile
    bounds, bitwise, on bounds drawn with unit loops among them."""
    cfg = _config(CONFIGS[0])
    design = cfg.program_design()
    wl = cfg.program_workload(cfg.layers[0])
    template = NestTemplate(slots=(
        ("m", 0, False), ("n", 2, False), ("k", 1, False), ("m", 2, False),
        ("n", 1, False), ("k", 0, False), ("m", 1, True)), num_levels=3)
    prog = get_batched_model(design, wl, template, device="cpu")._prog.fn
    b = torch.as_tensor(np.random.default_rng(seed).integers(
        1, 4, (64, prog.num_slots)), dtype=torch.float64)
    oh = torch.as_tensor(prog.onehot)
    stacked = nest_program._Slots(prog, b, oh)
    per_pair = PerPair(prog, b, oh)
    for level in range(len(prog.level_names) + 1):
        assert _same(stacked.tile_bounds(level), per_pair.tile_bounds(level))
        for key in set(prog._rel_key.values()):
            assert _same(stacked.leader_window_bounds(level, key),
                         per_pair.leader_window_bounds(level, key))
            for got, want in zip(stacked.fetch_counts(level - 1, key),
                                 per_pair.fetch_counts(level - 1, key)):
                assert _same(got, want), (level - 1, key)
