"""The ``causal_topk`` density kind: a top-k selection inside each row's
causal support, the attention map of DeepSeek-V3.2's sparse attention.

The JAX package lacks the kind, so the port is held to the benchmark's
plain-PyTorch brute force (``portbench/reference/causal_topk_mask.py``):
its tile-by-tile, row-by-row ``math.comb`` statistics at every tile size
of small tensors, to 1e-12 (float64's rounding of a product of up to 40
ratios), and the mean of seeded selections, within 4 standard errors.
The scalar model, the tensor forms behind ``TracedDensityStats`` and the
instance wrappers each answer.  A ``k`` of at least the window is the
``causal`` kind bit for bit; a malformed ``k`` or window is refused.  The
kind costs the benchmark's other configurations nothing: their programs
dispatch the ops they did before it (PERF.md §5), and only a program
that evaluates the kind observes ``fused.graph_kernels.causal_topk``.
"""
import collections
import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import density as port  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "portbench" / "reference"
STATS = ("prob_empty", "expected_density", "max_nnz")


def _load(path: Path):
    """A file of the benchmark's reference, by path."""
    spec = importlib.util.spec_from_file_location("topk_ref_" + path.stem,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BF = _load(REFERENCE / "causal_topk_mask.py")


def _answers(m, tiles):
    """Each statistic at ``tiles`` from the scalar model, the tensor forms
    behind ``TracedDensityStats`` (the kind a tensor, every kind
    evaluated and selected, the caps rounded up, their bound on distinct
    tile sizes widened to the sizes asked: the engine asks only the
    tensor's ``d * e``, these tests every size) and the wrappers."""
    scalar = [tuple(getattr(m, s)(t) for s in STATS) for t in tiles]
    caps = port.caps_for_models([m])
    stats = port.TracedDensityStats(dataclasses.replace(
        caps, tiles=max(caps.tiles, len(tiles))))
    params = torch.as_tensor(m.params())
    tt = torch.tensor(tiles, dtype=torch.float64)
    kind = torch.tensor(m.kind_id)
    traced = list(zip(*(getattr(stats, s)(kind, params, None, tt).tolist()
                        for s in STATS)))
    wrapped = list(zip(*(getattr(m, s + "_b")(tt).tolist() for s in STATS)))
    return {"scalar": scalar, "traced": traced, "wrapped": wrapped}


# ----------------------------------------------------------------------
# against the brute force
# ----------------------------------------------------------------------
SHAPES = [(1, 1), (1, 40), (40, 1), (40, 40), (13, 29), (29, 13), (24, 24)]


@pytest.mark.parametrize("window", ["one", "below", "at", "above"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_statistics_equal_the_exact_tile_by_tile_ones(shape, window):
    """Every tile size 1..rows*cols and one past it, k from 1 to past the
    window: each form gives the brute force's ``math.comb`` statistics
    to 1e-12 and its ``max_nnz`` exactly."""
    rows, cols = shape
    w = {"one": 1, "below": max(1, rows // 2), "at": rows,
         "above": rows + 7}[window]
    tiles = list(range(1, rows * cols + 1)) + [rows * cols + 5]
    held = min(w, rows)
    for k in sorted({1, 2, max(1, held - 1), held, held + 3}):
        m = port.CausalTopkModel(rows=rows, cols=cols, window=w, k=k)
        want = [BF.exact(rows, cols, held, k, t) for t in tiles]
        for form, got in _answers(m, tiles).items():
            for t, g, e in zip(tiles, got, want):
                assert abs(g[0] - e[0]) <= 1e-12, (form, k, t, g, e)
                assert abs(g[1] - e[1]) <= 1e-12, (form, k, t, g, e)
                assert int(g[2]) == e[2], (form, k, t, g, e)


@pytest.mark.parametrize("rows, cols, window, k", [
    (24, 36, 10, 3), (32, 32, 32, 5), (20, 48, 6, 6)])
def test_the_mean_of_seeded_selections_agrees(rows, cols, window, k):
    """2,000 seeded selections (``BF.masks``): per tile size, the share of
    empty tiles and the density averaged over the selections lie within
    4 standard errors of ``prob_empty`` and ``expected_density``, and no
    selection puts more in a tile than ``max_nnz``.  A standard error is
    the sample's, or where a tile's emptiness is too rare for the sample
    to show, the one its tiles' own probabilities give (a row's
    selection makes its tiles' emptiness negatively correlated, so the
    independent tiles' variance bounds the share's)."""
    m = port.CausalTopkModel(rows=rows, cols=cols, window=window, k=k)
    n = 2000
    masks = BF.masks(rows, cols, window, k, n, seed=rows * 1000 + k)
    assert int(masks.sum()) == n * round(m.density * rows * cols)
    for t in (1, 2, 3, 4, 6, 8, 12, 16, 36, 64, 96):
        counts = BF.tile_counts(masks, t).double()
        each = BF.tiles(rows, cols, window, k, t)
        var = sum(p * (1 - p) for p, _, _ in each) / len(each) ** 2
        for got, want, floor in (((counts == 0).double().mean((1, 2)),
                                  m.prob_empty(t), math.sqrt(var / n)),
                                 (counts.mean((1, 2)) / t,
                                  m.expected_density(t), 0.0)):
            se = max(float(got.std()) / math.sqrt(n), floor)
            assert abs(float(got.mean()) - want) <= 4 * se + 1e-12, \
                (t, float(got.mean()), want, se)
        assert int(counts.amax()) <= m.max_nnz(t), t


# ----------------------------------------------------------------------
# k at least the window is the causal map
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rows, cols, window", [
    (12, 12, 12), (9, 16, 3), (16, 7, 40), (1, 10, 1), (10, 1, 4),
    (33, 20, 8)])
def test_k_at_least_the_window_is_the_causal_map(rows, cols, window):
    """Scalar, traced and wrapped forms equal the ``causal`` kind's bit
    for bit, for k at the window, one past it and far past it."""
    tiles = list(range(1, rows * cols + 1)) + [rows * cols + 3]
    causal = _answers(port.CausalModel(rows=rows, cols=cols, window=window),
                      tiles)
    for k in (min(window, rows), window + 1, 10 ** 6):
        topk = port.CausalTopkModel(rows=rows, cols=cols, window=window, k=k)
        assert topk.density == port.CausalModel(rows, cols, window).density
        assert _answers(topk, tiles) == causal, k


def test_the_tensor_forms_answer_alike_at_any_caps():
    """The forms at a tensor's own caps and at the DSA cell's (the fixed
    point and the row type follow the caps): the same to 1e-12."""
    m = port.CausalTopkModel(rows=24, cols=40, window=9, k=4)
    params = torch.as_tensor(m.params())
    tt = torch.tensor(list(range(1, 97)) + [480, 960, 961],
                      dtype=torch.float64)
    for name in STATS:
        fn = getattr(port, f"causal_topk_{name}_t")
        torch.testing.assert_close(
            fn(params, None, tt, port.DensityCaps(coord=24, div=31)),
            fn(params, None, tt, port.DensityCaps(coord=1 << 15,
                                                  div=1 << 15)),
            rtol=0, atol=1e-12)


def test_the_scalar_and_tensor_forms_agree_at_the_dsa_cells_size():
    """attn_av's P (32,768 x 32,768, k 2,048) at the tile sizes of its
    searches' shapes: the scalar model's float sums and the tensor
    forms' int64 fixed point agree to 1e-13."""
    n = 32768
    m = port.CausalTopkModel(rows=n, cols=n, window=n, k=2048)
    tiles = [1, 2, 3, 7, 8, 16, 48, 64, 96, 1024, 6144, 2 ** 20, n * n]
    got = _answers(m, tiles)
    for form in ("traced", "wrapped"):
        for t, g, e in zip(tiles, got[form], got["scalar"]):
            assert abs(g[0] - e[0]) <= 1e-13 and abs(g[1] - e[1]) <= 1e-13 \
                and int(g[2]) == e[2], (form, t, g, e)


# ----------------------------------------------------------------------
# once a distinct tile size: the table and its bound
# ----------------------------------------------------------------------
def _products(rows, cols):
    """``{d * e : d | rows, e | cols}`` by brute force."""
    def divisors(n):
        return [d for d in range(1, n + 1) if n % d == 0]
    return sorted({d * e for d in divisors(rows) for e in divisors(cols)})


#: (rows, cols, window, k): attn_av's P and a small tensor
TABLE_CASES = [(32768, 32768, 32768, 2048), (24, 40, 9, 4)]


def _stacks(rows, cols):
    """(C, Q) stacks of the tensor's tile sizes with repeats: drawn from
    the products, all of them (as many as the unrounded bound), and the
    products with other sizes up to the rounded bound exactly."""
    sizes = _products(rows, cols)
    g = torch.Generator().manual_seed(rows + cols)
    drawn = torch.tensor(sizes, dtype=torch.float64)[
        torch.randint(len(sizes), (8, 6), generator=g)]
    every = torch.tensor(sizes * 2, dtype=torch.float64).view(2, -1)
    cap = port.caps_for_models([port.CausalTopkModel(
        rows=rows, cols=cols, window=1, k=1)]).tiles
    others = [t for t in range(1, 10 * cap) if t not in set(sizes)]
    rounded = torch.tensor(sizes + others[:cap - len(sizes)],
                           dtype=torch.float64).flip(0).repeat(3, 1)
    return {"drawn": drawn, "every": every, "rounded": rounded}


@pytest.mark.parametrize("case", TABLE_CASES, ids=lambda c: f"{c[0]}x{c[1]}")
def test_the_table_answers_as_the_direct_forms(case):
    """Each statistic once a distinct tile size equals the direct forms
    on every tile of the stack to 1e-13 relative (the strips' sums are
    int64; only ``prob_empty``'s float sum over rows may take another
    order with the shape), through ``_by_distinct_tile``, at a stack
    whose distinct sizes equal the bound exactly too, and through
    ``TracedDensityStats``' lookup in the tensor's table where the stack
    holds only its ``d * e`` sizes."""
    rows, cols, window, k = case
    m = port.CausalTopkModel(rows=rows, cols=cols, window=window, k=k)
    caps = port.caps_for_models([m])
    exact = port.caps_for_models([m], round_pow2=False)
    stats = port.TracedDensityStats(caps)
    table = port.stat_table(m.kind_id, m.params(), caps)
    params = torch.as_tensor(m.params())
    kind = torch.tensor(m.kind_id)
    for label, tiles in _stacks(rows, cols).items():
        bound = exact if label == "every" else caps
        assert len(set(tiles.view(-1).tolist())) <= bound.tiles
        for name in STATS:
            fn = getattr(port, f"causal_topk_{name}_t")
            direct = fn(params, None, tiles, caps)
            for got in (port._by_distinct_tile(fn, params, tiles, bound),
                        getattr(stats, name)(kind, params, None, tiles,
                                             table=table)
                        if label != "rounded" else direct):
                assert got.shape == tiles.shape
                torch.testing.assert_close(got, direct, rtol=1e-13, atol=0,
                                           msg=f"{label} {name}")


@pytest.mark.parametrize("rows, cols", [(1, 1), (1, 40), (13, 29), (24, 40),
                                        (36, 36), (97, 60), (2048, 2048)])
def test_the_bound_counts_the_products_of_divisors(rows, cols):
    """``caps_for_models`` gives a causal_topk tensor ``|{d * e}|``
    (rounded up to a power of two by default), and only that kind: a
    causal tensor of the same shape needs no table."""
    want = len(_products(rows, cols))
    m = port.CausalTopkModel(rows=rows, cols=cols, window=rows, k=1)
    assert port.caps_for_models([m], round_pow2=False).tiles == want
    assert m._self_caps().tiles == want
    assert port.caps_for_models([m]).tiles == port._pow2_cap(want)
    assert port.caps_for_models(
        [port.CausalModel(rows=rows, cols=cols, window=rows)]).tiles == 0


def test_the_bound_is_merged_covered_and_enforced():
    """32 at attn_av's 32,768 x 32,768 (2**0 .. 2**30); ``merge`` and
    ``covers`` carry the bound, a positional ``DensityCaps`` keeps its
    meaning, and ``pack_workload_params`` refuses caps short of it."""
    from repro_torch.core import matmul
    from repro_torch.core.batched import common_caps, pack_workload_params
    n = 32768
    dsa = port.CausalTopkModel(rows=n, cols=n, window=n, k=2048)
    assert port.caps_for_models([dsa], round_pow2=False).tiles == 31
    assert port.caps_for_models([dsa]) == port.DensityCaps(
        coord=n, div=n, hist=0, tiles=32)
    assert port.DensityCaps(1, 2, 3) == port.DensityCaps(
        coord=1, div=2, hist=3, tiles=0)
    a, b = port.DensityCaps(coord=8, tiles=4), port.DensityCaps(tiles=16)
    assert a.merge(b) == port.DensityCaps(coord=8, tiles=16)
    assert a.merge(b).covers(b) and not a.covers(b)
    wl = matmul(24, 40, 8, densities={
        "A": ("causal_topk", {"rows": 24, "cols": 40, "window": 9, "k": 4}),
        "B": ("dense", None)})
    caps = common_caps([wl])
    assert caps.tiles == 32
    assert pack_workload_params(wl, caps).caps == caps
    assert pack_workload_params(wl, dataclasses.replace(caps, tiles=28))
    with pytest.raises(ValueError, match="do not cover"):
        pack_workload_params(wl, dataclasses.replace(caps, tiles=27))


def test_a_stack_past_the_bound_answers_nan_where_the_table_cannot_hold():
    """More distinct sizes than the bound: the table holds the smallest,
    so those tiles answer exactly and every larger one NaN (never a
    neighbour's value); caps without a bound evaluate every tile."""
    m = port.CausalTopkModel(rows=24, cols=40, window=9, k=4)
    params = torch.as_tensor(m.params())
    caps = port.caps_for_models([m])
    tiles = torch.tensor([[960, 1, 7, 2, 960], [3, 7, 480, 5, 1]],
                         dtype=torch.float64)
    held = tiles <= 3                  # the 3 smallest of 7 distinct sizes
    for name in STATS:
        fn = getattr(port, f"causal_topk_{name}_t")
        direct = fn(params, None, tiles, caps)
        got = port._by_distinct_tile(fn, params, tiles,
                                     dataclasses.replace(caps, tiles=3))
        assert torch.equal(got[held], direct[held]), name
        assert bool(got[~held].isnan().all()), (name, got)
        unbound = dataclasses.replace(caps, tiles=0)
        assert torch.equal(port._by_distinct_tile(fn, params, tiles,
                                                  unbound), direct)
        stats = port.TracedDensityStats(unbound)
        assert torch.equal(getattr(stats, name)(
            torch.tensor(m.kind_id), params, None, tiles), direct)


def test_a_search_asks_the_kind_only_at_products_of_divisors(monkeypatch):
    """Two small fused CPU searches of a layer built like attn_av (T
    2,048, k 128, 512 columns, the DSA cell's design and spatial split):
    the kind's forms run only to build the layer's table, once, before
    the fused step, at the tensor's ``{d * e}`` (``engine.topk_table_rows``
    counts 3, one a statistic, not 6); every tile the step asks lies in
    ``{d * e}`` and its lookup answers finite, each lookup observed on
    ``engine.topk_tiles``; no intermediate of a lookup holds more than
    its stack or the table; and each winner passed the scalar oracle."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core import matmul
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.search import SearchConfig, run_search
    from repro_torch.search import fused as F
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness.config import Config

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    self.numel = max(self.numel, o.numel())
            return out

    T, k = 2048, 128
    sizes = set(_products(T, T))
    calls, seen, inside = [], [], [False]

    def spied(fn):
        def spy(p, h, t, caps):
            calls.append((fn.__name__, inside[0], caps,
                          tuple(t.tolist())))
            return fn(p, h, t, caps)
        return spy
    monkeypatch.setitem(port.TABLE_STATS, port.CAUSAL_TOPK_ID, tuple(
        spied(fn) for fn in port.TABLE_STATS[port.CAUSAL_TOPK_ID]))
    real_step, real_lookup = F.FusedProgram._step, port._table_lookup

    def step(self, st, wp):
        inside[0] = True
        try:
            return real_step(self, st, wp)
        finally:
            inside[0] = False

    def lookup(table, stat, t):
        with Largest() as big:
            out = real_lookup(table, stat, t)
        seen.append((t.clone(), table, big.numel, out))
        return out
    monkeypatch.setattr(F.FusedProgram, "_step", step)
    monkeypatch.setattr(port, "_table_lookup", lookup)
    monkeypatch.setattr(obs.metrics, "REGISTRY", obs.metrics.Registry())
    cfg = Config.load("deepseek-v3.2-dsa-stc")
    design = cfg.program_design()
    wl = matmul(T, T, 512, name="attn_av", densities={
        "A": ("causal_topk", {"rows": T, "cols": T, "window": T, "k": k}),
        "B": ("dense", None)})
    clear_caches()
    try:
        results = [run_search(design, wl,
                              MapspaceConstraints(
                                  spatial=cfg.spatial(design), budget=64),
                              strategy="es", key=key, generations=2,
                              pop_size=32, fused=True,
                              config=SearchConfig(fused_chunk=1),
                              device="cpu", mesh=None) for key in (5, 6)]
    finally:
        clear_caches()
    for res in results:
        assert res.best is not None and res.best.result.valid
    assert [(name, step_) for name, step_, *_ in calls] == [
        (f"causal_topk_{s}_t", False) for s in STATS]
    caps = calls[0][2]
    assert caps.tiles == port._pow2_cap(len(sizes)) == 32
    assert all(t == tuple(map(float, sorted(sizes))) for *_, t in calls)
    assert seen
    for tiles, table, largest, out in seen:
        asked = set(tiles.view(-1).tolist())
        assert asked <= sizes, sorted(asked - sizes)
        assert bool(torch.isfinite(out).all())
        assert table.shape == (4, caps.tiles)
        assert largest <= max(table.numel(), tiles.numel()), largest
    snap = obs.metrics.snapshot()
    told, rows = snap["engine.topk_tiles"], snap["engine.topk_table_rows"]
    assert told["count"] == len(seen)
    assert told["sum"] == sum(t.numel() for t, *_ in seen)
    assert (rows["count"], rows["sum"]) == (3, 3 * len(sizes))


@pytest.mark.parametrize("kind", ["causal_topk", "causal_block_topk"])
def test_the_leaf_equals_the_instance_route(kind):
    """The engine's table of a 2,048^2 causal_topk tensor (k 128) and of
    a 96^2 causal_block_topk one (block 8, k 2, init 1, local 1): its
    sizes are the tensor's sorted ``{d * e}``, padded with the largest
    and its answers to the caps' width; at the model's own caps its
    three rows equal the instance wrappers (``_by_distinct_tile`` on a
    table of as many rows) at every size bit for bit (``torch.equal``),
    and at the engine's caps the in-graph table route the engine took
    before the leaf (``_by_distinct_tile`` at those caps); a size that
    is no ``d * e`` answers NaN through the lookup."""
    m = (port.CausalTopkModel(rows=2048, cols=2048, window=2048, k=128)
         if kind == "causal_topk"
         else port.CausalBlockTopkModel(96, 96, 8, 2, 1, 1))
    sizes = _products(m.rows, m.cols)
    tt = torch.tensor(sizes, dtype=torch.float64)
    own = port.stat_table(m.kind_id, m.params(), m._self_caps())
    assert own.shape == (4, len(sizes))
    assert torch.equal(own[0], tt)
    for j, name in enumerate(STATS, 1):
        assert torch.equal(own[j], getattr(m, name + "_b")(tt)), name
    caps = port.caps_for_models([m])
    table = port.stat_table(m.kind_id, m.params(), caps)
    assert table.shape == (4, caps.tiles) and caps.tiles > len(sizes)
    pad = table[:, len(sizes):]
    assert torch.equal(pad, table[:, len(sizes) - 1:len(sizes)].expand_as(
        pad))
    assert float(pad[0, 0]) == sizes[-1]
    params = torch.as_tensor(m.params())
    for j, fn in enumerate(port.TABLE_STATS[m.kind_id], 1):
        assert torch.equal(table[j, :len(sizes)], port._by_distinct_tile(
            fn, params, tt, caps)), fn.__name__
    stats = port.TracedDensityStats(caps)
    odd = [next(t for t in range(1, sizes[-1]) if t not in set(sizes)),
           sizes[-1] + 1]
    asked = torch.tensor([[sizes[0], odd[0]], [odd[1], sizes[-1]]],
                         dtype=torch.float64)
    for j, name in enumerate(STATS, 1):
        got = getattr(stats, name)(m.kind_id, params, None, asked,
                                   table=table)
        assert bool(got[0, 1].isnan() and got[1, 0].isnan()), (name, got)
        assert torch.equal(got[[0, 1], [0, 1]],
                           table[j, [0, len(sizes) - 1]]), name


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------
@pytest.mark.parametrize("bad", [{"k": 0}, {"k": -3}, {"k": 2.5},
                                 {"k": True}, {"k": None}, {"window": 0},
                                 {"window": 1.5}, {"rows": 0}, "no k",
                                 "no window"])
def test_a_malformed_k_or_window_is_refused(bad):
    spec = {"rows": 8, "cols": 8, "window": 8, "k": 2}
    if isinstance(bad, str):
        del spec[bad.split()[1]]
    else:
        spec.update(bad)
    with pytest.raises(ValueError, match="causal_topk"):
        port.make_density_model(("causal_topk", spec), 64)


# ----------------------------------------------------------------------
# what the other configurations pay: nothing
# ----------------------------------------------------------------------
#: non-view aten ops of one warm ``traced_single`` call (PERF.md §5; the
#: DSA and MSA cells' attn_av are the table kinds' programs, which look
#: their statistics up in the layer's table)
OPS = {("scnn-resnet50", "conv2_x"): 1213,
       ("eyeriss-v2saf-mobilenet", "pw1"): 1235,
       ("deepseek-v2-lite-stc", "mla_q_proj"): 985,
       ("deepseek-v2-lite-stc", "attn_av"): 1214,
       ("deepseek-v3.2-dsa-stc", "mla_q_a_proj"): 985,
       ("deepseek-v3.2-dsa-stc", "attn_av"): 955,
       ("minimax-m3-msa-stc", "attn_av"): 955}


@pytest.mark.parametrize("config, layer", sorted(OPS),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_the_benchmark_programs_dispatch_the_ops_they_did(config, layer):
    """Each configuration's program, as a small fused CPU search runs it:
    one warm call dispatches the ops it did before the kind came, and
    attn_av's of the DSA and MSA cells only their statistics' lookups
    besides (their tables are built before the call)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.batched import BucketedModel
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.search import SearchConfig, run_search
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.harness.config import Config

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    cfg = Config.load(config)
    lay = next(lay for lay in cfg.layers if lay.name == layer)
    design = cfg.program_design()
    calls = []
    real = BucketedModel.traced_single

    def spy(self, *args):
        calls.append((self, args))
        return real(self, *args)
    BucketedModel.traced_single = spy
    try:
        run_search(design, cfg.program_workload(lay),
                   MapspaceConstraints(spatial=cfg.spatial(design),
                                       budget=64),
                   strategy="es", key=3, generations=1, pop_size=32,
                   fused=True, config=SearchConfig(fused_chunk=1),
                   device="cpu", mesh=None)
    finally:
        BucketedModel.traced_single = real
    bm, args = calls[0]
    with torch.no_grad(), Count() as c:
        out = bm.traced_single(*args)
    assert out["cycles"].shape == (32,)
    assert sum(c.ops.values()) == OPS[config, layer], c.ops.most_common(8)


def test_only_a_causal_topk_capture_observes_its_histogram(monkeypatch):
    """A capture's kernel count goes to ``fused.graph_kernels.causal_topk``
    where the program's workload holds a causal_topk tensor, and to no
    kind's histogram where it holds neither causal kind (the count is
    given: the capture itself needs a card)."""
    from repro_torch.core.batched import DeviceLeaves
    from repro_torch.search import fused as F
    monkeypatch.setattr(obs.metrics, "REGISTRY", obs.metrics.Registry())
    F.FusedProgram._observe_kernels(
        1407, DeviceLeaves(*(None,) * 4, kinds=(port.UNIFORM_ID,) * 2))
    F.FusedProgram._observe_kernels(
        1700, DeviceLeaves(*(None,) * 4,
                           kinds=(port.CAUSAL_TOPK_ID, port.DENSE_ID)))
    snap = obs.metrics.snapshot()
    assert snap["fused.graph_kernels"]["count"] == 2
    topk = snap["fused.graph_kernels.causal_topk"]
    assert (topk["count"], topk["mean"]) == (1, 1700.0)
    assert "fused.graph_kernels.causal" not in snap


def test_the_fused_spans_name_the_kind(monkeypatch):
    """A fused CPU search over a causal_topk operand: its ``engine.*``
    spans carry ``causal_topk`` among ``density_kinds``, and its winner
    passed the scalar oracle."""
    from repro_torch.core import matmul
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.core.presets import stc_like
    from repro_torch.search import SearchConfig, run_search
    wl = matmul(64, 64, 16, densities={
        "A": ("causal_topk", {"rows": 64, "cols": 64, "window": 64,
                              "k": 8}),
        "B": ("dense", None)})
    clear_caches()
    tr = obs.enable()
    try:
        res = run_search(stc_like(n=2, m=4, fmt_kind="RLE"), wl,
                         MapspaceConstraints(budget=96, seed=0),
                         strategy="es", key=7, generations=3, pop_size=32,
                         fused=True, config=SearchConfig(fused_chunk=2),
                         device="cpu")
        kinds = {tuple(s.attrs["density_kinds"]) for s in tr.spans
                 if s.name in ("engine.compile", "engine.eval")
                 and s.attrs.get("kind") == "fused"}
    finally:
        obs.disable()
    assert kinds == {("causal_topk", "dense")}
    assert res.best is not None and res.best.result.valid


@pytest.mark.gpu
def test_cuda_the_tensor_forms_equal_the_cpus():
    """On the card, at the DSA cell's caps: the forms give the CPU's
    answers to 1e-13 (the strips' sums are integers, but the card's
    ``exp``, ``log1p`` and float prefix sums round otherwise) and
    ``max_nnz`` exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 32768
    m = port.CausalTopkModel(rows=n, cols=n, window=n, k=2048)
    caps = port.caps_for_models([m])
    tiles = torch.tensor([[1, 2, 3, 8, 48, 1024, 2 ** 20, n * n]] * 3,
                         dtype=torch.float64)
    params = torch.as_tensor(m.params())
    for name in STATS:
        fn = getattr(port, f"causal_topk_{name}_t")
        cpu = fn(params, None, tiles, caps)
        card = fn(params.cuda(), None, tiles.cuda(), caps).cpu()
        torch.testing.assert_close(card, cpu, rtol=1e-13, atol=0)


@pytest.mark.gpu
def test_cuda_the_table_equals_the_direct_forms_at_the_cells_stacks():
    """On the card, a generation's stacks at attn_av's P and the cell's
    caps ((1,024, 6) and (1,024, 4) tiles of its 31 sizes): each
    statistic looked up through ``TracedDensityStats`` in the table
    built on the card equals the direct forms to 1e-13 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 32768
    m = port.CausalTopkModel(rows=n, cols=n, window=n, k=2048)
    caps = port.caps_for_models([m])
    stats = port.TracedDensityStats(caps)
    table = port.stat_table(m.kind_id, m.params(), caps, "cuda")
    params = torch.as_tensor(m.params()).cuda()
    g = torch.Generator().manual_seed(31)
    for name, q in zip(STATS, (6, 4, 4)):
        tiles = (2.0 ** torch.randint(0, 31, (1024, q), generator=g)).cuda()
        direct = getattr(port, f"causal_topk_{name}_t")(params, None, tiles,
                                                        caps)
        got = getattr(stats, name)(m.kind_id, params, None, tiles,
                                   table=table)
        torch.testing.assert_close(got, direct, rtol=1e-13, atol=0,
                                   msg=name)
        del direct
        torch.cuda.empty_cache()
