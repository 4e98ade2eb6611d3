"""The ``causal_block_topk`` density kind: whole blocks of keys chosen
inside each row's causal map, the attention map of MiniMax-M3's
block-sparse attention (MSA).

The JAX package lacks the kind, so the port is held to exact enumeration:
every selection of every row of small tensors (the rows independent),
the empty tiles' probability and the expected nonzeros worked out tile
by tile, to 1e-12 (float64's rounding of a product of up to 24 shares),
and ``max_nnz`` a bound on the most any selection puts in a tile.  The
scalar model, the tensor forms behind ``TracedDensityStats`` and the
instance wrappers each answer; at tensors of 64 to 1,024 rows the tensor
forms, once a distinct tile size, give the scalar model's answers over
stacks of every tile size the engine can ask.  ``block`` 1 with ``init``
and ``local`` 0 is ``causal_topk`` at ``window = rows``.  A program that
evaluates the kind observes ``fused.graph_kernels.causal_block_topk``.
"""
import dataclasses
import itertools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import density as port  # noqa: E402

STATS = ("prob_empty", "expected_density", "max_nnz")


def _tile_shape(t):
    tr = math.isqrt(t)
    while t % tr:
        tr -= 1
    return tr, t // tr


def _selections(rows, cols, block, k, init, local):
    """Per row, every selection as a ``(count, cols)`` boolean array: the
    forced blocks and one choice of ``min(k, n_i)`` candidates, each
    block cut at the row's last causal column."""
    out = []
    for i in range(rows):
        hi = min(i, cols - 1)
        nb = hi // block + 1
        forced = set(range(min(init, nb))) | set(range(max(0, nb - local),
                                                       nb))
        cands = [b for b in range(nb) if b not in forced]
        picks = list(itertools.combinations(cands, min(k, len(cands))))
        m = np.zeros((len(picks), cols), bool)
        for s, pick in enumerate(picks):
            for b in forced | set(pick):
                m[s, b * block: min((b + 1) * block, hi + 1)] = True
        out.append(m)
    return out


def _exact(sel, rows, cols, t):
    """``(prob_empty, expected_density, most)`` at tile size ``t`` from
    the selections, ``most`` the largest count any selection puts in a
    tile (rows independent: each row's largest)."""
    tr, tc = _tile_shape(t)
    nr, nc = max(1, rows // tr), max(1, cols // tc)
    hh, kk = min(tr, rows), min(tc, cols)
    p = np.ones((nr, nc))
    nnz = np.zeros((nr, nc))
    most = np.zeros((nr, nc), np.int64)
    for i in range(nr * hh):
        counts = sel[i][:, :nc * kk].reshape(-1, nc, kk).sum(-1)
        a = i // hh
        p[a] *= (counts == 0).mean(0)
        nnz[a] += counts.mean(0)
        most[a] += counts.max(0)
    return p.mean(), nnz.sum() / (nr * nc * t), int(most.max())


def _answers(m, tiles):
    """Each statistic at ``tiles`` from the scalar model, the tensor forms
    behind ``TracedDensityStats`` (the kind a tensor, every kind
    evaluated and selected, the table widened to the sizes asked) and the
    wrappers."""
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
# against exact enumeration
# ----------------------------------------------------------------------
#: (rows, cols, block, k, init, local): tall, wide and square, blocks
#: that divide the tiles and blocks that do not, forced blocks that
#: overlap, and k past the candidates
ENUMERATED = [(24, 24, 4, 2, 1, 1), (24, 24, 3, 3, 0, 0),
              (17, 23, 5, 1, 1, 0), (23, 17, 2, 4, 0, 2),
              (20, 20, 6, 2, 2, 2), (12, 24, 1, 3, 1, 1),
              (24, 12, 7, 2, 1, 1), (1, 13, 6, 2, 1, 2),
              (22, 1, 5, 4, 2, 0), (16, 16, 16, 1, 0, 1)]


@pytest.mark.parametrize("case", ENUMERATED, ids=lambda c: "-".join(
    map(str, c)))
def test_statistics_equal_exact_enumeration(case):
    """Every tile size of the tensor: ``prob_empty`` and
    ``expected_density`` as every selection of every row gives them, to
    1e-12, and ``max_nnz`` at least any selection's most, alike in every
    form."""
    rows, cols = case[:2]
    m = port.CausalBlockTopkModel(*case)
    sel = _selections(*case)
    assert m.density == pytest.approx(
        sum(s.mean(0).sum() for s in sel) / (rows * cols), abs=1e-14)
    tiles = list(range(1, rows * cols + 1))
    got = _answers(m, tiles)
    for j, t in enumerate(tiles):
        pe, ed, most = _exact(sel, rows, cols, t)
        for form, g in got.items():
            assert abs(g[j][0] - pe) <= 1e-12, (form, t, g[j], pe)
            assert abs(g[j][1] - ed) <= 1e-12, (form, t, g[j], ed)
            assert most <= g[j][2] <= t, (form, t, g[j], most)
            assert int(g[j][2]) == got["scalar"][j][2], (form, t)


def test_a_shape_where_blocks_and_tiles_do_not_nest():
    """60 x 84 in blocks of 9 (no tile width is a multiple or a divisor of
    it at most sizes): every divisor-product tile against enumeration,
    and the tiles' columns fall on m_lo and m_lo + 1 blocks both."""
    case = (60, 84, 9, 2, 1, 1)
    m = port.CausalBlockTopkModel(*case)
    sel = _selections(*case)
    tiles = _products(60, 84)
    got = _answers(m, tiles)
    for j, t in enumerate(tiles):
        pe, ed, most = _exact(sel, 60, 84, t)
        for form, g in got.items():
            assert abs(g[j][0] - pe) <= 1e-12, (form, t, g[j], pe)
            assert abs(g[j][1] - ed) <= 1e-12, (form, t, g[j], ed)
            assert most <= g[j][2] <= t, (form, t, g[j], most)
    straddle = [t for t in tiles if (_tile_shape(t)[1] - 1) % 9 != 8
                and _tile_shape(t)[1] % 9]
    assert len(straddle) > 20


# ----------------------------------------------------------------------
# block 1 with nothing forced is causal_topk over the whole causal map
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rows, cols", [(12, 12), (9, 16), (16, 7),
                                        (33, 20), (1, 10), (10, 1)])
def test_block_one_is_causal_topk_at_window_rows(rows, cols):
    """Scalar, traced and wrapped forms give ``causal_topk``'s answers
    at ``window = rows``: the probabilities to 1e-13, ``max_nnz`` and
    the density exactly."""
    tiles = list(range(1, rows * cols + 1))
    for k in (1, 2, 5, rows + 3):
        mine = port.CausalBlockTopkModel(rows, cols, 1, k, 0, 0)
        theirs = port.CausalTopkModel(rows=rows, cols=cols, window=rows,
                                      k=k)
        assert mine.density == pytest.approx(theirs.density, rel=1e-15)
        a, b = _answers(mine, tiles), _answers(theirs, tiles)
        for form in a:
            for t, u, v in zip(tiles, a[form], b[form]):
                assert abs(u[0] - v[0]) <= 1e-13, (form, k, t, u, v)
                assert abs(u[1] - v[1]) <= 1e-13, (form, k, t, u, v)
                assert u[2] == v[2], (form, k, t, u, v)


# ----------------------------------------------------------------------
# once a distinct tile size, at 64 to 1,024 rows
# ----------------------------------------------------------------------
def _products(rows, cols):
    """``{d * e : d | rows, e | cols}`` by brute force."""
    def divisors(n):
        return [d for d in range(1, n + 1) if n % d == 0]
    return sorted({d * e for d in divisors(rows) for e in divisors(cols)})


#: (rows, cols, block, k, init, local)
STACKED = [(64, 64, 2, 1, 0, 0), (128, 96, 3, 2, 1, 1),
           (256, 256, 16, 4, 1, 2), (384, 320, 5, 3, 0, 1),
           (1024, 1024, 16, 4, 1, 1), (1024, 768, 7, 2, 1, 0),
           (96, 200, 8, 4, 0, 2)]


@pytest.mark.parametrize("case", STACKED, ids=lambda c: "-".join(
    map(str, c)))
def test_the_table_gives_the_scalar_models_answers(case):
    """Stacks of every tile size the engine can ask (the products of
    divisors, with repeats, in a (2, U) and a shuffled (3, U) stack)
    through ``TracedDensityStats``' lookup in the tensor's table
    (``stat_table`` at ``caps_for_models``' caps): the scalar model's
    answers to 1e-12 relative or 1e-14 absolute (the strips' sums are
    int64 fixed point in the forms, of a quantum ``2**-S`` a row, and
    float in the scalar model, so a tile's probability of 1e-185 differs
    by some 1e-12 of itself), and the direct forms' bit for bit."""
    m = port.CausalBlockTopkModel(*case)
    caps = port.caps_for_models([m])
    sizes = _products(*case[:2])
    assert len(sizes) <= caps.tiles
    stats = port.TracedDensityStats(caps)
    params = torch.as_tensor(m.params())
    table = port.stat_table(m.kind_id, m.params(), caps)
    kind = torch.tensor(m.kind_id)
    g = torch.Generator().manual_seed(case[0] + case[2])
    flat = torch.tensor(sizes * 2, dtype=torch.float64)
    stacks = (flat.view(2, -1),
              flat.repeat(2)[torch.randperm(4 * len(sizes), generator=g)]
              [:3 * len(sizes)].view(3, -1))
    for tiles in stacks:
        for name in STATS:
            got = getattr(stats, name)(kind, params, None, tiles,
                                       table=table)
            want = torch.tensor([[getattr(m, name)(int(t)) for t in row]
                                 for row in tiles.tolist()],
                                dtype=torch.float64)
            torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14,
                                       msg=name)
            direct = getattr(port, f"causal_block_topk_{name}_t")(
                params, None, tiles, caps)
            assert torch.equal(got, direct), name


def test_the_cells_tensor_agrees_with_the_scalar_model():
    """attn_av's P of the MSA cell (131,072 x 131,072, blocks of 128, k
    16, the first and own block): its 291,160,064 nonzeros, and the
    answers of its table (35 sizes, 64 columns) at powers of two the
    scalar model's to 1e-12 relative (S 34 fixed point over 131,072
    rows)."""
    n = 131072
    m = port.CausalBlockTopkModel(n, n, 128, 16, 1, 1)
    assert round(m.density * n * n) == 291160064
    caps = port.caps_for_models([m])
    assert caps == port.DensityCaps(coord=n, div=n, hist=0, tiles=64)
    assert port._topk_fix(caps) == (34, 18)
    assert len(port._tile_sizes(n, n)) == 35
    tiles = torch.tensor([[2.0 ** e for e in range(0, 35, 2)]])
    stats = port.TracedDensityStats(caps)
    params = torch.as_tensor(m.params())
    table = port.stat_table(m.kind_id, m.params(), caps)
    for name in STATS:
        got = getattr(stats, name)(m.kind_id, params, None, tiles,
                                   table=table)[0]
        want = torch.tensor([getattr(m, name)(int(t)) for t in tiles[0]],
                            dtype=torch.float64)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-300,
                                   msg=name)


# ----------------------------------------------------------------------
# the parameters and refusals
# ----------------------------------------------------------------------
def test_block_init_and_local_share_the_last_slot():
    """The params vector keeps four slots: k, rows, cols and the block,
    init and local packed; the tensor forms unpack them exactly, at the
    packing's largest values too."""
    caps = port.DensityCaps(coord=64, div=64)
    for block, init, local in ((128, 1, 1), (1, 0, 0), (7, 4095, 4095),
                               ((1 << 24) - 1, 0, 3)):
        m = port.CausalBlockTopkModel(64, 64, block, 3, init, local)
        p = m.params()
        assert p.shape == (port.NUM_DENSITY_PARAMS,) and list(p[:3]) == [
            3, 64, 64]
        rows = port._block_rows_t(torch.as_tensor(p), caps)
        assert int(rows.B) == min(block, 2 * 65 + 1)
        assert (int(rows.init), int(rows.local)) == (min(init, 65),
                                                      min(local, 65))


@pytest.mark.parametrize("bad", [{"k": 0}, {"k": 2.5}, {"k": True},
                                 {"block": 0}, {"block": 1 << 24},
                                 {"init": -1}, {"local": 1 << 12},
                                 {"local": None}, {"rows": 0}, "no init",
                                 "no block"])
def test_a_malformed_spec_is_refused(bad):
    spec = {"rows": 8, "cols": 8, "block": 2, "k": 2, "init": 1,
            "local": 1}
    if isinstance(bad, str):
        del spec[bad.split()[1]]
    else:
        spec.update(bad)
    with pytest.raises(ValueError, match="causal_block_topk"):
        port.make_density_model(("causal_block_topk", spec), 64)


# ----------------------------------------------------------------------
# the engine's path: the captured-graph program and its histograms
# ----------------------------------------------------------------------
def test_a_fused_search_evaluates_the_kind_once_a_tile_size(monkeypatch):
    """Two fused CPU searches over one causal_block_topk operand on STC-
    flexible-RLE: the layer's table is built once, before the fused
    step (the kind's forms run three times, once a statistic, at the
    tensor's ``d e`` sizes, and ``engine.topk_table_rows`` counts 3, not
    6), the step only looks the answers up (finite, each lookup on
    ``engine.topk_tiles``), the ``engine.*`` spans carry the kind among
    ``density_kinds`` and each winner passed the scalar oracle."""
    from repro_torch.core import matmul
    from repro_torch.core.batched import clear_caches
    from repro_torch.core.mapper import MapspaceConstraints
    from repro_torch.core.presets import stc_like
    from repro_torch.search import SearchConfig, run_search
    from repro_torch.search import fused as F
    calls, answers, inside = [], [], [False]

    def spied(fn):
        def spy(p, h, t, caps):
            calls.append((fn.__name__, inside[0], tuple(t.tolist())))
            return fn(p, h, t, caps)
        return spy
    monkeypatch.setitem(port.TABLE_STATS, port.CAUSAL_BLOCK_TOPK_ID, tuple(
        spied(fn) for fn in port.TABLE_STATS[port.CAUSAL_BLOCK_TOPK_ID]))
    real_step, real_lookup = F.FusedProgram._step, port._table_lookup

    def step(self, st, wp):
        inside[0] = True
        try:
            return real_step(self, st, wp)
        finally:
            inside[0] = False

    def lookup(table, stat, t):
        answers.append(real_lookup(table, stat, t))
        return answers[-1]
    monkeypatch.setattr(F.FusedProgram, "_step", step)
    monkeypatch.setattr(port, "_table_lookup", lookup)
    monkeypatch.setattr(obs.metrics, "REGISTRY", obs.metrics.Registry())
    wl = matmul(96, 96, 16, densities={
        "A": ("causal_block_topk", {"rows": 96, "cols": 96, "block": 8,
                                    "k": 2, "init": 1, "local": 1}),
        "B": ("dense", None)})
    clear_caches()
    tr = obs.enable()
    try:
        results = [run_search(stc_like(n=2, m=4, fmt_kind="RLE"), wl,
                              MapspaceConstraints(budget=96, seed=0),
                              strategy="es", key=key, generations=3,
                              pop_size=32, fused=True,
                              config=SearchConfig(fused_chunk=2),
                              device="cpu") for key in (7, 8)]
        kinds = {tuple(s.attrs["density_kinds"]) for s in tr.spans
                 if s.name in ("engine.compile", "engine.eval")
                 and s.attrs.get("kind") == "fused"}
    finally:
        obs.disable()
        clear_caches()
    assert kinds == {("causal_block_topk", "dense")}
    for res in results:
        assert res.best is not None and res.best.result.valid
    sizes = tuple(float(t) for t in _products(96, 96))
    assert calls == [(f"causal_block_topk_{s}_t", False, sizes)
                     for s in STATS]
    snap = obs.metrics.snapshot()
    rows = snap["engine.topk_table_rows"]
    assert (rows["count"], rows["sum"]) == (3, 3 * len(sizes))
    assert answers and all(bool(torch.isfinite(a).all()) for a in answers)
    assert snap["engine.topk_tiles"]["count"] == len(answers)
    assert snap["engine.topk_tiles"]["sum"] == sum(a.numel()
                                                   for a in answers)


def test_only_a_kind_past_the_references_observes_its_histogram(
        monkeypatch):
    """A capture's kernel count goes to ``fused.graph_kernels.<kind>`` for
    each kind past the JAX package's that the program evaluates, and to
    no kind's histogram for a program of dense and uniform tensors (the
    count is given: the capture itself needs a card)."""
    from repro_torch.core.batched import DeviceLeaves
    from repro_torch.search import fused as F
    monkeypatch.setattr(obs.metrics, "REGISTRY", obs.metrics.Registry())
    F.FusedProgram._observe_kernels(
        1407, DeviceLeaves(*(None,) * 4,
                           kinds=(port.DENSE_ID, port.UNIFORM_ID)))
    F.FusedProgram._observe_kernels(
        1930, DeviceLeaves(*(None,) * 4, kinds=(
            port.CAUSAL_BLOCK_TOPK_ID, port.DENSE_ID,
            port.CAUSAL_BLOCK_TOPK_ID)))
    snap = obs.metrics.snapshot()
    assert snap["fused.graph_kernels"]["count"] == 2
    block = snap["fused.graph_kernels.causal_block_topk"]
    assert (block["count"], block["mean"]) == (1, 1930.0)
    assert not [k for k in snap if k.startswith("fused.graph_kernels.")
                and k != "fused.graph_kernels.causal_block_topk"]


@pytest.mark.gpu
def test_cuda_the_table_equals_the_cpus_at_the_cells_caps():
    """On the card, the MSA cell's attn_av P at the cell's caps: the
    table built on the card (its 35 sizes, padded to 64) gives the
    CPU's to 1e-12 relative (the strips' sums are integers, but the
    card's ``exp``, ``log1p`` and float sums round otherwise) and
    ``max_nnz`` and the sizes exactly, and a generation's stacks
    ((1,024, 6) and (1,024, 4) tiles) looked up in it on the card give
    the CPU table's answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = 131072
    m = port.CausalBlockTopkModel(n, n, 128, 16, 1, 1)
    caps = port.caps_for_models([m])
    stats = port.TracedDensityStats(caps)
    cpu = port.stat_table(m.kind_id, m.params(), caps)
    card = port.stat_table(m.kind_id, m.params(), caps, "cuda")
    assert card.shape == cpu.shape == (4, 64)
    for row in (0, 3):
        assert torch.equal(card[row].cpu(), cpu[row]), row
    torch.testing.assert_close(card.cpu(), cpu, rtol=1e-12, atol=1e-300)
    params = torch.as_tensor(m.params())
    g = torch.Generator().manual_seed(36)
    for name, q in zip(STATS, (6, 4, 4)):
        tiles = 2.0 ** torch.randint(0, 35, (1024, q), generator=g)
        want = getattr(stats, name)(m.kind_id, params, None, tiles,
                                    table=cpu)
        got = getattr(stats, name)(m.kind_id, params.cuda(), None,
                                   tiles.cuda(), table=card).cpu()
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-300,
                                   msg=name)
