"""The port's tensor density statistics against the JAX package's scalar
models.

``repro_torch.core.density``'s ``<kind>_<stat>_t`` forms, behind
``TracedDensityStats``, must reproduce the reference scalar
``prob_empty`` / ``expected_density`` / ``max_nnz`` of
``repro.core.density`` at every tile size — non-divisible tile sizes,
tiles past the tensor's end and all-zero rows included (the cases of
``tests/test_density_traced.py``) — both one tile at a time and over a
leading candidate dimension.  A (C, Q) stack of tiles in one call equals
its Q columns called one by one, as the batched engine's density queries
need.

The ``causal`` kind, which the JAX package lacks, is held instead to the
benchmark's plain-PyTorch brute force (``portbench/reference/
causal_mask.py``), exactly, at every tile size of small tensors, and the
benchmark's own closed forms (``portbench/reference/kinds/causal.py``)
to the port's at 4096 x 4096."""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import density as ref  # noqa: E402
from repro_torch.core import density as port  # noqa: E402

REFERENCE = Path(__file__).resolve().parents[1] / "portbench" / "reference"


def _load(path: Path):
    """A file of the benchmark's reference, by path (the benchmark is no
    package these tests import)."""
    spec = importlib.util.spec_from_file_location(
        "causal_ref_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair(ref_model):
    """The port's model of the same kind and parameters."""
    name = type(ref_model).__name__
    if name == "ActualDataModel":
        return port.ActualDataModel(data=ref_model.data)
    if name == "BandedModel":
        return port.BandedModel(rows=ref_model.rows, cols=ref_model.cols,
                                half_band=ref_model.half_band)
    if name == "StructuredModel":
        return port.StructuredModel(tensor_size=ref_model.tensor_size,
                                    n=ref_model.n, m=ref_model.m)
    if name == "UniformModel":
        return port.UniformModel(tensor_size=ref_model.tensor_size,
                                 density=ref_model.density)
    return port.DenseModel(tensor_size=ref_model.tensor_size)


def _check(ref_models, tile_sizes, tol=1e-9):
    models = [_pair(m) for m in ref_models]
    caps = port.caps_for_models(models)
    assert caps == port.DensityCaps(
        **vars(ref.caps_for_models(ref_models)))
    stats = port.TracedDensityStats(caps)
    tiles = torch.as_tensor(np.asarray(tile_sizes, np.float64))
    for rm, m in zip(ref_models, models):
        np.testing.assert_array_equal(m.params(), rm.params())
        np.testing.assert_array_equal(m.hist_table(), rm.hist_table())
        params = torch.as_tensor(m.params())
        hist = np.zeros((3, caps.hist))
        hist[:, : m.hist_table().shape[1]] = m.hist_table()
        hist = torch.as_tensor(hist)
        # a tensor kind id and every kind present: the torch.where path
        kind = torch.tensor(m.kind_id)
        got = {name: getattr(stats, name)(kind, params, hist, tiles)
               for name in ("prob_empty", "expected_density", "max_nnz")}
        for i, t in enumerate(tile_sizes):
            want = (rm.prob_empty(t), rm.expected_density(t),
                    rm.max_nnz(t))
            have = (float(got["prob_empty"][i]),
                    float(got["expected_density"][i]),
                    float(got["max_nnz"][i]))
            for w, h in zip(want, have):
                assert h == pytest.approx(w, rel=tol, abs=tol), \
                    (type(rm).__name__, t, want, have)
            # one tile at a time, with the kind known on the host
            one = float(stats.prob_empty(m.kind_id, params, hist,
                                         float(t), kinds=(m.kind_id,)))
            assert one == pytest.approx(want[0], rel=tol, abs=tol)


def test_actual_histogram_every_tile_size():
    rng = np.random.default_rng(0)
    a = (rng.random((7, 13)) < 0.3).astype(float)      # 91 elements
    _check([ref.ActualDataModel(data=a)], list(range(1, 92)) + [100, 1000])


def test_actual_all_zero_and_single_dense_row():
    _check([ref.ActualDataModel(data=np.zeros((6, 6)))],
           [1, 2, 5, 7, 36, 50])
    a = np.zeros((8, 8))
    a[0, :] = 1.0
    _check([ref.ActualDataModel(data=a)], [1, 3, 8, 9, 64])


@pytest.mark.parametrize("model", [
    ref.DenseModel(tensor_size=64),
    ref.UniformModel(tensor_size=256, density=0.3),
    ref.UniformModel(tensor_size=100, density=0.0),
    ref.StructuredModel(tensor_size=128, n=2, m=4),
    ref.StructuredModel(tensor_size=96, n=1, m=8),
    ref.BandedModel(rows=16, cols=24, half_band=2),
    ref.BandedModel(rows=9, cols=7, half_band=0),
], ids=lambda m: type(m).__name__)
def test_statistical_kinds_every_tile_size(model):
    tiles = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 25, 63, 64, 100]
    if isinstance(model, ref.BandedModel):
        # the banded divisor scan is sized by the tensor (DensityCaps.div):
        # the model answers for tiles that fit in the tensor
        tiles = [t for t in tiles if t <= model.tensor_size]
    _check([model], tiles)


def test_mixed_kinds_share_one_stats_object():
    """Caps of a mixed population keep every branch; each kind selects
    its own statistics."""
    models = [ref.UniformModel(tensor_size=256, density=0.3),
              ref.BandedModel(rows=16, cols=16, half_band=1),
              ref.ActualDataModel(data=np.eye(10))]
    _check(models, [1, 2, 4, 9, 10, 16, 33])


def test_zero_caps_prune_banded_and_actual_branches():
    stats = port.TracedDensityStats(port.DensityCaps())
    p = torch.as_tensor(port.UniformModel(64, 0.5).params())
    pe = stats.prob_empty(port.BANDED_ID, p, torch.zeros((3, 0)), 4.0)
    assert float(pe) == 0.0          # pruned to the dense form
    pe = stats.prob_empty(port.CAUSAL_ID, p, torch.zeros((3, 0)), 4.0)
    assert float(pe) == 0.0
    assert port.caps_for_models(
        [port.UniformModel(1024, 0.5)]) == port.DensityCaps()
    # a causal tensor sizes the row scan and the divisor scan
    assert port.caps_for_models([port.CausalModel(48, 20, 5)],
                                round_pow2=False) == \
        port.DensityCaps(coord=48, div=30)


def test_instance_wrappers_match_scalar_methods():
    rng = np.random.default_rng(3)
    data = (rng.random(48) < 0.4).astype(float)
    m = port.ActualDataModel(data=data)
    tiles = torch.tensor([1.0, 3.0, 7.0, 16.0, 48.0])
    for t, pe, mx in zip(tiles, m.prob_empty_b(tiles), m.max_nnz_b(tiles)):
        assert float(pe) == pytest.approx(m.prob_empty(int(t)))
        assert float(mx) == float(m.max_nnz(int(t)))
    b = port.BandedModel(rows=12, cols=12, half_band=1)
    for t in (2, 6, 9):
        assert float(b.max_nnz_b(float(t))) == b.max_nnz(t)


# ----------------------------------------------------------------------
# a (C, Q) stack of tiles in one call: the batched engine's density
# queries (core/batched.py, _DensityQueries)
# ----------------------------------------------------------------------
def _stack_case(kind):
    """A port model of ``kind`` and a (C, Q) stack of tiles that includes
    the tiles whose lgamma terms are invalid (inf or NaN before the
    ``torch.where`` that masks them)."""
    rng = np.random.default_rng(11)
    if kind == "dense":
        m = port.DenseModel(tensor_size=64)
        edge = [1, 63, 64, 65, 200]
    elif kind == "uniform":
        m = port.UniformModel(tensor_size=64, density=0.75)
        # S - N = 16: tiles past it have no empty arrangement (an
        # invalid log C(S - N, T)), tiles past S are clamped, 0 is C(n, 0)
        edge = [0, 1, 15, 16, 17, 63, 64, 65, 1000]
    elif kind == "structured":
        m = port.StructuredModel(tensor_size=96, n=2, m=8)
        # past m - n + 1 and past m: log C(m - n, t) and log C(m, t) are
        # -inf, their difference NaN, selected away
        edge = [0, 1, 5, 6, 7, 8, 9, 17, 96]
    elif kind == "banded":
        m = port.BandedModel(rows=16, cols=24, half_band=2)
        edge = [1, 2, 6, 7, 16, 25, 63, 64, 384]
    elif kind == "causal":
        m = port.CausalModel(rows=16, cols=24, window=5)
        edge = [1, 2, 6, 7, 16, 17, 25, 63, 64, 383, 384]
    else:
        m = port.ActualDataModel(
            data=(rng.random((9, 11)) < 0.3).astype(float))
        edge = [1, 2, 10, 11, 98, 99, 100, 500]
    cols = edge + [int(t) for t in rng.integers(1, 130, size=6)]
    C = 5
    tiles = np.stack([np.roll(cols, c) for c in range(C)]).astype(np.float64)
    return m, torch.as_tensor(tiles)


@pytest.mark.parametrize("every_kind", [False, True],
                         ids=["own_kind", "every_kind"])
@pytest.mark.parametrize("kind", port.MODEL_KINDS)
def test_one_call_on_a_stack_equals_one_call_per_column(kind, every_kind):
    """One statistic on a (C, Q) stack of tiles is the Q (C,) calls on its
    columns, to 1e-12 relative, for every kind and statistic: with the
    kind known on the host (the engine's call) and with every kind
    evaluated and selected by ``torch.where`` (the unselected branches
    hold inf and NaN here)."""
    m, tiles = _stack_case(kind)
    # every kind reads its own params here, so the actual-data branch's
    # table covers the largest tensor_size of the cases (banded's 384)
    caps = port.DensityCaps(coord=16, div=32, hist=512)
    stats = port.TracedDensityStats(caps)
    params = torch.as_tensor(m.params())
    hist = np.zeros((3, caps.hist))
    hist[:, : m.hist_table().shape[1]] = m.hist_table()
    hist = torch.as_tensor(hist)
    kind_id = torch.tensor(m.kind_id)
    kinds = None if every_kind else (m.kind_id,)
    for name in ("prob_empty", "expected_density", "max_nnz"):
        fn = getattr(stats, name)
        whole = fn(kind_id, params, hist, tiles, kinds=kinds)
        assert whole.shape == tiles.shape
        cols = torch.stack([fn(kind_id, params, hist, tiles[:, q],
                               kinds=kinds)
                            for q in range(tiles.shape[1])], -1)
        assert torch.isfinite(whole).all(), (name, whole)
        torch.testing.assert_close(whole, cols, rtol=1e-12, atol=0.0,
                                   msg=f"{kind} {name}")


# ----------------------------------------------------------------------
# the causal kind, against the benchmark's brute force
# ----------------------------------------------------------------------
CAUSAL_SHAPES = [(12, 12), (9, 16), (16, 7), (1, 10), (10, 1)]


@pytest.mark.parametrize("window", [1, 3, 17, "full"])
@pytest.mark.parametrize("shape", CAUSAL_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_causal_statistics_equal_the_brute_force(shape, window):
    """Every tile size 1..rows*cols (and past the tensor): the scalar
    model, the tensor forms behind ``TracedDensityStats`` (the kind a
    tensor, every kind evaluated and selected) and the instance wrappers
    give the brute force's exact counts, bit for bit."""
    bf = _load(REFERENCE / "causal_mask.py")
    rows, cols = shape
    w = rows if window == "full" else window
    m = port.CausalModel(rows=rows, cols=cols, window=w)
    mask = bf.mask(rows, cols, w)
    assert m.density == bf.density(mask)
    tiles = list(range(1, rows * cols + 1)) + [rows * cols + 7]
    want = [bf.stats(mask, t) for t in tiles]
    assert [(m.prob_empty(t), m.expected_density(t), m.max_nnz(t))
            for t in tiles] == want
    stats = port.TracedDensityStats(port.caps_for_models([m]))
    params = torch.as_tensor(m.params())
    tt = torch.tensor(tiles, dtype=torch.float64)
    kind = torch.tensor(m.kind_id)
    got = zip(*(getattr(stats, name)(kind, params, None, tt).tolist()
                for name in ("prob_empty", "expected_density", "max_nnz")))
    assert [(pe, ed, int(mx)) for pe, ed, mx in got] == want
    wrapped = zip(m.prob_empty_b(tt).tolist(),
                  m.expected_density_b(tt).tolist(), m.max_nnz_b(tt).tolist())
    assert [(pe, ed, int(mx)) for pe, ed, mx in wrapped] == want


def test_causal_window_past_the_rows_is_the_full_mask():
    full = port.CausalModel(rows=9, cols=14, window=9)
    wide = port.CausalModel(rows=9, cols=14, window=1000)
    for t in range(1, 9 * 14 + 1):
        assert (wide.prob_empty(t), wide.expected_density(t),
                wide.max_nnz(t)) == (full.prob_empty(t),
                                     full.expected_density(t),
                                     full.max_nnz(t))
    np.testing.assert_array_equal(wide.params(), full.params())


@pytest.mark.parametrize("bad", [{"window": 0}, {"window": -2},
                                 {"window": 2.5}, {"window": True},
                                 {"rows": 0}])
def test_causal_refuses_a_window_or_shape_that_is_no_whole_number(bad):
    spec = dict({"rows": 8, "cols": 8, "window": 3}, **bad)
    with pytest.raises(ValueError, match="causal"):
        port.make_density_model(("causal", spec), 64)


def test_causal_reference_kind_agrees_with_the_port_at_4096():
    """The benchmark's closed forms (``kinds/causal.py``, plain Python)
    and the port's, at attention's 4096 x 4096 over 64 seeded tile sizes
    (divisors of the shape, primes and everything between) and windows
    full, 1 and 1,000: equal."""
    kind = _load(REFERENCE / "kinds" / "causal.py")
    rng = np.random.default_rng(4096)
    n = 4096 * 4096
    tiles = ([1, 2, 3, 4096, n, n - 1, 16777213]
             + [int(t) for t in np.exp(rng.uniform(0, math.log(n), 57))])
    assert len(tiles) == 64
    for w in (4096, 1, 1000):
        mine = port.CausalModel(rows=4096, cols=4096, window=w)
        theirs = kind.model({"window": w, "rows": 4096, "cols": 4096}, n)
        assert theirs.density == mine.density
        for t in tiles:
            assert (theirs.prob_empty(t), theirs.expected_density(t),
                    theirs.max_nnz(t)) == (mine.prob_empty(t),
                                           mine.expected_density(t),
                                           mine.max_nnz(t)), (w, t)


def test_causal_scans_answer_alike_in_either_integer_type():
    """The row-strip and divisor scans run in int32 where the caps allow
    (``_scan_dtype``) and in int64 past that: both answer the same."""
    m = port.CausalModel(rows=24, cols=40, window=7)
    small = port.DensityCaps(coord=32, div=32)
    wide = port.DensityCaps(coord=32, div=1 << 15)
    assert port._scan_dtype(small) == torch.int32
    assert port._scan_dtype(wide) == torch.int64
    params = torch.as_tensor(m.params())
    tt = torch.arange(1, 24 * 40 + 1, dtype=torch.float64)
    for name in ("prob_empty", "expected_density", "max_nnz"):
        fn = getattr(port, f"causal_{name}_t")
        torch.testing.assert_close(fn(params, None, tt, small),
                                   fn(params, None, tt, wide),
                                   rtol=0, atol=0)
