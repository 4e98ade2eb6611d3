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
    evaluated and selected, the caps rounded up) and the wrappers."""
    scalar = [tuple(getattr(m, s)(t) for s in STATS) for t in tiles]
    stats = port.TracedDensityStats(port.caps_for_models([m]))
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
#: DSA cell's attn_av is the kind's own program)
OPS = {("scnn-resnet50", "conv2_x"): 1213,
       ("eyeriss-v2saf-mobilenet", "pw1"): 1235,
       ("deepseek-v2-lite-stc", "mla_q_proj"): 985,
       ("deepseek-v2-lite-stc", "attn_av"): 1214,
       ("deepseek-v3.2-dsa-stc", "mla_q_a_proj"): 985}


@pytest.mark.parametrize("config, layer", sorted(OPS),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_the_benchmark_programs_dispatch_the_ops_they_did(config, layer):
    """Each configuration's program, as a small fused CPU search runs it:
    one warm call dispatches the ops it did before the kind came."""
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
