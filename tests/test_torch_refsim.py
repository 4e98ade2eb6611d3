"""The port's actual-data reference simulator (``repro_torch.core.refsim``,
a copy of the JAX package's) and the paper's validation figures on the
port (``repro_torch.validation``).

* refsim's counts — every tensor's reads, fills and updates (actual,
  gated, skipped), metadata and occupancy words at every level, and the
  compute actions — equal the reference's exactly on the inputs of
  ``tests/test_core_validation.py`` (two- and three-level sparse
  designs on concrete sparse arrays) and ``tests/test_dataflow.py``
  (dense mappings, where the counts also equal the port's dataflow
  step).  ``repro.core.refsim`` imports without jax's batched engine,
  so this runs in process.
* The figures, two ways.  (1) The model modules: the port's figure
  drivers (``repro_torch/validation.py``) run once over the port's
  ``core`` and once loaded over the JAX package's ``repro.core``; every
  error and every row agrees to 1e-9.  This holds the port's engine,
  refsim, density models and presets to the reference's, but both
  sides run the port's drivers.  (2) The drivers: the JAX package's
  own benchmarks (``benchmarks/bench_fig1{1,2,3}*.py::run()``, in a
  subprocess) report every per-component, per-layer and per-density
  error they average, unrounded, and the port's drivers give the same
  errors to 1e-9 and print the same two-decimal strings.  The
  subprocess also gives Table 5's tilings and mappings."""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference as R  # noqa: E402
from repro.core import evaluate_microarch as ref_microarch  # noqa: E402
from repro.core import matmul as ref_matmul  # noqa: E402
from repro.core import mv as ref_mv  # noqa: E402
from repro.core import nest as ref_nest  # noqa: E402
from repro.core import presets as ref_presets  # noqa: E402
from repro.core import refsim as ref_refsim  # noqa: E402
from repro.core.taxonomy import SAFSpec as RefSAFSpec  # noqa: E402
from repro_torch.core import evaluate_microarch, refsim  # noqa: E402
from repro_torch import validation  # noqa: E402
from repro_torch.core.dataflow import analyze_dataflow  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

RNG_SEED = 42
MAP2 = ref_nest(2, ("m", 4, 1), ("n", 2, 1), ("n", 4, 1, "spatial"),
                ("n", 2, 0), ("k", 16, 0), ("m", 4, 0))
NEST3 = ref_nest(3, ("m", 4, 2), ("k", 2, 2),
                 ("n", 4, 1), ("m", 2, 1), ("n", 2, 1, "spatial"),
                 ("n", 2, 0), ("k", 4, 0), ("m", 2, 0))


def _sample(rng, shape, d):
    return (rng.random(shape) < d).astype(np.float32)


def _validation_cases():
    """(name, design, workload, mapping, arrays) of
    ``tests/test_core_validation.py``: three two-level designs and the
    three-level SCNN-like one, three draws of the sparse arrays each."""
    rng = np.random.default_rng(RNG_SEED)
    wl2 = ref_matmul(16, 16, 16, densities={"A": ("uniform", 0.25),
                                            "B": ("uniform", 0.5)})
    wl3 = ref_matmul(16, 8, 16, densities={"A": ("uniform", 0.3),
                                           "B": ("uniform", 0.4)})
    out = []
    for maker in ("dense_design", "bitmask_design",
                  "coordinate_list_design"):
        d = getattr(ref_presets, maker)(
            ref_presets.two_level_arch(buffer_kwords=64))
        for i in range(3):
            out.append((f"{maker}-{i}", d, wl2, MAP2,
                        {"A": _sample(rng, (16, 16), .25),
                         "B": _sample(rng, (16, 16), .5)}))
    d = ref_presets.scnn_like(ref_presets.three_level_arch())
    for i in range(3):
        out.append((f"scnn_like-{i}", d, wl3, NEST3,
                    {"A": _sample(rng, (16, 8), .3),
                     "B": _sample(rng, (8, 16), .4)}))
    return out


#: the dense mappings of ``tests/test_dataflow.py``
DATAFLOW_CASES = {
    "output_stationary": (ref_matmul(8, 8, 8), ref_nest(
        2, ("m", 8, 1), ("n", 8, 0), ("k", 8, 0))),
    "weight_stationary_spatial": (ref_matmul(8, 16, 8), ref_nest(
        2, ("k", 2, 1), ("m", 4, 1), ("n", 2, 1, "spatial"),
        ("n", 4, 0), ("k", 8, 0), ("m", 2, 0))),
    "reduction_outer": (ref_matmul(4, 8, 4), ref_nest(
        2, ("k", 4, 1), ("m", 4, 1), ("n", 4, 0), ("k", 2, 0))),
    "mv_three_level": (ref_mv(16, 16), ref_nest(
        3, ("m", 2, 2), ("k", 2, 2), ("m", 4, 1), ("k", 2, 1),
        ("k", 4, 0), ("m", 2, 0))),
}


def _counts(st) -> dict:
    """Every count of a SparseTraffic, flat."""
    out = {"compute_instances": st.compute_instances}
    for f in ("actual", "gated", "skipped"):
        out[f"compute.{f}"] = getattr(st.compute, f)
    for (t, s), tl in st.per_level.items():
        for what in ("reads", "fills", "updates"):
            for f in ("actual", "gated", "skipped"):
                out[f"{t}.{s}.{what}.{f}"] = getattr(getattr(tl, what), f)
        for f in ("metadata_read_words", "metadata_fill_words",
                  "occupancy_words_avg", "occupancy_words_max",
                  "instances"):
            out[f"{t}.{s}.{f}"] = getattr(tl, f)
    return out


def _both(design, wl, mapping, safs, arrays, names):
    want = ref_refsim.simulate(wl, mapping, safs, arrays, names)
    got = refsim.simulate(from_reference(wl), from_reference(mapping),
                          from_reference(safs), arrays, names)
    return got, want


VALIDATION_CASES = _validation_cases()


@pytest.mark.parametrize("case", VALIDATION_CASES, ids=lambda c: c[0])
def test_refsim_counts_equal_reference_on_sparse_designs(case):
    _, design, wl, mapping, arrays = case
    got, want = _both(design, wl, mapping, design.safs, arrays,
                      design.level_names)
    assert _counts(got) == _counts(want)
    g = evaluate_microarch(from_reference(design.arch), got,
                           check_capacity=False)
    w = ref_microarch(design.arch, want, check_capacity=False)
    assert (g.cycles, g.energy_pj) == (w.cycles, w.energy_pj)


@pytest.mark.parametrize("name", list(DATAFLOW_CASES))
def test_refsim_counts_equal_reference_on_dense_mappings(name):
    wl, mapping = DATAFLOW_CASES[name]
    arrays = {t.name: np.ones(t.dim_sizes(wl.rank_bounds))
              for t in wl.tensors}
    names = [f"L{s}" for s in range(mapping.num_levels)]
    got, want = _both(None, wl, mapping, RefSAFSpec(), arrays, names)
    assert _counts(got) == _counts(want)
    # ...and the dense counts are the port's dataflow step's
    dense = analyze_dataflow(from_reference(wl), from_reference(mapping))
    for t in wl.tensors:
        for s in range(mapping.num_levels):
            a, b = dense.of(t.name, s), got.of(t.name, s)
            if t.name == wl.output:
                assert (a.writeback_words + a.rmw_read_words
                        + a.read_words) == pytest.approx(b.reads.dense)
                assert a.update_words == pytest.approx(b.updates.dense)
            else:
                assert a.read_words == pytest.approx(b.reads.dense)
                if s < mapping.num_levels - 1:
                    assert a.fill_words == pytest.approx(b.fills.dense)


# ----------------------------------------------------------------------
# the paper's figures: the port's modules against the JAX package's
# ----------------------------------------------------------------------
def _on_reference_core():
    """``repro_torch/validation.py`` loaded as a module of the JAX
    package: the same drivers, with every relative import of ``core``
    (engine, refsim, density, presets, ...) resolved to the reference's
    modules."""
    spec = importlib.util.spec_from_file_location(
        "repro._validation_of_the_port", validation.__file__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.refsim is ref_refsim
    return mod


REFERENCE_CORE = _on_reference_core()

#: figure -> the errors it reports
FIGURES = {"fig11_scnn": ("max_err_pct", "mean_err_pct"),
           "fig12_eyerissv2": ("uniform_mean_err_pct",
                               "actual_mean_err_pct"),
           "fig13_dstc": ("avg_err_pct",)}


@pytest.fixture(scope="module")
def figures():
    return {name: (getattr(validation, name)(),
                   getattr(REFERENCE_CORE, name)()) for name in FIGURES}


@pytest.mark.parametrize("name", list(FIGURES))
def test_figure_errors_match_reference(figures, name):
    got, want = figures[name]
    for key in FIGURES[name]:
        assert got[key] == pytest.approx(want[key], rel=1e-9, abs=1e-9)
    rows = next(k for k in got if isinstance(got[k], list))
    assert len(got[rows]) == len(want[rows]) > 0
    for g, w in zip(got[rows], want[rows]):
        for k, v in w.items():
            if isinstance(v, float):
                assert g[k] == pytest.approx(v, rel=1e-9, abs=1e-9), k
            else:
                assert g[k] == v


reference = R.reference_fixture("""
    import contextlib, io
    import benchmarks.bench_fig11_scnn as f11
    import benchmarks.bench_fig12_eyerissv2 as f12
    import benchmarks.bench_fig13_dstc as f13
    import benchmarks.bench_table5_cphc as t5
    from benchmarks.common import RESNET50_LAYERS
    import torch_reference as R

    class Averages:
        # numpy for a benchmark module, recording every list of errors
        # it averages (the unrounded values behind what it prints)
        def __init__(self):
            self.calls = []

        def __getattr__(self, name):
            return getattr(np, name)

        def mean(self, x, *args, **kwargs):
            self.calls.append([float(v) for v in x])
            return np.mean(x, *args, **kwargs)

    with contextlib.redirect_stdout(io.StringIO()):
        for mod in (f11, f12, f13):
            mod.np = avg = Averages()
            for row, _, derived in mod.run():
                OUT[row] = derived
            OUT[mod.__name__.split(".")[-1] + ".errs"] = avg.calls
    for name, M, K, N, _, _ in RESNET50_LAYERS + [("c32", 32, 32, 32, 0, 0),
                                                  ("c64", 64, 64, 64, 0, 0)]:
        OUT[name + ".tilings"] = t5._tilings(M, K, N)
        OUT[name + ".mapping3"] = R.loops_of(t5._mapping3(M, K, N))
    OUT["template3"] = [list(s) for s in t5.TEMPLATE3.slots]
""")


def test_figures_print_as_the_reference_benchmarks(figures, reference):
    """The benchmarks round to two decimals: the port's errors must
    print the same digits."""
    fig11 = figures["fig11_scnn"][0]
    fig12 = figures["fig12_eyerissv2"][0]
    fig13 = figures["fig13_dstc"][0]
    assert reference["fig11_scnn_validation"] == \
        f"max_err_pct={fig11['max_err_pct']:.2f}"
    assert reference["fig12_eyerissv2_uniform"] == \
        f"mean_err_pct={fig12['uniform_mean_err_pct']:.2f}"
    assert reference["fig12_eyerissv2_actual"] == \
        f"mean_err_pct={fig12['actual_mean_err_pct']:.2f}"
    assert reference["fig13_dstc_latency"] == \
        f"avg_err_pct={fig13['avg_err_pct']:.2f}"


#: benchmark -> the figure's error lists, in the order it averages them
RAW_ERRORS = {
    "bench_fig11_scnn": lambda f: [
        [c["err_pct"] for c in f["fig11_scnn"]["components"]]],
    "bench_fig12_eyerissv2": lambda f: [
        [r["uniform_err_pct"] for r in f["fig12_eyerissv2"]["layers"]],
        [r["actual_err_pct"] for r in f["fig12_eyerissv2"]["layers"]]],
    "bench_fig13_dstc": lambda f: [
        [r["err_pct"] for r in f["fig13_dstc"]["rows"]]],
}


@pytest.mark.parametrize("bench", list(RAW_ERRORS))
def test_figure_errors_equal_the_reference_benchmarks_unrounded(
        figures, reference, bench):
    """Every error the JAX package's benchmark averages, as its own loop
    computes it, equals the port's driver's to 1e-9."""
    got = RAW_ERRORS[bench]({k: v[0] for k, v in figures.items()})
    want = reference[bench + ".errs"]
    assert len(want) >= len(got)
    for g, w in zip(got, want):
        assert len(g) == len(w) > 0
        assert g == pytest.approx(w, rel=1e-9, abs=1e-9)


@pytest.mark.parametrize("name,M,K,N", [
    ("conv2_x", 3136, 576, 64), ("conv3_x", 784, 1152, 128),
    ("conv4_x", 196, 2304, 256), ("conv5_x", 49, 4608, 512),
    ("c32", 32, 32, 32), ("c64", 64, 64, 64)])
def test_table5_tilings_match_reference(reference, name, M, K, N):
    np.testing.assert_array_equal(validation.tilings(M, K, N),
                                  reference[name + ".tilings"])
    assert R.loops_of(validation.mapping3(M, K, N)) == \
        reference[name + ".mapping3"]
    assert [list(s) for s in validation.template3().slots] == \
        reference["template3"]


def test_refsim_speedup_times_engine_and_refsim_on_same_mappings():
    """The Table-5 speed comparison runs end to end on the CPU: per
    mapping times of both, the speedup, the engine's error against one
    refsim draw per sampled mapping, and the projection."""
    out = validation.refsim_speedup(sides=(16, 32), samples=3,
                                    device="cpu", reps=1)
    assert [r["side"] for r in out["rows"]] == [16, 32]
    for r in out["rows"]:
        assert r["refsim_mappings"] == 3 and r["mappings"] > 3
        assert r["engine_s_per_mapping"] > 0 and r["speedup"] > 0
        assert np.isfinite(r["cycles_mean_err_pct"])
    assert np.isfinite(out["projected_conv2_x"])
