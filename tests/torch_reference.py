"""Helpers the port's search and validation tests share: the JAX package
run in a subprocess, and the cases both packages build.

Under jax 0.9 ``repro.core.batched`` does not import (it imports
``jax.experimental.enable_x64``, which jax 0.9 moved to
``jax.enable_x64``), and with it neither do ``repro.core.vmapper`` nor
``repro.search``.  :func:`run_reference` runs a snippet in a fresh
interpreter that aliases ``jax.experimental.enable_x64`` to
``jax.enable_x64`` before it imports ``repro``, on the CPU.  The alias
is never set in the pytest process: there it would make the JAX
package's own failing test files importable partway through a run.

The snippet reads ``IN`` (a dict of numpy arrays from the caller) and
fills ``OUT``; numpy arrays come back through a temporary ``.npz``,
everything else (numbers, strings, lists) through a JSON file.

The case functions (``search_cases``, ``topology_cases``) take a package
name, ``"repro"`` or ``"repro_torch"``, and build the same workloads,
designs, constraints and spaces from it, so both sides of a comparison
run one definition.  This module imports neither package itself.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)

_PRELUDE = """\
import json, sys
import numpy as np
import jax
import jax.experimental
jax.experimental.enable_x64 = jax.enable_x64
sys.path.insert(0, {tests!r})
IN = dict(np.load({inp!r}))
OUT = {{}}
"""

_EPILOGUE = """
arrays = {{k: v for k, v in OUT.items() if isinstance(v, np.ndarray)}}
np.savez({out_npz!r}, **arrays)
with open({out_json!r}, "w") as f:
    json.dump({{k: v for k, v in OUT.items() if k not in arrays}}, f)
"""


def run_reference(code: str, inputs: dict | None = None,
                  timeout: int = 600, env: dict | None = None) -> dict:
    """Run ``code`` against the JAX package in a subprocess (CPU, with
    the ``enable_x64`` alias) and return its ``OUT`` dict.  ``env`` adds
    to the subprocess's environment (``XLA_FLAGS`` to force host
    devices)."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in
                 ("inp.npz", "out.npz", "out.json")}
        np.savez(paths["inp.npz"], **(inputs or {}))
        script = (_PRELUDE.format(tests=TESTS, inp=paths["inp.npz"])
                  + textwrap.dedent(code)
                  + _EPILOGUE.format(out_npz=paths["out.npz"],
                                     out_json=paths["out.json"]))
        full_env = dict(os.environ, JAX_PLATFORMS="cpu",
                        PYTHONPATH=os.pathsep.join(
                            [os.path.join(ROOT, "src"), ROOT]),
                        **(env or {}))
        proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                              env=full_env, capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"reference subprocess failed:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        with open(paths["out.json"]) as f:
            out = json.load(f)
        with np.load(paths["out.npz"]) as z:
            out.update({k: z[k] for k in z.files})
    return out


def reference_fixture(code: str, inputs=None, name: str = "reference"):
    """A module-scoped fixture ``name`` running ``code`` once per test
    file; ``inputs`` is a dict of arrays or a callable returning one."""
    @pytest.fixture(scope="module", name=name)
    def fixture():
        data = inputs() if callable(inputs) else inputs
        return run_reference(code, data)
    return fixture


def loops_of(nest) -> list:
    """A LoopNest as plain lists (rank, bound, level, spatial)."""
    return [[lp.rank, int(lp.bound), int(lp.level), bool(lp.spatial)]
            for lp in nest.loops]


def genomes_for(enc, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(wild, repaired) fixed genomes: out-of-range integers drawn with
    numpy, and the encoding's repair of them."""
    wild = np.random.default_rng(seed).integers(
        -1000, 1000, size=(n, enc.genome_size))
    return wild, enc.repair(wild)


# ----------------------------------------------------------------------
# cases both packages build
# ----------------------------------------------------------------------
def _mods(pkg: str):
    core = importlib.import_module(f"{pkg}.core")
    return (core, importlib.import_module(f"{pkg}.core.mapper"),
            importlib.import_module(f"{pkg}.core.presets"),
            importlib.import_module(f"{pkg}.search"))


def actual_array() -> np.ndarray:
    """The actual-data density of the search tests' 8x8x8 workload."""
    return (np.random.default_rng(0).random((8, 8)) < 0.4).astype(float)


def search_cases(pkg: str) -> dict:
    """name -> (design, workload, encoding) of the search parity tests:
    free and pinned permutations, no spatial fanout, the Table-5
    ResNet50 conv2_x slice, (design, mapping) co-search and an
    actual-data workload."""
    core, mapper, presets, search = _mods(pkg)
    cons = mapper.MapspaceConstraints
    wl = core.matmul(32, 32, 32, densities={"A": ("uniform", 0.3),
                                            "B": ("uniform", 0.3)})
    design = presets.coordinate_list_design(
        presets.two_level_arch(buffer_kwords=8))
    spatial = cons(budget=96, seed=0, spatial={1: {"n": 4}})
    conv = core.matmul(3136, 576, 64, densities={"A": ("uniform", 0.4),
                                                 "B": ("uniform", 0.55)})
    scnn = presets.scnn_like(presets.three_level_arch())
    space = search.DesignSpace(
        capacity_steps={"Buffer": (2048, 8192, 32768)},
        bandwidth_steps={"DRAM": (8, 32)},
        compute_steps={"mac_energy_pj": (0.5, 1.0)})
    actual = core.matmul(8, 8, 8, densities={"A": ("actual",
                                                   actual_array())})
    return {
        "free": (design, wl, search.MapspaceEncoding(wl, 2, spatial)),
        "no_spatial": (design, wl, search.MapspaceEncoding(
            wl, 2, cons(budget=96, seed=0))),
        "pinned": (design, wl, search.MapspaceEncoding(
            wl, 2, cons(budget=96, seed=0, spatial={1: {"n": 4}},
                        permutations={0: ("n", "k", "m"),
                                      1: ("m", "n")}))),
        "conv2_x": (scnn, conv, search.MapspaceEncoding(
            conv, 3, cons(budget=512, seed=0, spatial={1: {"n": 8}}))),
        "cosearch": (design, wl, search.CoSearchEncoding(
            wl, 2, spatial, space, design)),
        "actual": (design, actual, search.MapspaceEncoding(
            actual, 2, cons(budget=32, seed=0))),
    }


def topology_space(pkg: str):
    """The TopologySpace of the JAX package's topology tests: DRAM, an
    optional GLB and a required SPad, with a skip catalog on GLB and
    SPad (6 distinct topologies)."""
    core = importlib.import_module(f"{pkg}.core")
    arch = importlib.import_module(f"{pkg}.core.arch")
    search = importlib.import_module(f"{pkg}.search")
    skip = search.SAFOption(
        "skip",
        formats=(("A", core.TensorFormat.of("UOP", "CP", coord_bits=4)),
                 ("B", core.TensorFormat.of("UOP", "CP", coord_bits=4))),
        actions=((core.SAFKind.SKIP, "Z", ("A", "B")),))
    return search.TopologySpace(
        slots=(
            search.LevelSlot(arch.StorageLevel(
                "DRAM", float("inf"), 16, 200.0, 200.0, 0.0)),
            search.LevelSlot(arch.StorageLevel(
                "GLB", 96 * 1024, 128, 6.0, 6.0, 0.05),
                optional=True, saf_options=(search.SAF_NONE, skip)),
            search.LevelSlot(arch.StorageLevel(
                "SPad", 512, 128, 1.2, 1.2, 0.02),
                saf_options=(search.SAF_NONE, skip)),
        ),
        compute=arch.ComputeLevel("MAC", instances=64, mac_energy_pj=1.0,
                                  gated_energy_pj=0.05),
        name="topo")


def topology_cases(pkg: str) -> dict:
    """name -> (workload, encoding) of the topology parity tests: the
    (topology, mapping) genome and the (topology, design, mapping) one
    with knobs on the optional GLB, the SPad and the compute unit."""
    core, mapper, _, search = _mods(pkg)
    wl = core.matmul(32, 32, 32, densities={"A": ("uniform", 0.3),
                                            "B": ("uniform", 0.4)})
    cons = mapper.MapspaceConstraints(budget=128, seed=0,
                                      spatial={0: {"n": 4}})
    ts = topology_space(pkg)
    space = search.DesignSpace(
        capacity_steps={"GLB": (32 * 1024, 96 * 1024),
                        "SPad": (256, 512, 1024)},
        compute_steps={"instances": (16, 64)})
    return {
        "topology": (wl, search.TopologyCoSearchEncoding(wl, cons, ts)),
        "topology_design": (wl, search.TopologyCoSearchEncoding(
            wl, cons, ts, space)),
    }


# ----------------------------------------------------------------------
# what both sides compute on the same genomes
# ----------------------------------------------------------------------
def _bucket(bucket) -> list:
    return [list(bucket.ranks), [int(x) for x in bucket.temporal_slots],
            [int(x) for x in bucket.spatial_slots]]


def encoding_outputs(enc, wild: np.ndarray, pop: np.ndarray) -> dict:
    """An encoding's layout and its decode of fixed genomes: sizes,
    cardinalities, crossover blocks, repair, the per-template and the
    bucket-relative decodes, and every genome's nest (and, for
    co-search, its design genes, arch rows and design name)."""
    out = {"genome_size": int(enc.genome_size),
           "num_blocks": int(enc.num_blocks),
           "cardinality": np.asarray(enc.cardinality),
           "gene_block": np.asarray(enc.gene_block),
           "repair": enc.repair(wild),
           "nests": [loops_of(enc.nest_of(g)) for g in pop]}
    groups = enc.decode_population(pop)
    out["templates"] = [[list(s) for s in t.slots] for t, _, _ in groups]
    for j, (_, idx, bounds) in enumerate(groups):
        out[f"template{j}.idx"] = np.asarray(idx)
        out[f"template{j}.bounds"] = np.asarray(bounds)
    bucket, bounds, ids = enc.decode_bucketed(pop)
    out["bucket"] = _bucket(bucket)
    out["bucket.bounds"] = bounds
    out["bucket.ids"] = ids
    if hasattr(enc, "arch_params_of"):
        ap = enc.arch_params_of(pop)
        out["design_genes"] = enc.design_genes(pop)
        out["arch.storage"] = np.asarray(ap.storage)
        out["arch.compute"] = np.asarray(ap.compute)
        out["designs"] = [enc.design_of(g).name for g in pop]
    return out


def topology_outputs(enc, wild: np.ndarray, pop: np.ndarray) -> dict:
    """A topology encoding's layout and its decode of fixed genomes: the
    topology groups, each group's folded sub-genomes and bucket-relative
    decode (and arch rows with a DesignSpace), every genome's nest and
    design name, and the space's distinct topologies."""
    out = {"genome_size": int(enc.genome_size),
           "num_blocks": int(enc.num_blocks),
           "cardinality": np.asarray(enc.cardinality),
           "gene_block": np.asarray(enc.gene_block),
           "repair": enc.repair(wild),
           "nests": [loops_of(enc.nest_of(g)) for g in pop],
           "designs": [enc.design_of(g).name for g in pop],
           "topologies": [d.name for _, d in enc.topo.enumerate_designs()]}
    groups = enc.group_by_topology(pop)
    out["groups"] = [grp.design.name for grp, _ in groups]
    for j, (grp, idx) in enumerate(groups):
        sub = enc.sub_genomes(pop[idx], grp)
        bucket, bounds, ids = grp.enc.decode_bucketed(sub)
        out[f"group{j}.idx"] = np.asarray(idx)
        out[f"group{j}.sub"] = sub
        out[f"group{j}.bucket"] = _bucket(bucket)
        out[f"group{j}.bounds"] = bounds
        out[f"group{j}.ids"] = ids
        ap = enc.group_arch_params(pop[idx], grp)
        if ap is not None:
            out[f"group{j}.storage"] = np.asarray(ap.storage)
            out[f"group{j}.compute"] = np.asarray(ap.compute)
    return out


def fitness_outputs(pkg: str, design, wl, enc, pop: np.ndarray,
                    **config) -> dict:
    """``PopulationEvaluator`` of package ``pkg`` on ``pop`` under a
    ``SearchConfig(**config)``: cycles, energy, EDP and validity per
    genome (the port on the CPU, the JAX package without a mesh)."""
    search = importlib.import_module(f"{pkg}.search")
    cfg = search.SearchConfig(**config)
    if pkg == "repro":
        ev = search.PopulationEvaluator(design, wl, enc, mesh=None,
                                        config=cfg)
    else:
        ev = search.PopulationEvaluator(design, wl, enc, config=cfg,
                                        device="cpu")
    res = ev(pop)
    return {k: np.asarray(res[k])
            for k in ("cycles", "energy_pj", "edp", "valid")}


def assert_same(got: dict, want: dict, prefix: str = "") -> None:
    """Every key of ``want`` equal in ``got``: arrays exactly, the rest
    by ``==``."""
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(np.asarray(g), w,
                                          err_msg=prefix + k)
        else:
            assert g == w, prefix + k


def assert_fitness_close(got: dict, want: dict, rel: float = 1e-6) -> None:
    """Metrics within ``rel`` relative where finite, infinities and
    validity equal."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in ("cycles", "energy_pj", "edp"):
        g, w = np.asarray(got[k], float), np.asarray(want[k], float)
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w),
                                      err_msg=k)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=rel, atol=0,
                                   err_msg=k)


def fitness_routes(name: str) -> dict:
    """route -> SearchConfig fields for a search case: the bucketed
    engine, the scalar oracle and, for the pinned-permutation case (one
    template), the per-template engine."""
    routes = {"bucket": dict(batch_threshold=1),
              "scalar": dict(batch_threshold=10 ** 9)}
    if name == "pinned":
        routes["template"] = dict(batch_threshold=1, bucketed=False)
    return routes


# ----------------------------------------------------------------------
# the strategies' random draws, and their convergence over seeds
# ----------------------------------------------------------------------
#: draws of each random primitive in :func:`strategy_draws`
DRAWS = 8192
#: the population tournament selection draws from: 32 distinct fitness
#: values in a fixed shuffled order (rank r of 32 wins a 3-way
#: tournament w.p. ((32 - r) / 32)^3 - ((31 - r) / 32)^3)
SELECT_FITNESS = np.random.default_rng(7).permutation(32) + 1.0
#: log-fitness increases an annealing proposal is tested at (cycled
#: over the DRAWS chains); at generation 1 the temperature is
#: t0 * cooling = 0.46, so each is accepted w.p. exp(-delta / 0.46)
ANNEAL_DELTAS = np.array([0.05, 0.2, 0.5, 1.0])
#: strategies whose convergence is compared, and the seeds of each
STRATEGY_NAMES = ("random", "hillclimb", "annealing", "es")
SEEDS = 20


#: family-wise level of each distribution test (Bonferroni over columns)
ALPHA = 1e-3


def _stats():
    import scipy.stats
    return scipy.stats


def _counts(col, cats) -> np.ndarray:
    return np.array([(col == c).sum() for c in cats], float)


def homogeneity(a, b) -> float:
    """p-value of a chi-square test that samples ``a`` and ``b`` come
    from one distribution over the values they take."""
    cats = np.union1d(np.unique(a), np.unique(b))
    if len(cats) < 2:
        return 1.0
    table = np.stack([_counts(a, cats), _counts(b, cats)])
    return _stats().chi2_contingency(table, correction=False).pvalue


def fit_law(col, probs) -> float:
    """p-value of a chi-square goodness-of-fit test of ``col`` (values
    0..len(probs)-1) against ``probs``."""
    probs = np.asarray(probs, float)
    keep = probs > 0
    obs = _counts(col, np.arange(len(probs)))
    assert obs[~keep].sum() == 0, "a value drawn with probability 0"
    if keep.sum() < 2:
        return 1.0
    exp = probs[keep] / probs[keep].sum() * len(col)
    return _stats().chisquare(obs[keep], exp).pvalue


def assert_all(pvalues, what) -> None:
    p = np.asarray(pvalues, float)
    assert p.min() * len(p) >= ALPHA, \
        f"{what}: p = {p.min():.3g} at column {int(p.argmin())} " \
        f"(Bonferroni over {len(p)})"


def same_columns(a, b, what) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert_all([homogeneity(a[:, j], b[:, j])
                for j in range(a.shape[1])], what)


def strategy_draws(pkg: str, make_key) -> dict:
    """``DRAWS`` draws of every random primitive of package ``pkg``'s
    search strategies, on the Table-5 conv2_x encoding, plus the
    population constructors of the co-search and topology encodings.
    ``make_key(i)`` gives the i-th key in the package's own kind
    (``jax.random.PRNGKey`` for ``repro``, ``int`` for
    ``repro_torch``)."""
    S = importlib.import_module(f"{pkg}.search.strategies")
    cases = search_cases(pkg)
    enc = cases["conv2_x"][2]
    base = np.tile(genomes_for(enc, 1, seed=0)[1], (DRAWS, 1))
    other = (base + 1) % enc.cardinality
    out = {"base": base[0], "cardinality": np.asarray(enc.cardinality),
           "gene_block": np.asarray(enc.gene_block),
           "mutate": S.mutate(make_key(0), base, enc, 0.15),
           "crossover": S.crossover(make_key(1), base, other, enc),
           "select": S.EvolutionStrategy()._select(
               make_key(2), SELECT_FITNESS, DRAWS),
           "init": S.init_population(make_key(3), enc, DRAWS)}
    sa = S.SimulatedAnnealing(pop_size=DRAWS)
    st = sa.init(make_key(4), enc)
    sa.tell(st, enc, base, np.ones(DRAWS))
    sa.tell(st, enc, other, np.exp(np.resize(ANNEAL_DELTAS, DRAWS)))
    out["accept"] = (st.cur == other).all(axis=1)
    es = S.EvolutionStrategy(pop_size=DRAWS)
    st = es.init(make_key(5), enc)
    st.pop = enc.repair(genomes_for(enc, len(SELECT_FITNESS), seed=1)[1])
    st.fit = SELECT_FITNESS
    out["es_children"] = es.ask(st, enc)
    encs = {"conv2_x": enc, "cosearch": cases["cosearch"][2],
            "topology_design": topology_cases(pkg)["topology_design"][1]}
    for i, (name, e) in enumerate(encs.items()):
        out[f"{name}.cardinality"] = np.asarray(e.cardinality)
        out[f"{name}.random"] = e.random_population(make_key(6 + 2 * i),
                                                    DRAWS)
        out[f"{name}.structured"] = e.structured_population(
            make_key(7 + 2 * i), DRAWS)
    return out


def convergence_ratios(pkg: str, seeds=range(SEEDS)) -> dict:
    """The Table-5 convergence cell (ResNet50 conv2_x, the SCNN-like
    three-level design, spatial n = 8) in package ``pkg``: the best EDP
    of enumeration at budgets 512 and 5120, and of each strategy at
    budget 512 (population 32) over ``seeds``, as ratios to
    enumeration@5120.  The port runs on the CPU."""
    core, mapper, presets, search = _mods(pkg)
    wl = core.matmul(3136, 576, 64, densities={"A": ("uniform", 0.4),
                                               "B": ("uniform", 0.55)})
    design = presets.scnn_like(presets.three_level_arch())
    kw = {"mesh": None} if pkg == "repro" else {"device": "cpu"}
    enum_kw = {} if pkg == "repro" else {"device": "cpu"}
    cons = mapper.MapspaceConstraints
    enum = {b: mapper.search(design, wl, cons(budget=b, seed=0,
                                              spatial={1: {"n": 8}}),
                             **enum_kw).best.edp for b in (512, 5120)}
    out = {"enum512_edp": enum[512], "enum5120_edp": enum[5120]}
    for strat in STRATEGY_NAMES:
        out[strat] = [search.run_search(
            design, wl, cons(budget=512, seed=0, spatial={1: {"n": 8}}),
            strategy=strat, key=int(k), pop_size=32, **kw).best.edp
            / enum[5120] for k in seeds]
    return out


#: the hybrid ES+SGD cell of ``benchmarks/bench_fused.py``: population,
#: generations (one chunk) and the SGD step in log units
HYBRID_POP, HYBRID_GENERATIONS, HYBRID_LR = 32, 12, 0.5


def hybrid_space(pkg: str):
    """``bench_codesign``'s provisioning space: GLB and SPad capacities
    and the DRAM bandwidth of ``scnn_like(three_level_arch())``."""
    search = importlib.import_module(f"{pkg}.search")
    return search.DesignSpace(
        capacity_steps={"GLB": (6 * 1024, 48 * 1024, 96 * 1024,
                                192 * 1024),
                        "SPad": (64, 256, 512)},
        bandwidth_steps={"DRAM": (2.0, 8.0, 32.0)})


def hybrid_ratios(pkg: str, seeds=range(SEEDS)) -> dict:
    """Fused ES with the hybrid SGD step over fused pure ES, at equal
    budget and seed, on the Table-5 conv2_x cell co-searching
    :func:`hybrid_space` (``bench_fused``'s hybrid comparison), over
    ``seeds``: each run's best EDP and the ratios hybrid / pure.  The
    port runs on the CPU."""
    core, mapper, presets, search = _mods(pkg)
    wl = core.matmul(3136, 576, 64, densities={"A": ("uniform", 0.4),
                                               "B": ("uniform", 0.55)})
    design = presets.scnn_like(presets.three_level_arch())
    cons = mapper.MapspaceConstraints(
        budget=HYBRID_POP * HYBRID_GENERATIONS, seed=0,
        spatial={1: {"n": 8}})
    kw = dict(strategy="es", pop_size=HYBRID_POP,
              generations=HYBRID_GENERATIONS,
              design_space=hybrid_space(pkg), fused=True,
              config=search.SearchConfig(fused_chunk=HYBRID_GENERATIONS))
    kw.update({"mesh": None} if pkg == "repro" else {"device": "cpu"})
    out = {"pure": [], "hybrid": []}
    for k in seeds:
        for name, lr in (("pure", 0.0), ("hybrid", HYBRID_LR)):
            res = search.run_search(design, wl, cons, key=int(k),
                                    sgd_lr=lr, **kw)
            out[name].append(float(res.best.edp))
    out["ratios"] = [h / p for h, p in zip(out["hybrid"], out["pure"])]
    return out


if __name__ == "__main__":
    # PYTHONPATH=src python tests/torch_reference.py [seeds] [hybrid]
    # prints each strategy's best EDP at budget 512 over enumeration's
    # at 5120, over seeds 0..seeds-1, for the JAX package (in a
    # subprocess) and for the port (on the CPU); with "hybrid", the
    # hybrid ES+SGD / pure fused ES ratios of the same seeds instead
    n = int(sys.argv[1]) if len(sys.argv) > 1 else SEEDS
    if sys.argv[2:] == ["hybrid"]:
        ref = run_reference(f"""
            import torch_reference as R
            OUT.update(R.hybrid_ratios("repro", range({n})))
        """)
        port = hybrid_ratios("repro_torch", range(n))
        for name, r in (("repro (JAX, jax.random)", ref),
                        ("repro_torch (counter hash)", port)):
            x = r["ratios"]
            print(f"{name}: hybrid / pure median {np.median(x):.4f}, "
                  f"<= 1 in {sum(v <= 1.0 for v in x)} of {n}; ratios "
                  f"{[float(v) for v in x]}")
        sys.exit(0)
    ref = run_reference(f"""
        import torch_reference as R
        OUT.update(R.convergence_ratios("repro", range({n})))
    """)
    port = convergence_ratios("repro_torch", range(n))
    for name, r in (("repro (JAX, jax.random)", ref),
                    ("repro_torch (torch.Generator)", port)):
        print(f"{name}: enumeration@5120 EDP {r['enum5120_edp']:.6e}, "
              f"@512 {r['enum512_edp']:.6e}")
        for strat in STRATEGY_NAMES:
            x = r[strat]
            print(f"  {strat}@512 ratio: key 0 {x[0]:.4f}, median "
                  f"{np.median(x):.4f}, <= 1 in "
                  f"{sum(v <= 1.0 for v in x)} of {n}; "
                  f"ratios {[round(v, 4) for v in x]}")
