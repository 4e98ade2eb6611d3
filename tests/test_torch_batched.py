"""The port's batched engine against the JAX package's scalar oracle.

``repro_torch.core.batched`` (exact templates and padded buckets),
``Sparseloop.evaluate_batch`` / ``evaluate_network`` /
``evaluate_designs`` and the batched ``mapper.search`` dispatch must
reproduce ``repro.core.engine.Sparseloop.evaluate`` to <= 1e-6 relative
on the cases of ``tests/test_batched.py`` and ``tests/test_bucketed.py``
(CPU, ``device="cpu"``).  The scalar oracle is the reference here: it is
what the JAX batched engine was itself held to.  Mixed-permutation
populations are drawn with numpy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import Sparseloop as RefSparseloop  # noqa: E402
from repro.core import matmul as ref_matmul  # noqa: E402
from repro.core.arch import (Architecture as RefArchitecture,  # noqa: E402
                             ComputeLevel as RefComputeLevel,
                             StorageLevel as RefStorageLevel,
                             pack_arch_params as ref_pack_arch_params)
from repro.core.mapper import MapspaceConstraints as RefCons  # noqa: E402
from repro.core.mapper import search as ref_search  # noqa: E402
from repro.core.mapping import Loop as RefLoop  # noqa: E402
from repro.core.mapping import LoopNest as RefLoopNest  # noqa: E402
from repro.core.mapping import factor_splits, factorize  # noqa: E402
from repro.core import presets as ref_presets  # noqa: E402
from repro_torch.core import Sparseloop, compile_stats  # noqa: E402
from repro_torch.core.arch import ArchParams  # noqa: E402
from repro_torch.core.batched import (NestTemplate, batched_supported,  # noqa: E402
                                      bucket_for, clear_caches,
                                      get_bucketed_model, group_by_bucket,
                                      template_of)
from repro_torch.core.mapper import MapspaceConstraints, search  # noqa: E402
from repro_torch.interop import from_reference  # noqa: E402

CPU = "cpu"
M = N = K = 16
DA, DB = 0.25, 0.5
DENS = {"A": ("uniform", DA), "B": ("uniform", DB)}
SPMSPM = NestTemplate(
    slots=(("m", 1, False), ("n", 1, False), ("n", 1, True),
           ("n", 0, False), ("k", 0, False), ("m", 0, False)),
    num_levels=2)
MAKERS = ("dense_design", "bitmask_design", "coordinate_list_design")


def _design(maker, **arch_kw):
    ref = getattr(ref_presets, maker)(ref_presets.two_level_arch(**arch_kw))
    return ref, from_reference(ref)


def _bounds():
    """(C, 6) SPMSPM bounds for every (m1, m0, n1, ns, n0) tiling."""
    out = []
    for m1, m0 in factorize(M):
        for n1, rest in factorize(N):
            for ns, n0 in factorize(rest):
                out.append((m1, n1, ns, n0, K, m0))
    return np.asarray(out, np.int64)


def _ref_nest(template, b):
    return RefLoopNest(
        loops=tuple(RefLoop(r, int(x), lvl, sp)
                    for (r, lvl, sp), x in zip(template.slots, b) if x > 1),
        num_levels=template.num_levels)


def _population(wl, num_levels, n, seed, spatial=None, n_perms=None):
    """``n`` random reference nests: random factor splits per rank and a
    random loop order per level (``n_perms`` distinct orders at most),
    with ``spatial`` {level: {rank: bound}} loops."""
    rng = np.random.default_rng(seed)
    spatial = spatial or {}
    ranks = list(wl.rank_bounds)
    residual = dict(wl.rank_bounds)
    for d in spatial.values():
        for r, b in d.items():
            residual[r] //= b
    splits = {r: list(factor_splits(residual[r], num_levels))
              for r in ranks}
    orders = [[list(rng.permutation(ranks)) for _ in range(num_levels)]
              for _ in range(n_perms or n)]
    nests = []
    for i in range(n):
        pick = {r: splits[r][rng.integers(len(splits[r]))] for r in ranks}
        order = orders[i % len(orders)]
        loops = []
        for lvl in range(num_levels - 1, -1, -1):
            loops += [RefLoop(r, pick[r][lvl], lvl) for r in order[lvl]
                      if pick[r][lvl] > 1]
            loops += [RefLoop(r, b, lvl, True)
                      for r, b in spatial.get(lvl, {}).items() if b > 1]
        nests.append(RefLoopNest(loops=tuple(loops), num_levels=num_levels))
    return nests


def _assert_matches(out, i, ev, keys=("cycles", "energy_pj", "edp")):
    for k in keys:
        want = getattr(ev.result if k.startswith("compute") else ev, k)
        assert out[k][i] == pytest.approx(want, rel=1e-6), (i, k)


# ----------------------------------------------------------------------
# exact templates
# ----------------------------------------------------------------------
@pytest.mark.parametrize("maker", MAKERS)
def test_exact_template_parity_with_scalar_oracle(maker):
    ref_design, design = _design(maker, buffer_kwords=64)
    ref_wl = ref_matmul(M, K, N, densities=DENS)
    wl = from_reference(ref_wl)
    bounds = _bounds()
    assert len(bounds) >= 50
    out = Sparseloop(design, device=CPU).batched_model(
        wl, SPMSPM, check_capacity=False).evaluate(bounds)
    ref = RefSparseloop(ref_design)
    for i, b in enumerate(bounds):
        ev = ref.evaluate(ref_wl, _ref_nest(SPMSPM, b), check_capacity=False)
        _assert_matches(out, i, ev, ("cycles", "energy_pj", "edp",
                                     "compute_actual", "compute_gated",
                                     "compute_skipped"))


def test_exact_template_capacity_validity_matches_scalar():
    ref_design, design = _design("coordinate_list_design",
                                 buffer_kwords=0.25)
    ref_wl = ref_matmul(M, K, N, densities=DENS)
    out = Sparseloop(design, device=CPU).batched_model(
        from_reference(ref_wl), SPMSPM).evaluate(_bounds())
    ref = [RefSparseloop(ref_design).evaluate(
        ref_wl, _ref_nest(SPMSPM, b)).result.valid for b in _bounds()]
    assert out["valid"].tolist() == ref
    assert 0 < sum(ref) < len(ref)        # the check actually separates


@pytest.mark.parametrize("kind", ["banded", "actual", "structured"])
def test_exact_template_parity_density_kinds(kind):
    a = {"banded": ("banded", {"rows": M, "cols": K, "half_band": 2}),
         "actual": ("actual", (np.random.default_rng(7).random((M, K))
                               < 0.35).astype(float)),
         "structured": ("structured", {"n": 2, "m": 4})}[kind]
    ref_design, design = _design("coordinate_list_design", buffer_kwords=64)
    ref_wl = ref_matmul(M, K, N, densities={"A": a, "B": ("uniform", DB)})
    bounds = _bounds()[::3]
    out = Sparseloop(design, device=CPU).batched_model(
        from_reference(ref_wl), SPMSPM,
        check_capacity=False).evaluate(bounds)
    ref = RefSparseloop(ref_design)
    for i, b in enumerate(bounds):
        _assert_matches(out, i, ref.evaluate(
            ref_wl, _ref_nest(SPMSPM, b), check_capacity=False))


@pytest.mark.parametrize("bucketed", [True, False])
def test_evaluate_batch_groups_mixed_templates(bucketed):
    ref_design, design = _design("dense_design", buffer_kwords=64)
    ref_wl = ref_matmul(M, K, N, densities=DENS)
    ref_nests = [_ref_nest(SPMSPM, b) for b in _bounds()[:8]]
    out = Sparseloop(design, device=CPU).evaluate_batch(
        from_reference(ref_wl), [from_reference(n) for n in ref_nests],
        check_capacity=False, bucketed=bucketed)
    assert out["cycles"].shape == (len(ref_nests),)
    assert out["occupancy"].shape == (len(ref_nests), 2)
    for i, n in enumerate(ref_nests):
        _assert_matches(out, i, RefSparseloop(ref_design).evaluate(
            ref_wl, n, check_capacity=False))


def test_unknown_density_spec_unsupported():
    _, design = _design("dense_design")
    wl = from_reference(ref_matmul(M, K, N,
                                   densities={"A": ("no-such-model", 0.5)}))
    assert not batched_supported(design, wl)


def test_template_roundtrip():
    b = np.asarray([4, 1, 2, 2, K, 4])
    nest = SPMSPM.nest_with(b)
    assert all(lp.bound > 1 for lp in nest.loops)
    t = NestTemplate.of_nest(nest)
    assert t.num_levels == 2
    np.testing.assert_array_equal(t.bounds_of(nest),
                                  [lp.bound for lp in nest.loops])


# ----------------------------------------------------------------------
# buckets
# ----------------------------------------------------------------------
@pytest.mark.parametrize("maker", MAKERS)
def test_bucketed_parity_mixed_permutations(maker):
    ref_design, design = _design(maker, buffer_kwords=64)
    ref_wl = ref_matmul(M, K, N, densities=DENS)
    wl = from_reference(ref_wl)
    ref_nests = _population(ref_wl, 2, 48, seed=1, spatial={1: {"n": 4}},
                            n_perms=6)
    nests = [from_reference(n) for n in ref_nests]
    assert len({template_of(n) for n in nests}) >= 4
    groups = group_by_bucket(nests, tuple(wl.rank_bounds))
    assert len(groups) == 1
    out = Sparseloop(design, device=CPU).evaluate_batch(
        wl, nests, check_capacity=False)
    ref = RefSparseloop(ref_design)
    for i, n in enumerate(ref_nests):
        _assert_matches(out, i, ref.evaluate(ref_wl, n,
                                             check_capacity=False))


def test_bucketed_parity_banded_density():
    ref_design, design = _design("coordinate_list_design", buffer_kwords=64)
    ref_wl = ref_matmul(M, K, N, densities={
        "A": ("banded", {"rows": M, "cols": K, "half_band": 2}),
        "B": ("uniform", 0.5)})
    ref_nests = _population(ref_wl, 2, 24, seed=3, spatial={1: {"n": 4}})
    out = Sparseloop(design, device=CPU).evaluate_batch(
        from_reference(ref_wl), [from_reference(n) for n in ref_nests],
        check_capacity=False)
    for i, n in enumerate(ref_nests):
        _assert_matches(out, i, RefSparseloop(ref_design).evaluate(
            ref_wl, n, check_capacity=False))


def test_bucketed_one_level_arch_and_unit_bounds():
    ref_arch = RefArchitecture(
        name="one-level",
        levels=(RefStorageLevel("Buffer", float("inf"), 64, 6.0),),
        compute=RefComputeLevel("MAC", instances=4))
    ref_design = ref_presets.dense_design(ref_arch)
    ref_wl = ref_matmul(8, 1, 4, densities={"A": ("uniform", 0.5)})
    wl = from_reference(ref_wl)
    ref_nests = _population(ref_wl, 1, 16, seed=5)
    nests = [from_reference(n) for n in ref_nests]
    bucket = bucket_for(template_of(nests[0]), tuple(wl.rank_bounds))
    assert bucket.temporal_slots == (3,) and bucket.spatial_slots == (0,)
    out = Sparseloop(from_reference(ref_design), device=CPU).evaluate_batch(
        wl, nests, check_capacity=False)
    for i, n in enumerate(ref_nests):
        _assert_matches(out, i, RefSparseloop(ref_design).evaluate(
            ref_wl, n, check_capacity=False))


def test_bucketed_capacity_validity_matches_scalar():
    ref_design, design = _design("coordinate_list_design",
                                 buffer_kwords=0.06)
    ref_wl = ref_matmul(M, K, N, densities=DENS)
    ref_nests = _population(ref_wl, 2, 32, seed=7, spatial={1: {"n": 4}})
    out = Sparseloop(design, device=CPU).evaluate_batch(
        from_reference(ref_wl), [from_reference(n) for n in ref_nests])
    ref = [RefSparseloop(ref_design).evaluate(ref_wl, n).result.valid
           for n in ref_nests]
    assert out["valid"].tolist() == ref
    assert 0 < sum(ref) < len(ref)


# ----------------------------------------------------------------------
# program accounting
# ----------------------------------------------------------------------
def test_mixed_permutation_population_runs_on_one_program():
    clear_caches()
    ref_design, design = _design("dense_design", buffer_kwords=64)
    ref_wl = ref_matmul(M, K, N, densities=DENS)
    nests = [from_reference(n) for n in
             _population(ref_wl, 2, 32, seed=9, spatial={1: {"n": 4}})]
    assert len({template_of(n) for n in nests}) > 1
    with compile_stats.track() as st:
        out = Sparseloop(design, device=CPU).evaluate_batch(
            from_reference(ref_wl), nests, check_capacity=False)
    assert out["cycles"].shape == (len(nests),)
    assert st.programs == 1
    assert st.compiles_by_kind == {"bucket": 1}
    assert st.batched_evals == len(nests) and st.scalar_evals == 0


def test_compile_stats_counts_programs_and_shapes():
    clear_caches()
    ref_design, design = _design("dense_design")
    ref_wl = ref_matmul(8, 8, 8, densities={"A": ("uniform", 0.5)})
    wl = from_reference(ref_wl)
    nests = [from_reference(n) for n in _population(ref_wl, 2, 8, seed=0)]
    bucket = bucket_for(template_of(nests[0]), tuple(wl.rank_bounds))
    from repro_torch.core.batched import lower_nests
    bounds, ids, _ = lower_nests(bucket, nests, range(len(nests)))
    with compile_stats.track() as st:
        bm = get_bucketed_model(design, wl, bucket, check_capacity=False,
                                device=CPU)
        bm.evaluate(bounds, ids)           # first sighting of the shape
        bm.evaluate(bounds, ids)           # same shape: warm
        bm.evaluate(bounds[:4], ids[:4])   # new shape
        get_bucketed_model(design, wl, bucket, check_capacity=False,
                           device=CPU)
    assert st.programs == 1
    assert st.compiles == 2
    assert st.cache_hits >= 1
    assert st.batched_evals == 8 + 8 + 4
    assert st.compile_seconds > 0 and st.eval_seconds > 0


def test_evaluate_network_layers_share_one_program():
    """Layers of one structure, mixed density kinds, one program; each
    layer's metrics equal the oracle's."""
    clear_caches()
    ref_design, design = _design("coordinate_list_design", buffer_kwords=64)
    rng = np.random.default_rng(11)
    ref_wls = [
        ref_matmul(16, 16, 16, densities=DENS),
        ref_matmul(32, 16, 8, densities={
            "A": ("banded", {"rows": 32, "cols": 16, "half_band": 3})}),
        ref_matmul(8, 32, 16, densities={
            "A": ("actual", (rng.random((8, 32)) < 0.4).astype(float)),
            "B": ("structured", {"n": 2, "m": 4})}),
    ]
    pops = [_population(w, 2, 12, seed=i, spatial={1: {"n": 4}})
            for i, w in enumerate(ref_wls)]
    with compile_stats.track() as st:
        outs = Sparseloop(design, device=CPU).evaluate_network(
            [from_reference(w) for w in ref_wls],
            [[from_reference(n) for n in p] for p in pops],
            check_capacity=False)
    assert st.programs == 1 and st.program_shares == len(ref_wls) - 1
    for out, w, pop in zip(outs, ref_wls, pops):
        for i, n in enumerate(pop):
            _assert_matches(out, i, RefSparseloop(ref_design).evaluate(
                w, n, check_capacity=False))


def test_evaluate_designs_and_per_candidate_arch_rows():
    """A design sweep shares programs; per-candidate arch rows carried
    across from the JAX package's packing bind one design per
    candidate."""
    ref_design, design = _design("bitmask_design", buffer_kwords=64)
    ref_wl = ref_matmul(M, K, N, densities=DENS)
    wl = from_reference(ref_wl)
    ref_nests = _population(ref_wl, 2, 10, seed=4, spatial={1: {"n": 4}})
    nests = [from_reference(n) for n in ref_nests]
    ref_archs = [ref_presets.two_level_arch(buffer_kwords=kw, buffer_bw=bw)
                 for kw, bw in ((64, 256), (0.5, 64), (8, 32))]
    engine = Sparseloop(design, device=CPU)
    outs = engine.evaluate_designs([from_reference(a) for a in ref_archs],
                                   wl, nests)
    for out, ra in zip(outs, ref_archs):
        ref = RefSparseloop(ref_design.__class__(arch=ra,
                                                 safs=ref_design.safs))
        for i, n in enumerate(ref_nests):
            ev = ref.evaluate(ref_wl, n)
            assert bool(out["valid"][i]) == ev.result.valid
            if ev.result.valid:
                _assert_matches(out, i, ev)
    # one arch row per candidate, packed by the JAX package
    packed = [ref_pack_arch_params(ref_archs[i % 3])
              for i in range(len(nests))]
    ap = ArchParams.from_numpy(np.stack([p.storage for p in packed]),
                               np.stack([p.compute for p in packed]),
                               packed[0].structure, device=CPU)
    bucket = bucket_for(template_of(nests[0]), tuple(wl.rank_bounds))
    from repro_torch.core.batched import lower_nests
    bounds, ids, order = lower_nests(bucket, nests, range(len(nests)))
    out = engine.bucketed_model(wl, bucket, check_capacity=False).evaluate(
        bounds, ids, arch_params=ap)
    for row, i in enumerate(order):
        ref = RefSparseloop(ref_design.__class__(
            arch=ref_archs[i % 3], safs=ref_design.safs))
        _assert_matches(out, row, ref.evaluate(ref_wl, ref_nests[i],
                                               check_capacity=False))


# ----------------------------------------------------------------------
# search dispatch and the device rule
# ----------------------------------------------------------------------
def test_mapper_search_batched_equals_reference_scalar_loop():
    ref_wl = ref_matmul(32, 32, 32, densities={"A": ("uniform", 0.3),
                                               "B": ("uniform", 0.3)})
    ref_design, design = _design("coordinate_list_design", buffer_kwords=8)
    perms = {0: ("n", "k", "m"), 1: ("m", "n")}
    want = ref_search(ref_design, ref_wl,
                      RefCons(budget=100, seed=3, permutations=perms),
                      use_batched=False)
    got = search(design, from_reference(ref_wl),
                 MapspaceConstraints(budget=100, seed=3, permutations=perms),
                 use_batched=True, device=CPU)
    assert got.best_nest == from_reference(want.best_nest)
    assert got.best.edp == pytest.approx(want.best.edp, rel=1e-9)
    assert (got.evaluated, got.valid) == (want.evaluated, want.valid)


def test_free_permutation_search_groups_by_bucket():
    ref_wl = ref_matmul(16, 16, 16, densities=DENS)
    ref_design, design = _design("coordinate_list_design", buffer_kwords=8)
    cons = dict(budget=96, seed=0, spatial={1: {"n": 4}})
    want = ref_search(ref_design, ref_wl, RefCons(**cons),
                      use_batched=False)
    with compile_stats.track() as st:
        got = search(design, from_reference(ref_wl),
                     MapspaceConstraints(**cons), use_batched=True,
                     device=CPU)
    assert st.scalar_evals == 0
    assert got.best_nest == from_reference(want.best_nest)
    assert got.best.edp == pytest.approx(want.best.edp, rel=1e-9)


def test_no_cuda_without_device_raises(monkeypatch):
    """Entry points default to the card and never fall back silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, design = _design("dense_design")
    wl = from_reference(ref_matmul(M, K, N, densities=DENS))
    nests = [SPMSPM.nest_with(b) for b in _bounds()[:4]]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Sparseloop(design).evaluate_batch(wl, nests)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        search(design, wl, MapspaceConstraints(
            budget=64, permutations={0: ("n", "k", "m"), 1: ("m", "n")}),
            use_batched=True)
    # the scalar oracle needs no device
    assert Sparseloop(design).evaluate(wl, nests[0]).cycles > 0


def test_stochastic_strategies_wait_for_the_search_port():
    _, design = _design("dense_design")
    wl = from_reference(ref_matmul(M, K, N, densities=DENS))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        search(design, wl, strategy="es", device=CPU)
