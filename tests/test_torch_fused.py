"""The port's device-resident fused search (``repro_torch.search.fused``)
against the JAX package's (``repro.search.fused``) and its contracts.

Parity, on fixed numpy genomes: the device decode equals the port's
host ``decode_bucketed`` and the reference's ``FusedProgram._decode_map``
exactly.  The random streams differ (counter hashes against
``jax.random``), so each random step of the fused ``_ask`` —
tournament, crossover, mutation, immigrants — is held to the
reference's distributions at ``DRAWS`` draws by chi-square
(Bonferroni, ``ALPHA``, as ``tests/test_torch_strategies.py``): against
the reference's draws of the same step and, for one whole generation,
against the reference's own fused ``_ask``.  Hybrid ES+SGD over fused
pure ES is held to the reference's ratios over seeds 0-19 (two-sample
KS at ``KS_ALPHA``), not at one key.

Contracts, on the port alone (the JAX package's ``tests/test_fused.py``
and ``tests/test_topology.py``): same seed => identical
``to_json(timing=False)``; chunk-invariant; zero scalar evaluations and
one fused program per shape; ``wall_time_s`` None per generation, the
chunks summing to the records; the winner confirmed by the scalar
oracle; ineligible runs warn and equal the host run; the device top-K
archive equal to the host fold.  The reference runs in a subprocess
(``torch_reference.run_reference``).  The port runs on the CPU, where
the step runs eagerly; the ``gpu`` cases run it as a captured graph.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
stats = pytest.importorskip("scipy.stats")

import torch_reference as R  # noqa: E402
from repro_torch.core import Sparseloop, compile_stats  # noqa: E402
from repro_torch.core.arch import pack_arch_params  # noqa: E402
from repro_torch.core.batched import clear_caches  # noqa: E402
from repro_torch.core.mapper import MapspaceConstraints  # noqa: E402
from repro_torch.core.presets import (coordinate_list_design,  # noqa: E402
                                      two_level_arch)
from repro_torch.search import (CoSearchEncoding, DesignSpace,  # noqa: E402
                                MapspaceEncoding, SearchConfig, SearchLog,
                                fused_supported, get_fused_program,
                                make_strategy, run_search)
from repro_torch.search import fused as F  # noqa: E402

CPU = "cpu"
CASES = R.search_cases("repro_torch")
DECODE_CASES = ("free", "no_spatial", "pinned", "conv2_x", "cosearch")
DESIGN, WL = CASES["free"][0], CASES["free"][1]
CONS = MapspaceConstraints(budget=96, seed=0, spatial={1: {"n": 4}})
#: draws of each random step, and the mutation rate they are taken at
DRAWS, RATE = R.DRAWS, 0.15
KS_ALPHA = 0.01
ASK_SEED = 5


def _inputs() -> dict:
    out = {}
    for i, name in enumerate(DECODE_CASES):
        out[name + ".pop"] = R.genomes_for(CASES[name][2], 16,
                                           seed=40 + i)[1]
    enc = CASES["conv2_x"][2]
    parents = enc.repair(R.genomes_for(enc, len(R.SELECT_FITNESS),
                                       seed=1)[1])
    out["ask.pop"] = np.tile(parents, (DRAWS // len(parents), 1))
    out["ask.fit"] = np.tile(R.SELECT_FITNESS, DRAWS // len(parents))
    return out


INPUTS = _inputs()

reference = R.reference_fixture(f"""
    import jax, jax.numpy as jnp
    import torch_reference as R
    from repro.core import Sparseloop
    from repro.search import EvolutionStrategy, get_fused_program
    for name in {DECODE_CASES!r}:
        design, wl, enc = R.search_cases("repro")[name]
        pop = IN[name + ".pop"]
        bucket, _, _ = enc.decode_bucketed(pop)
        fp = get_fused_program(Sparseloop(design).bucketed_model(
            wl, bucket), enc, EvolutionStrategy())
        with jax.enable_x64():
            rows = [fp._decode_map(jnp.asarray(g, jnp.int32)) for g in pop]
        OUT[name + ".bounds"] = np.stack([np.asarray(b) for b, _ in rows])
        OUT[name + ".ids"] = np.stack([np.asarray(i) for _, i in rows])
    design, wl, enc = R.search_cases("repro")["conv2_x"]
    bm = Sparseloop(design).bucketed_model(wl, enc.bucket)
    fp = get_fused_program(bm, enc, EvolutionStrategy(pop_size={DRAWS}))
    with jax.enable_x64():
        OUT["ask"] = np.asarray(fp._ask(
            jax.random.PRNGKey({ASK_SEED}),
            jnp.asarray(IN["ask.pop"], jnp.int32),
            jnp.asarray(IN["ask.fit"], jnp.float64)))
    OUT.update({{"draws." + k: v for k, v in
                R.strategy_draws("repro", jax.random.PRNGKey).items()}})
    OUT.update({{"hybrid." + k: v for k, v in
                R.hybrid_ratios("repro").items()}})
""", INPUTS)


def _key(seed: int, gen: int = 0):
    return torch.as_tensor([seed & F._M32, seed >> 32, gen])


# ----------------------------------------------------------------------
# eligibility and the device decode
# ----------------------------------------------------------------------
def test_fused_supported():
    enc = MapspaceEncoding(WL, 2, CONS)
    assert fused_supported(enc)
    assert fused_supported(CASES["cosearch"][2])
    static = DesignSpace(extra_steps={("Buffer", "word_bits"):
                                      (8.0, 16.0)})
    assert not fused_supported(
        CoSearchEncoding(WL, 2, CONS, static, DESIGN))
    assert not fused_supported(
        R.topology_cases("repro_torch")["topology"][1])
    with pytest.raises(ValueError, match="device decode"):
        F.FusedProgram(Sparseloop(DESIGN, device=CPU).bucketed_model(
            WL, enc.bucket), CoSearchEncoding(WL, 2, CONS, static, DESIGN),
            make_strategy("es"))


@pytest.mark.parametrize("name", DECODE_CASES)
def test_device_decode_matches_host_and_reference(reference, name):
    design, wl, enc = CASES[name]
    pop = INPUTS[name + ".pop"]
    bucket, bounds, ids = enc.decode_bucketed(pop)
    fp = get_fused_program(Sparseloop(design, device=CPU).bucketed_model(
        wl, bucket), enc, make_strategy("es"))
    b, i = fp._decode_map(torch.as_tensor(pop))
    assert b.dtype == torch.float64
    np.testing.assert_array_equal(b.numpy(), bounds)
    np.testing.assert_array_equal(i.numpy(), ids)
    np.testing.assert_array_equal(b.numpy(), reference[name + ".bounds"])
    np.testing.assert_array_equal(i.numpy(), reference[name + ".ids"])


# ----------------------------------------------------------------------
# fused runs: determinism, accounting, the oracle-validated winner
# ----------------------------------------------------------------------
def test_fused_run_deterministic_and_validated():
    clear_caches()
    with compile_stats.track() as st:
        runs = [run_search(DESIGN, WL, CONS, strategy="es", key=5,
                           fused=True, device=CPU) for _ in range(2)]
    a, b = runs
    assert a.log.to_json(timing=False) == b.log.to_json(timing=False)
    # zero scalar evaluations, one fused program (one shape) for both
    assert st.scalar_evals == 0
    assert st.compiles_by_kind.get("fused", 0) == 1
    assert all(r.wall_time_s is None for r in a.log.records)
    assert a.log.timing["fused"] is True
    assert sum(c["generations"] for c in a.log.timing["chunks"]) == \
        len(a.log.records)
    assert a.best is not None and a.best.result.valid
    oracle = Sparseloop(DESIGN).evaluate(WL, a.best_nest)
    assert a.best.edp == pytest.approx(oracle.edp, rel=1e-9)
    assert a.log.evaluations == len(a.log.records) * 32
    traj = a.log.trajectory("best_edp")
    assert all(x >= y for x, y in zip(traj, traj[1:]))


def test_fused_chunking_invariant():
    """Chunk boundaries are a dispatch artifact: the draws are keyed by
    (seed, generation), so the trajectory is the same whatever
    ``fused_chunk`` says."""
    logs = [run_search(DESIGN, WL, CONS, strategy="es", key=5, fused=True,
                       config=SearchConfig(fused_chunk=chunk),
                       device=CPU).log for chunk in (2, 100)]
    assert logs[0].to_json(timing=False) == logs[1].to_json(timing=False)
    assert [c["generations"] for c in logs[0].timing["chunks"]] == [2, 1]


def test_fused_fallback_warns_and_matches_host():
    """A non-ES strategy is not fused-eligible: explicit fused=True
    warns and the run is byte-identical to the plain host run."""
    with pytest.warns(UserWarning, match="not fused-eligible"):
        fell_back = run_search(DESIGN, WL, CONS, strategy="hillclimb",
                               key=3, fused=True, device=CPU)
    host = run_search(DESIGN, WL, CONS, strategy="hillclimb", key=3,
                      device=CPU)
    assert fell_back.log.to_json(timing=False) == \
        host.log.to_json(timing=False)
    assert "fused" not in fell_back.log.timing


def test_device_archive_matches_host_fold():
    """The device top-K archive against the host fold of the
    full-population outputs of the same trajectory (two chunks: the
    buffer is cumulative)."""
    enc = MapspaceEncoding(WL, 2, CONS)
    bm = Sparseloop(DESIGN, device=CPU).bucketed_model(WL, enc.bucket)
    strat = make_strategy("es")
    K = 32
    states = {}
    for k in (0, K):
        fp = get_fused_program(bm, enc, strat, archive_k=k)
        absorber = F.ChunkAbsorber("edp", K, pop_size=strat.pop_size)
        log = SearchLog(strategy="es", metric="edp")
        carry = fp.init_carry(7)
        for chunk in (3, 3):
            carry, ys = fp.invoke_chunk(carry, chunk)
            absorber.absorb(ys, log)
        states[k] = (absorber, log)
    host, device = states[0][0], states[K][0]
    assert states[0][1].to_json(timing=False) == \
        states[K][1].to_json(timing=False)
    assert host.best == device.best
    assert (host.n_eval, host.n_valid) == (device.n_eval, device.n_valid)
    hi = int(np.argmin(host.archive_fit))
    di = int(np.argmin(device.archive_fit))
    assert host.archive_fit[hi] == device.archive_fit[di]
    np.testing.assert_array_equal(host.archive_gen[hi],
                                  device.archive_gen[di])
    host_map = {g.tobytes(): f for f, g in zip(host.archive_fit,
                                               host.archive_gen)}
    for f, g in zip(device.archive_fit, device.archive_gen):
        assert host_map.get(g.tobytes()) == f
    # the device buffer holds the global best distinct rows: the host's
    # best K distinct fitnesses, in order
    want = sorted(host.archive_fit)[:len(device.archive_fit)]
    assert sorted(device.archive_fit) == want


def test_programs_follow_their_facade():
    """Two designs of one topology share the bucket program and so one
    fused program; each run still evaluates under its own design's
    scalars (copied in at every chunk), as a run from clean caches
    does.  The JAX package keeps the first design's rows here (its
    ``FusedProgram`` reads ``_base_params`` bound at construction), so
    its second run logs the first design's EDPs; ROADMAP Queue 3."""
    other = coordinate_list_design(two_level_arch(buffer_kwords=8, pes=16,
                                                 dram_bw=2))
    clear_caches()
    alone = run_search(other, WL, CONS, strategy="es", key=2, fused=True,
                       device=CPU).log.to_json(timing=False)
    clear_caches()
    run_search(DESIGN, WL, CONS, strategy="es", key=2, fused=True,
               device=CPU)
    with compile_stats.track() as st:
        shared = run_search(other, WL, CONS, strategy="es", key=2,
                            fused=True, device=CPU)
    assert st.compiles_by_kind.get("fused", 0) == 0      # program shared
    assert shared.log.to_json(timing=False) == alone
    # binding the second design left the first design's facade alone
    bm = Sparseloop(DESIGN, device=CPU).bucketed_model(
        WL, MapspaceEncoding(WL, 2, CONS).bucket)
    np.testing.assert_array_equal(
        bm.arch_params.storage, pack_arch_params(DESIGN.arch).storage)


def test_inject_folds_migrants_as_tell():
    enc = MapspaceEncoding(WL, 2, CONS)
    bm = Sparseloop(DESIGN, device=CPU).bucketed_model(WL, enc.bucket)
    fp = get_fused_program(bm, enc, make_strategy("es"))
    carry, ys = fp.invoke_chunk(fp.init_carry(3), 2)
    g, f = ys["genomes"][-1][:2], np.asarray([0.0, np.inf])
    key, pop, fit, pending = fp.inject(carry, g, f)
    assert fit[0] == 0.0 and torch.equal(pop[0], torch.as_tensor(g[0]))
    assert torch.equal(pending, carry[3]) and key is carry[0]
    want = np.sort(np.concatenate([carry[2].numpy(), f]),
                   kind="stable")[:len(fit)]
    np.testing.assert_array_equal(fit.numpy(), want)


# ----------------------------------------------------------------------
# the random steps, against the reference's distributions
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def ask_program():
    design, wl, enc = CASES["conv2_x"]
    bm = Sparseloop(design, device=CPU).bucketed_model(wl, enc.bucket)
    return get_fused_program(bm, enc, make_strategy(
        "es", pop_size=DRAWS, mutation_rate=RATE))


def test_fused_tournament_as_the_reference(reference, ask_program):
    """A 3-way tournament over 32 distinct fitness values picks rank r
    w.p. ((32 - r) / 32)^3 - ((31 - r) / 32)^3."""
    got = ask_program._select(
        _key(11), F._TOURNAMENT_A,
        torch.as_tensor(R.SELECT_FITNESS), DRAWS).numpy()
    want = reference["draws.select"]
    n = len(R.SELECT_FITNESS)
    rank = np.argsort(np.argsort(R.SELECT_FITNESS))
    r = np.arange(n)
    law = (((n - r) / n) ** 3 - ((n - r - 1) / n) ** 3)[rank]
    R.assert_all([R.homogeneity(got, want), R.fit_law(got, law)],
                 "fused tournament")


def test_fused_crossover_as_the_reference(reference, ask_program):
    base = reference["draws.base"]
    card = reference["draws.cardinality"]
    other = (base + 1) % card
    got = ask_program._crossover(
        _key(12), torch.as_tensor(np.tile(base, (DRAWS, 1))),
        torch.as_tensor(np.tile(other, (DRAWS, 1)))).numpy()
    want = reference["draws.crossover"]
    live = card > 1
    block = reference["draws.gene_block"]
    picks = {}
    for name, g in (("port", got), ("reference", want)):
        from_a = g == base
        pick = np.stack([from_a[:, live & (block == b)].all(axis=1)
                         for b in sorted(set(block[live]))], axis=1)
        whole = np.stack([(~from_a[:, live & (block == b)]).all(axis=1)
                          for b in sorted(set(block[live]))], axis=1)
        assert (pick | whole).all(), f"{name}: a block was split"
        picks[name] = pick.astype(int)
    R.assert_all([R.fit_law(picks["port"][:, j], [0.5, 0.5])
                  for j in range(picks["port"].shape[1])],
                 "fused crossover vs 1/2")
    R.same_columns(picks["port"], picks["reference"],
                   "fused crossover vs the reference")


def test_fused_mutation_as_the_reference(reference, ask_program):
    base = reference["draws.base"]
    card = reference["draws.cardinality"]
    got = ask_program._mutate(
        _key(13), torch.as_tensor(np.tile(base, (DRAWS, 1)))).numpy()
    R.same_columns(got, reference["draws.mutate"],
                   "fused mutation vs the reference")
    q = 1 - (1 - RATE) * (1 - 1 / len(card))
    law = [np.full(c, q / c) + (1 - q) * (np.arange(c) == b)
           for c, b in zip(card, base)]
    R.assert_all([R.fit_law(got[:, j], law[j]) for j in range(len(card))],
                 "fused mutation vs its law")


def test_fused_immigrants_as_the_reference(reference, ask_program):
    card = reference["draws.conv2_x.cardinality"]
    got = ask_program._randint(_key(14), F._IMMIGRANT,
                               (DRAWS, len(card)),
                               ask_program._card).numpy()
    R.same_columns(got, reference["draws.conv2_x.random"],
                   "fused immigrants vs the reference")
    R.assert_all([R.fit_law(got[:, j], np.full(c, 1 / c))
                  for j, c in enumerate(card)], "fused immigrants vs uniform")


def test_fused_generation_as_the_reference(reference, ask_program):
    """One whole fused ``_ask`` (selection from 32 fitness groups,
    crossover at 0.6, mutation, a quarter immigrants) against the
    reference's fused ``_ask`` on the same parents, gene by gene."""
    got = ask_program._ask(_key(ASK_SEED),
                           torch.as_tensor(INPUTS["ask.pop"]),
                           torch.as_tensor(INPUTS["ask.fit"])).numpy()
    want = reference["ask"]
    n_imm = ask_program.n_immigrants
    assert got.shape == want.shape == INPUTS["ask.pop"].shape
    R.same_columns(got[:-n_imm], want[:-n_imm], "fused children")
    R.same_columns(got[-n_imm:], want[-n_imm:], "fused immigrants")


def test_draws_depend_on_seed_and_generation_only(ask_program):
    u = ask_program._uniform(_key(9, 4), F._FLIP, (64,))
    assert torch.equal(u, ask_program._uniform(_key(9, 4), F._FLIP, (64,)))
    for other in (_key(9, 5), _key(10, 4), _key(9 + (1 << 32), 4)):
        assert not torch.equal(u, ask_program._uniform(other, F._FLIP,
                                                       (64,)))
    assert not torch.equal(u, ask_program._uniform(_key(9, 4), F._FRESH,
                                                   (64,)))
    assert ((u >= 0) & (u < 1)).all() and u.dtype == torch.float64


# ----------------------------------------------------------------------
# hybrid ES+SGD
# ----------------------------------------------------------------------
def test_fused_cosearch_with_hybrid_sgd():
    """Co-search through the fused path with the Lamarckian SGD nudge
    on: deterministic and oracle-validated under the winner's own
    design (no single-key bar on hybrid against pure)."""
    space = DesignSpace(
        capacity_steps={"Buffer": (2 * 1024, 8 * 1024, 64 * 1024)},
        extra_steps={("Buffer", "read_energy_pj"): (3.0, 6.0, 12.0)},
        compute_steps={"mac_energy_pj": (0.5, 1.0, 2.0)})
    kw = dict(strategy="es", key=9, design_space=space, fused=True,
              device=CPU)
    a, b = (run_search(DESIGN, WL, CONS, sgd_lr=0.5, **kw)
            for _ in range(2))
    assert a.log.to_json(timing=False) == b.log.to_json(timing=False)
    assert a.best_design is not None and a.best.result.valid
    oracle = Sparseloop(a.best_design).evaluate(WL, a.best_nest)
    assert a.best.edp == pytest.approx(oracle.edp, rel=1e-9)


@pytest.fixture(scope="module")
def port_hybrid():
    return R.hybrid_ratios("repro_torch")


def test_hybrid_over_seeds_as_the_reference(reference, port_hybrid):
    """``bench_fused``'s hybrid cell: hybrid / pure at seeds 0-19 is
    drawn from the reference's distribution (two-sample KS)."""
    got = np.asarray(port_hybrid["ratios"])
    want = np.asarray(reference["hybrid.ratios"])
    assert len(got) == len(want) == R.SEEDS
    assert np.isfinite(got).all() and (got > 0).all()
    p = stats.ks_2samp(got, want).pvalue
    assert p >= KS_ALPHA, (f"KS p = {p:.3g}; port median "
                           f"{np.median(got):.4f}, reference "
                           f"{np.median(want):.4f}")


def test_card_hybrid_bar_is_the_reference_as_recorded(reference):
    """``chip_smoke.py`` holds the card's hybrid ratios to the JAX
    package's; the card runs no JAX, so it carries them as a constant,
    which must be what the reference computes."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_constants", os.path.join(R.ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.FUSED_POP, smoke.HYBRID_GENS, smoke.HYBRID_LR) == (
        R.HYBRID_POP, R.HYBRID_GENERATIONS, R.HYBRID_LR)
    assert smoke.SEARCH_SEEDS == tuple(range(R.SEEDS))
    assert list(smoke.REFERENCE_HYBRID_RATIOS) == pytest.approx(
        list(reference["hybrid.ratios"]), rel=1e-12)


# ----------------------------------------------------------------------
# on the card: one captured graph per program
# ----------------------------------------------------------------------
@pytest.mark.gpu
def test_cuda_fused_run_is_one_graph_and_the_cpu_trajectory():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    clear_caches()
    before = F.graph_captures()
    runs = [run_search(DESIGN, WL, CONS, strategy="es", key=5, fused=True,
                       config=SearchConfig(fused_chunk=2), device="cuda")
            for _ in range(2)]
    assert F.graph_captures() - before == 1
    assert runs[0].log.to_json(timing=False) == \
        runs[1].log.to_json(timing=False)
    # the same draws as the CPU's; the engine's float64 values agree to
    # the card's ulps (~1e-8), within the batched parity bound
    cpu = run_search(DESIGN, WL, CONS, strategy="es", key=5, fused=True,
                     device=CPU)
    for a, b in zip(runs[0].log.records, cpu.log.records, strict=True):
        assert (a.evaluations, a.valid) == (b.evaluations, b.valid)
        for k in ("best_fitness", "best_cycles", "best_energy_pj",
                  "best_edp"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-6)
    assert runs[0].best.edp == cpu.best.edp
