"""The port's search package (``repro_torch.search``) against the JAX
package's (``repro.search``), and the search contracts.

Parity, on fixed numpy genomes: the mapspace and co-search encodings
give the reference's layout and decodes exactly, and the
``PopulationEvaluator`` gives the reference's fitness within 1e-6
relative with ``valid`` equal, on the bucketed engine, the scalar route
and the per-template engine.  The reference runs in a subprocess
(``torch_reference.run_reference``: jax 0.9 needs an alias to import
``repro.search``).  The port runs on the CPU.

Contracts, on the port alone (its random stream is ``torch``'s, not
``jax.random``'s): same seed => identical ``to_json(timing=False)`` for
every strategy, monotone trajectories, winners re-validated by the
scalar oracle, the budget as a cap, the scalar route forced by
``use_batched=False``, callable objectives rejected with ``strategy=``,
actual-data density on the batched route, one program per
free-permutation run, the unported mesh route raising while the fused
and service routes run, the device rule and the hillclimb CLI."""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference as R  # noqa: E402
from repro_torch.core import Sparseloop, compile_stats, matmul  # noqa: E402
from repro_torch.core.batched import clear_caches  # noqa: E402
from repro_torch.core.mapper import (MapspaceConstraints,  # noqa: E402
                                     SearchResult, _validated_result,
                                     search)
from repro_torch.core.presets import (coordinate_list_design,  # noqa: E402
                                      two_level_arch)
from repro_torch.launch import hillclimb  # noqa: E402
from repro_torch.search import (STRATEGIES, MapspaceEncoding,  # noqa: E402
                                SearchConfig, SearchLog, crossover,
                                mutate, prime_factors,
                                run_search, validate_search_env)

CPU = "cpu"
POP = 16
CASES = R.search_cases("repro_torch")


def _inputs() -> dict:
    out = {}
    for i, (name, (_, _, enc)) in enumerate(CASES.items()):
        out[name + ".wild"], out[name + ".pop"] = R.genomes_for(enc, POP,
                                                                seed=i)
    return out


INPUTS = _inputs()

reference = R.reference_fixture("""
    import torch_reference as R
    for name, (design, wl, enc) in R.search_cases("repro").items():
        wild, pop = IN[name + ".wild"], IN[name + ".pop"]
        for k, v in R.encoding_outputs(enc, wild, pop).items():
            OUT[f"{name}.enc.{k}"] = v
        for route, cfg in R.fitness_routes(name).items():
            res = R.fitness_outputs("repro", design, wl, enc, pop, **cfg)
            for k, v in res.items():
                OUT[f"{name}.{route}.{k}"] = v
""", INPUTS)


def _want(reference, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


WL = CASES["free"][1]
DESIGN = CASES["free"][0]
CONS = MapspaceConstraints(budget=96, seed=0, spatial={1: {"n": 4}})


# ----------------------------------------------------------------------
# parity with the JAX package on fixed genomes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_encoding_matches_reference(reference, name):
    _, _, enc = CASES[name]
    got = R.encoding_outputs(enc, INPUTS[name + ".wild"],
                             INPUTS[name + ".pop"])
    want = _want(reference, f"{name}.enc.")
    assert set(got) == set(want)
    R.assert_same(got, want, prefix=f"{name}: ")


@pytest.mark.parametrize("name,route", [
    (name, route) for name in CASES for route in R.fitness_routes(name)])
def test_population_fitness_matches_reference(reference, name, route):
    design, wl, enc = CASES[name]
    got = R.fitness_outputs("repro_torch", design, wl, enc,
                            INPUTS[name + ".pop"],
                            **R.fitness_routes(name)[route])
    want = _want(reference, f"{name}.{route}.")
    R.assert_fitness_close(got, want, rel=1e-6)
    assert want["valid"].any()


# ----------------------------------------------------------------------
# encoding contracts
# ----------------------------------------------------------------------
def test_prime_factors():
    assert prime_factors(1) == []
    assert prime_factors(2) == [2]
    assert prime_factors(12) == [3, 2, 2]
    assert prime_factors(49) == [7, 7]
    assert np.prod(prime_factors(3136)) == 3136


@pytest.mark.parametrize("cons", [
    CONS,
    MapspaceConstraints(budget=96, seed=0),                 # no spatial
    MapspaceConstraints(budget=96, seed=0, spatial={1: {"n": 4}},
                        permutations={0: ("n", "k", "m"),
                                      1: ("m", "n")}),      # pinned order
])
def test_random_genomes_decode_to_valid_nests(cons):
    enc = MapspaceEncoding(WL, 2, cons)
    for pop in (enc.random_population(0, 32),
                enc.structured_population(torch.Generator().manual_seed(1),
                                          32)):
        assert pop.shape == (32, enc.genome_size)
        assert ((pop >= 0) & (pop < enc.cardinality)).all()
        for g in pop:
            enc.nest_of(g).validate(WL)     # raises on an invalid mapping


def test_draws_follow_the_generator():
    """An int key and a generator seeded with it draw the same genomes;
    a shared generator advances between draws."""
    enc = MapspaceEncoding(WL, 2, CONS)
    gen = torch.Generator().manual_seed(7)
    first = enc.random_population(gen, 8)
    np.testing.assert_array_equal(first, enc.random_population(7, 8))
    assert (enc.random_population(gen, 8) != first).any()
    with pytest.raises(TypeError, match="torch.Generator"):
        enc.random_population(np.random.default_rng(0), 8)


def test_crossover_swaps_whole_factor_blocks():
    enc = MapspaceEncoding(WL, 2, CONS)
    pa = np.zeros((8, enc.genome_size), np.int64)
    pb = enc.repair(np.ones((8, enc.genome_size), np.int64))
    child = crossover(2, pa, pb, enc)
    for row in child:
        for blk in range(enc.num_blocks):
            sel = enc.gene_block == blk
            assert (row[sel] == pa[0][sel]).all() or \
                   (row[sel] == pb[0][sel]).all()


def test_mutation_always_changes_a_gene():
    enc = MapspaceEncoding(WL, 2, CONS)
    pop = enc.random_population(3, 16)
    out = mutate(4, pop, enc, rate=0.0)
    assert out.shape == pop.shape
    # rate=0 still resamples exactly one forced gene per genome
    assert ((out != pop).sum(axis=1) <= 1).all()
    assert (out != pop).any()
    assert ((out >= 0) & (out < enc.cardinality)).all()


# ----------------------------------------------------------------------
# run contracts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_same_seed_same_searchlog(strategy):
    r1 = run_search(DESIGN, WL, CONS, strategy=strategy, key=11,
                    device=CPU)
    r2 = run_search(DESIGN, WL, CONS, strategy=strategy, key=11,
                    device=CPU)
    # byte-reproducibility is stated on the timing-stripped form: the
    # wall-clock fields measure the machine, not the search
    assert r1.log.to_json(timing=False) == r2.log.to_json(timing=False)
    assert r1.best_nest == r2.best_nest
    assert (r1.evaluated, r1.valid) == (r2.evaluated, r2.valid)
    assert all(r.wall_time_s > 0 for r in r1.log.records)
    assert r1.log.timing["wall_s"] > 0
    # a generator seeded alike is the same run (its log has no seed)
    r4 = run_search(DESIGN, WL, CONS, strategy=strategy,
                    key=torch.Generator().manual_seed(11), device=CPU)
    assert r4.log.seed is None
    assert r4.log.to_dict(timing=False)["records"] == \
        r1.log.to_dict(timing=False)["records"]
    # a different seed takes another trajectory
    r3 = run_search(DESIGN, WL, CONS, strategy=strategy, key=12,
                    device=CPU)
    assert r3.log.to_json(timing=False) != r1.log.to_json(timing=False)


def test_trajectory_monotone_and_serializable():
    res = run_search(DESIGN, WL, CONS, strategy="es", key=0, device=CPU)
    traj = res.log.trajectory("best_edp")
    assert len(traj) == len(res.log.records) >= 1
    assert all(a >= b for a, b in zip(traj, traj[1:]))
    roundtrip = SearchLog.from_json(res.log.to_json())
    assert roundtrip.to_json() == res.log.to_json()
    assert res.log.evaluations == res.evaluated


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_winner_is_oracle_validated(strategy):
    res = run_search(DESIGN, WL, CONS, strategy=strategy, key=0,
                     device=CPU)
    assert res.best is not None and res.best.result.valid
    res.best_nest.validate(WL)
    again = Sparseloop(DESIGN).evaluate(WL, res.best_nest)
    assert again.result.valid and again.edp == res.best.edp
    # the scalar oracle agrees with the fitness the search tracked
    assert res.best.edp == pytest.approx(res.log.best_fitness, rel=1e-6)


def test_mapper_search_strategy_dispatch():
    res = search(DESIGN, WL, CONS, strategy="es", key=5, device=CPU)
    assert isinstance(res, SearchResult)
    assert res.log is not None and res.log.strategy == "es"
    assert 0 < res.evaluated <= CONS.budget
    assert res.best.result.valid
    # default path unchanged: no log
    assert search(DESIGN, WL, CONS, device=CPU).log is None


def test_budget_caps_strategy_evaluations():
    """cons.budget is a hard cap even when it is below pop_size."""
    res = run_search(DESIGN, WL, MapspaceConstraints(budget=8, seed=0),
                     strategy="es", key=0, device=CPU)  # pop 32 > 8
    assert 0 < res.evaluated <= 8
    res = run_search(DESIGN, WL, MapspaceConstraints(budget=100, seed=0),
                     strategy="hillclimb", key=0, pop_size=32, device=CPU)
    assert res.evaluated == 96


def test_use_batched_false_forces_scalar_dispatch_with_strategy():
    cons = MapspaceConstraints(budget=64, seed=0,
                               permutations={0: ("n", "k", "m"),
                                             1: ("m", "n")})
    with compile_stats.track() as st:
        r_scalar = search(DESIGN, WL, cons, strategy="es", key=9,
                          use_batched=False, pop_size=64, device=CPU)
    assert st.scalar_evals == 64 and st.batched_evals == 0
    with compile_stats.track() as st:
        r_auto = search(DESIGN, WL, cons, strategy="es", key=9,
                        pop_size=64, device=CPU)
    assert st.scalar_evals == 0 and st.batched_evals == 64
    # same seed => same candidates; scalar vs batched agree to round-off
    assert r_scalar.best_nest == r_auto.best_nest
    assert r_scalar.best.edp == pytest.approx(r_auto.best.edp, rel=1e-6)


def test_mapper_search_strategy_rejects_callable_objective():
    with pytest.raises(ValueError, match="metric name"):
        search(DESIGN, WL, CONS, objective=lambda ev: ev.cycles,
               strategy="es", device=CPU)
    with pytest.raises(TypeError):
        search(DESIGN, WL, CONS, key=3, device=CPU)  # kwargs w/o strategy
    with pytest.raises(ValueError, match="unknown strategy"):
        search(DESIGN, WL, CONS, strategy="gradient-descent", device=CPU)
    with pytest.raises(ValueError, match="metric"):
        run_search(DESIGN, WL, CONS, metric="watts", device=CPU)


def test_strategy_search_actual_density_rides_batched_engine():
    """Actual-data density lowers to a tile-occupancy histogram and
    rides the bucketed engine: zero scalar-path evaluations."""
    design, wl, _ = CASES["actual"]
    with compile_stats.track() as st:
        res = run_search(design, wl, MapspaceConstraints(budget=32, seed=0),
                         strategy="es", key=0, pop_size=16,
                         batch_threshold=1, device=CPU)
    assert res.best is not None and res.best.result.valid
    res.best_nest.validate(wl)
    assert st.scalar_evals == 0, st.as_dict()
    assert st.batched_evals >= 32


@pytest.mark.parametrize("strategy", ["es", "annealing"])
def test_free_permutation_run_is_one_program(strategy):
    """Every generation of a free-permutation run, whatever its loop
    orders, goes through one bucket program."""
    clear_caches()
    with compile_stats.track() as st:
        res = run_search(DESIGN, WL, CONS, strategy=strategy, key=1,
                         device=CPU)
    assert res.log.records and res.best is not None
    assert st.programs == 1 and st.scalar_evals == 0, st.as_dict()
    assert st.batched_evals == res.evaluated


def test_validated_result_skips_oracle_rejected_candidates():
    rejected = []

    class StubModel:
        def evaluate(self, workload, nest, check_capacity=True):
            ok = nest != "bad"
            if not ok:
                rejected.append(nest)
            return SimpleNamespace(result=SimpleNamespace(valid=ok),
                                   edp=1.0, cycles=1.0, energy_pj=1.0)

    nests = ["bad", "good", "better-but-invalid-flag"]
    res = _validated_result(StubModel(), WL, lambda i: nests[i],
                            edp=np.asarray([1.0, 2.0, 3.0]),
                            valid=np.asarray([True, True, False]), n_eval=7)
    assert res.best_nest == "good" and res.evaluated == 7
    assert res.valid == 1 and rejected == ["bad"]


# ----------------------------------------------------------------------
# the fused and service routes run; the environment is validated
# ----------------------------------------------------------------------
def test_unported_routes_raise(monkeypatch):
    """No route raises any more: ``fused=True``, ``REPRO_SEARCH_FUSED=1``
    and ``service=`` run, the fused runs byte-identical from one seed
    (the sharded route is held by ``test_torch_popmesh.py``)."""
    from repro_torch.dse import EvaluationService
    fused = [run_search(DESIGN, WL, CONS, fused=True, device=CPU)
             for _ in range(2)]
    assert fused[0].log.timing["fused"] is True
    assert fused[0].log.to_json(timing=False) == \
        fused[1].log.to_json(timing=False)
    via_mapper = search(DESIGN, WL, CONS, strategy="es", fused=True,
                        device=CPU)
    assert via_mapper.log.to_json(timing=False) == \
        fused[0].log.to_json(timing=False)
    with EvaluationService() as svc:
        served = run_search(DESIGN, WL, CONS, service=svc.client("s"),
                            batch_threshold=1, device=CPU)
        assert svc.stats()["requests"] == len(served.log.records)
    assert served.log.to_json(timing=False) == run_search(
        DESIGN, WL, CONS, batch_threshold=1,
        device=CPU).log.to_json(timing=False)
    monkeypatch.setenv("REPRO_SEARCH_FUSED", "1")
    env = run_search(DESIGN, WL, CONS, device=CPU)
    assert env.log.to_json(timing=False) == \
        fused[0].log.to_json(timing=False)
    # an explicit fused=False overrides the environment
    host = run_search(DESIGN, WL, CONS, fused=False, device=CPU)
    assert host.best and "fused" not in host.log.timing


def test_search_env_is_validated(monkeypatch):
    monkeypatch.setenv("REPRO_SEARCH_BATCH_THRESHOLD", "many")
    with pytest.raises(ValueError, match="must be an integer"):
        SearchConfig()
    monkeypatch.setenv("REPRO_SEARCH_BATCH_THRESHOLD", "4")
    monkeypatch.setenv("REPRO_SEARCH_BUCKETED", "perhaps")
    with pytest.warns(UserWarning, match="not a recognized boolean"):
        cfg = SearchConfig()
    assert cfg.batch_threshold == 4 and cfg.bucketed is True
    monkeypatch.delenv("REPRO_SEARCH_BUCKETED")
    monkeypatch.setenv("REPRO_SEARCH_BATCH_TRESHOLD", "4")
    with pytest.warns(UserWarning, match="unknown environment variable"):
        msgs = validate_search_env()
    assert msgs and "REPRO_SEARCH_BATCH_TRESHOLD" in msgs[0]
    monkeypatch.delenv("REPRO_SEARCH_BATCH_TRESHOLD")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert SearchConfig(bucketed=False).bucketed is False


@pytest.mark.parametrize("name", ["REPRO_SEARCH_FUSED_CHUNK",
                                  "REPRO_SEARCH_DEVICES"])
def test_settings_that_configure_nothing_here_warn(monkeypatch, name):
    """Both settings configure something in the port and are accepted
    silently: ``REPRO_SEARCH_FUSED_CHUNK`` sets the fused search's
    chunk, ``REPRO_SEARCH_DEVICES`` the simulated shard count of
    ``population_mesh`` (the JAX package's forced host devices); a
    malformed value raises."""
    from repro_torch.search import population_mesh
    monkeypatch.setenv(name, "8")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        cfg = SearchConfig()
    if name == "REPRO_SEARCH_FUSED_CHUNK":
        assert cfg.fused_chunk == 8
    else:
        assert cfg.fused_chunk == 16
        mesh = population_mesh(device=CPU)
        assert mesh.size == 8 and mesh.simulated
    monkeypatch.setenv(name, "eight")
    with pytest.raises(ValueError, match="must be an integer"):
        SearchConfig() if name == "REPRO_SEARCH_FUSED_CHUNK" \
            else population_mesh(device=CPU)


def test_entry_points_need_cuda_or_cpu(monkeypatch):
    """run_search, mapper.search(strategy=) and the CLI default to the
    card and raise without it; the CPU only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_search(DESIGN, WL, CONS)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        search(DESIGN, WL, CONS, strategy="es", use_batched=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        hillclimb.main(["--mkn", "16", "16", "16", "--budget", "16"])


def test_hillclimb_cli_writes_its_log(tmp_path, capsys):
    out = tmp_path / "log.json"
    res = hillclimb.main(["--device", "cpu", "--design", "coordlist",
                          "--mkn", "64", "64", "64", "--densities", "0.3",
                          "0.5", "--strategy", "es", "--budget", "64",
                          "--pop", "16", "--seed", "3", "--out", str(out)])
    log = SearchLog.load(str(out))
    assert log.strategy == "es" and log.seed == 3
    assert log.to_json(timing=False) == res.log.to_json(timing=False)
    assert len(log.records) == 4 and log.evaluations == 64
    text = capsys.readouterr().out
    assert "device=cpu" in text and f"wrote {out}" in text
    again = Sparseloop(coordinate_list_design(two_level_arch())).evaluate(
        matmul(64, 64, 64, densities={"A": ("uniform", 0.3),
                                      "B": ("uniform", 0.5)}),
        res.best_nest)
    assert again.edp == res.best.edp
