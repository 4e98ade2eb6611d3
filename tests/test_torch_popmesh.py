"""Population sharding of the port's mapspace engine
(``BatchedModel.evaluate(..., mesh=)``, ``BucketedModel.evaluate(...,
mesh=)``, ``search.population_mesh``, ``run_search(mesh=)``,
``EvaluationService(mesh=)`` and the hillclimb CLI's
``REPRO_SEARCH_DEVICES``), held to the JAX package's sharded engine and
to the port's own unsharded engine.

* The JAX package runs in one subprocess per file with 8 forced host
  devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``) and
  evaluates 1,001-candidate populations under ``shard_map`` over a
  ``Mesh`` of all 8; the port evaluates the same genomes on a simulated
  ``PopulationMesh`` of 8 CPU shards: within 1e-6 relative, ``valid``
  equal.
* The port's sharded metrics equal its unsharded ones bit for bit at 2,
  3 and 8 shards and populations of 1, 7 and 1,001 (the engine has no
  reduction across candidates); padding never shows.
* Sharded and unsharded searches write identical logs.

Everything runs on the CPU, where every mesh of more than one shard is
simulated.
"""
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference as R  # noqa: E402
from repro_torch.core import Sparseloop, compile_stats, matmul  # noqa: E402
from repro_torch.core.batched import clear_caches  # noqa: E402
from repro_torch.core.device import PopulationMesh  # noqa: E402
from repro_torch.core.mapper import MapspaceConstraints  # noqa: E402
from repro_torch.core.presets import (coordinate_list_design,  # noqa: E402
                                      two_level_arch)
from repro_torch.dse import EvaluationService  # noqa: E402
from repro_torch.launch import hillclimb  # noqa: E402
from repro_torch.search import (MapspaceEncoding, population_mesh,  # noqa: E402
                                run_search, validate_search_env)
from repro_torch.search.log import SearchLog  # noqa: E402

CPU = "cpu"
N = 1001
CASES = R.search_cases("repro_torch")
#: the cases the reference evaluates sharded: a bucket (free loop
#: orders), the ResNet50 conv2_x bucket, a co-search population with
#: per-candidate arch rows, and the exact template of pinned loop orders
SHARDED_CASES = ("free", "conv2_x", "cosearch", "pinned")
REL = 1e-6
METRICS = ("cycles", "energy_pj", "edp")


def _inputs() -> dict:
    return {name: R.genomes_for(CASES[name][2], N, seed=i)[1]
            for i, name in enumerate(SHARDED_CASES)}


INPUTS = _inputs()


def _largest_template(enc, pop):
    """The largest exact-template group of ``pop``, cut to a size that
    is not a multiple of 8: (template, bounds)."""
    template, _, bounds = max(enc.decode_population(pop),
                              key=lambda g: len(g[1]))
    n = len(bounds) - (len(bounds) % 8 == 0)
    return template, np.asarray(bounds)[:n]


def _evaluate(name, pop, mesh):
    """The port's metrics of ``pop`` of case ``name`` on the CPU,
    sharded over ``mesh``."""
    design, wl, enc = CASES[name]
    engine = Sparseloop(design, device=CPU)
    if name == "pinned":
        template, bounds = _largest_template(enc, pop)
        return engine.batched_model(wl, template).evaluate(bounds,
                                                           mesh=mesh)
    bucket, bounds, ids = enc.decode_bucketed(pop)
    ap = enc.arch_params_of(pop) if name == "cosearch" else None
    return engine.bucketed_model(wl, bucket).evaluate(
        bounds, ids, mesh=mesh, arch_params=ap)


@pytest.fixture(scope="module")
def reference():
    return R.run_reference("""
        import jax
        from jax.sharding import Mesh
        import torch_reference as R
        from repro.core.engine import Sparseloop
        assert len(jax.devices()) == 8, jax.devices()
        mesh = Mesh(np.asarray(jax.devices()), ("pop",))
        cases = R.search_cases("repro")
        for name, pop in IN.items():
            design, wl, enc = cases[name]
            engine = Sparseloop(design)
            if name == "pinned":
                template, _, bounds = max(enc.decode_population(pop),
                                          key=lambda g: len(g[1]))
                n = len(bounds) - (len(bounds) % 8 == 0)
                res = engine.batched_model(wl, template).evaluate(
                    np.asarray(bounds)[:n], mesh=mesh)
            else:
                bucket, bounds, ids = enc.decode_bucketed(pop)
                ap = enc.arch_params_of(pop) if name == "cosearch" \\
                    else None
                res = engine.bucketed_model(wl, bucket).evaluate(
                    bounds, ids, mesh=mesh, arch_params=ap)
            for k in ("cycles", "energy_pj", "edp", "valid"):
                OUT[f"{name}.{k}"] = np.asarray(res[k])
    """, INPUTS, env={"XLA_FLAGS":
                      "--xla_force_host_platform_device_count=8"})


def _mesh(n: int) -> PopulationMesh:
    return PopulationMesh((CPU,) * n)


# ----------------------------------------------------------------------
# against the JAX package's sharded engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", SHARDED_CASES)
def test_sharded_engine_matches_reference(reference, name):
    got = _evaluate(name, INPUTS[name], _mesh(8))
    want = {k: reference[f"{name}.{k}"] for k in METRICS + ("valid",)}
    assert len(got["edp"]) == len(want["edp"]) and len(want["edp"]) % 8
    np.testing.assert_array_equal(got["valid"], want["valid"])
    for k in METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)


# ----------------------------------------------------------------------
# against the port's own unsharded engine: bit for bit
# ----------------------------------------------------------------------
def _assert_same_bits(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("shards", [2, 3, 8])
@pytest.mark.parametrize("name", ["conv2_x", "cosearch", "pinned"])
def test_sharded_equals_unsharded_bit_for_bit(name, shards):
    for n in (1, 7, N):
        pop = INPUTS[name][:n]
        _assert_same_bits(_evaluate(name, pop, _mesh(shards)),
                          _evaluate(name, pop, None))


def test_mesh_of_one_and_none_take_the_plain_path():
    pop = INPUTS["conv2_x"][:64]
    with compile_stats.track() as st:
        plain = _evaluate("conv2_x", pop, None)
        one = _evaluate("conv2_x", pop, _mesh(1))
    _assert_same_bits(one, plain)
    assert st.batched_evals == 128


def test_sharded_calls_are_counted_and_keyed_by_padded_shape():
    """One batched-eval count per call on the unpadded population, one
    compile per (sharded, size, padded shape) as the JAX package keys
    it, and one ``engine.*`` span carrying ``shards``."""
    from repro_torch import obs
    clear_caches()
    pop = INPUTS["conv2_x"]
    obs.enable()
    try:
        with compile_stats.track() as st:
            _evaluate("conv2_x", pop[:13], _mesh(4))   # pads to 16
            _evaluate("conv2_x", pop[:15], _mesh(4))   # 16 again
            _evaluate("conv2_x", pop[:17], _mesh(4))   # 20: new
        spans = [s for name in ("engine.compile", "engine.eval")
                 for s in obs.tracer().find(name)]
    finally:
        obs.disable()
    assert st.batched_evals == 13 + 15 + 17
    assert st.compiles == 2, st.as_dict()
    assert [s.attrs.get("shards") for s in spans] == [4, 4, 4]


def test_concurrent_evaluations_fill_the_device_caches_safely():
    """A service's evaluator thread and direct callers may evaluate at
    once: many threads, sharded and not, each on fresh per-device
    caches under a short switch interval, all bit-identical."""
    pop = INPUTS["cosearch"]
    want = _evaluate("cosearch", pop, None)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(2):
            clear_caches()
            with ThreadPoolExecutor(8) as pool:
                got = list(pool.map(
                    lambda m: _evaluate("cosearch", pop,
                                        _mesh(m) if m > 1 else None),
                    [1, 2, 3, 4, 5, 6, 7, 8] * 2))
            for g in got:
                _assert_same_bits(g, want)
    finally:
        sys.setswitchinterval(old)


# ----------------------------------------------------------------------
# searches: sharded logs equal unsharded ones
# ----------------------------------------------------------------------
def _search_cell():
    """The JAX package's ``tests/test_search.py`` sharding cell."""
    wl = matmul(32, 32, 32, densities={"A": ("uniform", 0.3),
                                       "B": ("uniform", 0.3)})
    design = coordinate_list_design(two_level_arch(buffer_kwords=8))
    cons = MapspaceConstraints(budget=64, seed=0, spatial={1: {"n": 4}},
                               permutations={0: ("n", "k", "m"),
                                             1: ("m", "n")})
    return design, wl, cons, 42


def _parity_cell():
    """``bench_search_convergence``'s shard-parity cell."""
    wl = matmul(64, 64, 64, densities={"A": ("uniform", 0.3),
                                       "B": ("uniform", 0.5)})
    design = coordinate_list_design(two_level_arch())
    cons = MapspaceConstraints(budget=256, seed=0, spatial={1: {"n": 8}},
                               permutations={0: ("n", "k", "m"),
                                             1: ("m", "n")})
    return design, wl, cons, 123


@pytest.mark.parametrize("cell", [_search_cell, _parity_cell])
def test_sharded_search_log_equals_unsharded(cell):
    design, wl, cons, key = cell()
    logs = [run_search(design, wl, cons, strategy="es", key=key,
                       pop_size=64, mesh=mesh, device=CPU)
            .log.to_json(timing=False)
            for mesh in (None, _mesh(2), _mesh(8))]
    assert logs[0] == logs[1] == logs[2]
    assert SearchLog.from_json(logs[0]).records


def test_mapper_search_passes_the_mesh_through():
    from repro_torch.core.mapper import search
    design, wl, cons, key = _search_cell()
    direct = run_search(design, wl, cons, strategy="es", key=key,
                        pop_size=64, mesh=_mesh(4), device=CPU)
    via = search(design, wl, cons, strategy="es", key=key, pop_size=64,
                 mesh=_mesh(4), device=CPU)
    assert via.log.to_json(timing=False) == \
        direct.log.to_json(timing=False)


# ----------------------------------------------------------------------
# population_mesh and the device rule
# ----------------------------------------------------------------------
def test_population_mesh_resolution(monkeypatch):
    monkeypatch.delenv("REPRO_SEARCH_DEVICES", raising=False)
    assert population_mesh(device=CPU) is None        # one device
    monkeypatch.setenv("REPRO_SEARCH_DEVICES", "4")
    mesh = population_mesh(device=CPU)
    assert mesh.size == 4 and mesh.simulated
    assert mesh.axis_names == ("pop",) and "simulated" in str(mesh)
    assert population_mesh(min_devices=8, device=CPU) is None
    # the device rule: device=None is the card, raising without one,
    # whatever REPRO_SEARCH_DEVICES says
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        population_mesh()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run_search(*_search_cell()[:3], pop_size=64)


def test_population_mesh_takes_every_visible_card(monkeypatch):
    """Two or more cards: a mesh over all of them, the run's card first,
    not simulated (no card is touched to build it)."""
    monkeypatch.delenv("REPRO_SEARCH_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = population_mesh(device="cuda:2")
    assert [str(d) for d in mesh.devices] == ["cuda:2", "cuda:0",
                                              "cuda:1", "cuda:3"]
    assert not mesh.simulated and "simulated" not in str(mesh)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert population_mesh(device="cuda:0") is None


def test_mesh_and_device_must_agree():
    design, wl, cons, key = _search_cell()
    with pytest.raises(ValueError, match="does not start at"):
        run_search(design, wl, cons, pop_size=64, device=CPU,
                   mesh=PopulationMesh(("meta",) * 2))
    model = Sparseloop(design, device=CPU).bucketed_model(
        wl, MapspaceEncoding(wl, 2, cons).bucket)
    b = np.ones((4, model.num_slots), np.int64)
    with pytest.raises(ValueError, match="does not start at"):
        model.evaluate(b, np.zeros_like(b),
                       mesh=PopulationMesh(("meta",) * 2))
    with pytest.raises(ValueError, match="mesh must be"):
        run_search(design, wl, cons, pop_size=64, device=CPU,
                   mesh="everywhere")
    with pytest.raises(ValueError, match="at least one device"):
        PopulationMesh(())


def test_search_devices_is_a_known_setting(monkeypatch):
    monkeypatch.setenv("REPRO_SEARCH_DEVICES", "2")
    assert validate_search_env() == []


def test_service_forces_and_fused_ignores_the_mesh(monkeypatch):
    """A service owns the devices (the run's mesh is forced to None);
    the fused path runs on one device whatever the mesh."""
    monkeypatch.setenv("REPRO_SEARCH_DEVICES", "4")
    design, wl, cons, key = _search_cell()
    plain = run_search(design, wl, cons, key=key, pop_size=64, mesh=None,
                       device=CPU).log.to_json(timing=False)
    with EvaluationService() as svc:
        served = run_search(design, wl, cons, key=key, pop_size=64,
                            service=svc.client("s"), device=CPU)
    assert served.log.to_json(timing=False) == plain
    fused = [run_search(design, wl, cons, key=key, pop_size=64, mesh=m,
                        fused=True, device=CPU).log.to_json(timing=False)
             for m in ("auto", None)]
    assert fused[0] == fused[1]


# ----------------------------------------------------------------------
# the service's mesh
# ----------------------------------------------------------------------
def test_service_mesh_coalesces_and_equals_direct():
    name = "free"
    design, wl, enc = CASES[name]
    pop = INPUTS[name][:40]
    bucket, bounds, ids = enc.decode_bucketed(pop)
    model = Sparseloop(design, device=CPU).bucketed_model(wl, bucket)
    direct = model.evaluate(bounds, ids)
    svc = EvaluationService(mesh=_mesh(4), autostart=False)
    futs = [svc.submit(model, bounds[:13], rank_ids=ids[:13], client="a"),
            svc.submit(model, bounds[13:], rank_ids=ids[13:], client="b")]
    assert svc.drain_once() == 2
    got = [f.result(5) for f in futs]
    assert svc.stats()["batches"] == 1      # one coalesced invocation
    svc.close()
    for k, w in direct.items():
        np.testing.assert_array_equal(
            np.concatenate([got[0][k], got[1][k]]), w, err_msg=k)


def test_service_mesh_batch_slots_keep_one_shape():
    clear_caches()
    name = "free"
    design, wl, enc = CASES[name]
    pop = INPUTS[name][:40]
    bucket, bounds, ids = enc.decode_bucketed(pop)
    model = Sparseloop(design, device=CPU).bucketed_model(wl, bucket)
    direct = model.evaluate(bounds, ids)
    with compile_stats.track() as st, \
            EvaluationService(mesh=_mesh(3), batch_slots=16) as svc:
        c = svc.client("t")
        parts = [c.evaluate(model, bounds[a:b], rank_ids=ids[a:b])
                 for a, b in ((0, 5), (5, 16), (16, 40))]
    assert st.compiles == 1, st.as_dict()
    for k, w in direct.items():
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), w, err_msg=k)


# ----------------------------------------------------------------------
# the hillclimb CLI
# ----------------------------------------------------------------------
def test_hillclimb_cli_shards_over_simulated_devices(monkeypatch, capsys):
    argv = ["--device", "cpu", "--design", "coordlist", "--mkn", "64",
            "64", "64", "--strategy", "es", "--budget", "128", "--pop",
            "32", "--seed", "3"]
    monkeypatch.delenv("REPRO_SEARCH_DEVICES", raising=False)
    plain = hillclimb.main(argv)
    assert "devices=1 budget" in capsys.readouterr().out
    monkeypatch.setenv("REPRO_SEARCH_DEVICES", "4")
    sharded = hillclimb.main(argv)
    assert "devices=4 (simulated)" in capsys.readouterr().out
    assert sharded.log.to_json(timing=False) == \
        plain.log.to_json(timing=False)


def test_auto_mesh_takes_no_card_by_default(monkeypatch):
    """``mesh="auto"`` (``runner.auto_mesh``) is None on a machine with
    several cards, where sharding over them is asked for with
    ``population_mesh()``; ``REPRO_SEARCH_DEVICES`` gives its simulated
    mesh on the run's device."""
    from repro_torch.search.runner import auto_mesh
    monkeypatch.delenv("REPRO_SEARCH_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert auto_mesh("cuda:1") is None
    assert population_mesh(device="cuda:1").size == 4
    monkeypatch.setenv("REPRO_SEARCH_DEVICES", "3")
    mesh = auto_mesh("cuda:1")
    assert mesh.simulated and mesh.size == 3
    assert [str(d) for d in mesh.devices] == ["cuda:1"] * 3
