"""Topology-as-data in the port (``TopologySpace`` /
``TopologyCoSearchEncoding``) against the JAX package's, and the
topology co-search contracts.

Parity, on fixed numpy genomes: the (topology, mapping) and (topology,
design, mapping) encodings give the reference's layout, topology groups,
folded sub-genomes, per-group bucket decodes, arch rows, nests and
design names exactly, and the ``PopulationEvaluator`` gives the
reference's fitness within 1e-6 relative with ``valid`` equal, on the
bucketed route and the scalar route.  The reference runs in a
subprocess (``torch_reference.run_reference``).

Contracts, on the port alone: every gene row (out-of-range ones
included) decodes to a valid (Architecture, SAFSpec) the scalar oracle
evaluates; derivation-equal rows share one canonical topology key,
which ignores scalar provisioning but not SAF placement; groups
partition a population; a mixed-topology ``run_search`` builds at most
one program per distinct topology (x its one bucket) with zero scalar
evaluations, and its winner re-validates under its own design; runs are
deterministic from their seed; constraints fail fast."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_reference as R  # noqa: E402
from repro_torch.core import Sparseloop, compile_stats  # noqa: E402
from repro_torch.core.arch import topology_key  # noqa: E402
from repro_torch.core.batched import clear_caches  # noqa: E402
from repro_torch.core.mapper import MapspaceConstraints  # noqa: E402
from repro_torch.core.presets import (coordinate_list_design,  # noqa: E402
                                      two_level_arch)
from repro_torch.search import (MapspaceEncoding, SearchConfig,  # noqa: E402
                                TopologyCoSearchEncoding, run_search)

CPU = "cpu"
POP = 24
CASES = R.topology_cases("repro_torch")
ROUTES = {"bucket": dict(batch_threshold=1),
          "scalar": dict(batch_threshold=10 ** 9)}
WL = CASES["topology"][0]
#: spatial constraints must stay inside the stable (required) inner
#: suffix — level-from-inner 0 is SPad in every decoded topology
CONS = MapspaceConstraints(budget=128, seed=0, spatial={0: {"n": 4}})
#: tiny test populations must still take the bucketed route
BATCHED = SearchConfig(batch_threshold=1)


def _inputs() -> dict:
    out = {}
    for i, (name, (_, enc)) in enumerate(CASES.items()):
        out[name + ".wild"], out[name + ".pop"] = R.genomes_for(
            enc, POP, seed=100 + i)
    return out


INPUTS = _inputs()

reference = R.reference_fixture(f"""
    import torch_reference as R
    for name, (wl, enc) in R.topology_cases("repro").items():
        wild, pop = IN[name + ".wild"], IN[name + ".pop"]
        for k, v in R.topology_outputs(enc, wild, pop).items():
            OUT[f"{{name}}.enc.{{k}}"] = v
        for route, cfg in {ROUTES!r}.items():
            res = R.fitness_outputs("repro", enc.representative_design(), wl,
                                    enc, pop, **cfg)
            for k, v in res.items():
                OUT[f"{{name}}.{{route}}.{{k}}"] = v
""", INPUTS)


def _want(reference, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in reference.items()
            if k.startswith(prefix)}


def _ts():
    return R.topology_space("repro_torch")


# ----------------------------------------------------------------------
# parity with the JAX package on fixed genomes
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
def test_topology_encoding_matches_reference(reference, name):
    _, enc = CASES[name]
    got = R.topology_outputs(enc, INPUTS[name + ".wild"],
                             INPUTS[name + ".pop"])
    want = _want(reference, f"{name}.enc.")
    assert set(got) == set(want)
    R.assert_same(got, want, prefix=f"{name}: ")
    assert len(want["groups"]) > 1


@pytest.mark.parametrize("name,route", [(n, r) for n in CASES
                                        for r in ROUTES])
def test_topology_fitness_matches_reference(reference, name, route):
    wl, enc = CASES[name]
    got = R.fitness_outputs("repro_torch", enc.representative_design(), wl,
                            enc, INPUTS[name + ".pop"], **ROUTES[route])
    want = _want(reference, f"{name}.{route}.")
    R.assert_fitness_close(got, want, rel=1e-6)
    assert want["valid"].any()


# ----------------------------------------------------------------------
# decode validity: every gene row is a working design, by construction
# ----------------------------------------------------------------------
def test_every_random_genome_decodes_to_valid_architecture():
    ts = _ts()
    slot_names = [s.level.name for s in ts.slots]
    known_keys = {k for k, _ in ts.enumerate_designs()}
    rng = np.random.default_rng(0)
    # deliberately out-of-range (negative included): repair is a mod
    for row in rng.integers(-50, 50, size=(64, ts.num_genes)):
        arch, safs = ts.decode(row)
        assert ts.min_levels <= arch.num_levels <= ts.max_levels
        names = [lv.name for lv in arch.levels]
        # present levels are a subsequence of the slots, order kept
        assert [n for n in slot_names if n in names] == names
        present = set(names) | {"compute"}
        for lvl, _t in safs.formats:
            assert lvl in present
        for act in safs.actions:
            assert act.level in present
        assert topology_key(arch, safs) in known_keys


def test_decoded_designs_evaluate_under_scalar_oracle():
    designs = _ts().enumerate_designs()
    assert len(designs) == 6        # {2,3 levels} x {SPad saf} (x GLB saf)
    for _key, d in designs:
        enc = MapspaceEncoding(WL, d.arch.num_levels, CONS)
        nest = enc.nest_of(np.zeros(enc.genome_size, np.int64))
        ev = Sparseloop(d).evaluate(WL, nest, check_capacity=False)
        assert np.isfinite(ev.edp) and ev.edp > 0


# ----------------------------------------------------------------------
# canonical topology keys
# ----------------------------------------------------------------------
def test_topology_key_ignores_inert_genes_of_absent_slots():
    ts = _ts()
    # GLB absent (presence gene 0): its SAF gene is inert
    rows = [np.array([0, glb_saf, 0]) for glb_saf in (0, 1)]
    assert len({ts.topology_key_of(r) for r in rows}) == 1
    assert {ts.design_of(r).name for r in rows} == {"topo[DRAM/SPad]"}
    # ...which is why distinct topologies < gene-row count
    assert len(ts.enumerate_designs()) < ts.size


def test_topology_key_ignores_scalar_provisioning():
    a = two_level_arch(buffer_kwords=8)
    b = two_level_arch(buffer_kwords=64, dram_bw=128, pes=16)
    assert topology_key(a) == topology_key(b)
    d1, d2 = coordinate_list_design(a), coordinate_list_design(b)
    assert topology_key(d1.arch, d1.safs) == topology_key(d2.arch,
                                                          d2.safs)
    # ...but SAF placement IS the key: dense vs coordinate-list differ
    assert topology_key(a) != topology_key(d1.arch, d1.safs)


# ----------------------------------------------------------------------
# mixed-topology co-search: programs per group, oracle winner
# ----------------------------------------------------------------------
def test_mixed_population_groups_cover_and_partition():
    ts = _ts()
    enc = TopologyCoSearchEncoding(WL, CONS, ts)
    pop = enc.structured_population(1, 48)
    groups = enc.group_by_topology(pop)
    assert 1 < len(groups) <= len(ts.enumerate_designs())
    idx = np.sort(np.concatenate([i for _, i in groups]))
    np.testing.assert_array_equal(idx, np.arange(48))     # a partition
    for grp, i in groups:
        assert {enc.design_of(pop[j]).name for j in i} == \
            {grp.design.name}
        sub = enc.sub_genomes(pop[i], grp)
        assert sub.shape == (len(i), grp.enc.genome_size)


@pytest.mark.parametrize("name", list(CASES))
def test_mixed_topology_search_programs_within_groups(name):
    ts = _ts()
    space = CASES[name][1].space
    bound = len(ts.enumerate_designs())     # topology groups x 1 bucket
    clear_caches()
    with compile_stats.track() as st:
        r = run_search(None, WL, CONS, strategy="es", key=0,
                       topology_space=ts, design_space=space,
                       config=BATCHED, pop_size=16, device=CPU)
    # one padded bucket program per topology group, one input shape
    # each, however many candidates — and never the scalar oracle
    assert 1 < st.programs <= bound and st.compiles == st.programs
    assert st.scalar_evals == 0
    assert r.best is not None and r.best.result.valid
    assert r.best_design is not None
    # the winner revalidates under ITS OWN decoded design
    oracle = Sparseloop(r.best_design).evaluate(WL, r.best_nest)
    assert r.best.edp == pytest.approx(oracle.edp, rel=1e-9)


def test_topology_search_is_deterministic():
    runs = [run_search(None, WL, CONS, strategy="es", key=3,
                       topology_space=_ts(), config=BATCHED, pop_size=16,
                       device=CPU) for _ in range(2)]
    assert runs[0].log.to_json(timing=False) == \
        runs[1].log.to_json(timing=False)
    assert runs[0].best_design.name == runs[1].best_design.name


def test_constraint_validation_fails_fast():
    ts = _ts()
    with pytest.raises(ValueError, match="stable inner suffix"):
        TopologyCoSearchEncoding(
            WL, MapspaceConstraints(budget=64, seed=0,
                                    spatial={1: {"n": 4}}), ts)
    with pytest.raises(ValueError, match="permutations"):
        TopologyCoSearchEncoding(
            WL, MapspaceConstraints(budget=64, seed=0,
                                    permutations={0: ("m", "n", "k")}),
            ts)
    with pytest.raises(ValueError, match="design=None"):
        run_search(coordinate_list_design(two_level_arch()), WL, CONS,
                   topology_space=ts, device=CPU)
