"""The port's DSE service and island search (``repro_torch.dse``), held to
the contracts of the JAX package's ``tests/test_service.py`` and of the
fused-mode cases of ``tests/test_fused.py``.

* routing a population through the service returns EXACTLY what the
  direct ``BucketedModel.evaluate`` path returns (the service is a
  transport, never a model);
* concurrent requests over the same facade coalesce into one program
  invocation and slice back out per request;
* fixed ``batch_slots`` keep every invocation on one shape, so requests
  of 5, 11 and 16 candidates make one first call, with exact slices;
* ``max_batch`` splits keep request boundaries; errors fan out to every
  future; per-client metrics attribute the tenants;
* ``run_search(service=)`` equals the direct run; islands share one
  program, validate their winners, and run with migration off;
* ``close(drain=False)`` fails queued futures and refuses submits, a
  clean shutdown drains, the context exit drains in-flight requests;
* facades built concurrently are one facade;
* fused requests and fused island mode run through the evaluator
  thread (``fused_chunks``, no batches), and islands without migration
  give the direct fused runs' trajectories.

Everything runs on the CPU; ``autostart=False`` + ``drain_once()``
wherever the reference uses them, so no test waits on a thread's
timing.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import Sparseloop, compile_stats, matmul  # noqa: E402
from repro_torch.core.batched import get_bucketed_model  # noqa: E402
from repro_torch.core.mapper import MapspaceConstraints  # noqa: E402
from repro_torch.core.presets import (coordinate_list_design,  # noqa: E402
                                      scnn_like, three_level_arch,
                                      two_level_arch)
from repro_torch.dse import (EvaluationService, ServiceClosed,  # noqa: E402
                             run_islands)
from repro_torch.dse.islands import island_seeds  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402
from repro_torch.search import (MapspaceEncoding, SearchConfig,  # noqa: E402
                                run_search)

CPU = "cpu"
WL = matmul(32, 32, 32, densities={"A": ("uniform", 0.3),
                                   "B": ("uniform", 0.3)})
DESIGN = coordinate_list_design(two_level_arch(buffer_kwords=8))
CONS = MapspaceConstraints(budget=96, seed=0, spatial={1: {"n": 4}})
#: tiny test populations must still take the batched/bucketed route
#: (the scalar fallback would bypass the service entirely)
BATCHED = SearchConfig(batch_threshold=1)


def _decoded_population(n, seed=0):
    """(bucketed facade, bounds, rank_ids) for a random population —
    the exact decode the search runner hands the service."""
    enc = MapspaceEncoding(WL, 2, CONS)
    pop = enc.random_population(seed, n)
    bucket, bounds, ids = enc.decode_bucketed(pop)
    model = Sparseloop(DESIGN, device=CPU).bucketed_model(WL, bucket)
    return model, bounds, ids


# ----------------------------------------------------------------------
# transport parity + coalescing
# ----------------------------------------------------------------------
def test_service_matches_direct_path_exactly():
    model, bounds, ids = _decoded_population(12)
    direct = model.evaluate(bounds, ids)
    with EvaluationService() as svc:
        served = svc.client("t").evaluate(model, bounds, rank_ids=ids)
    assert set(served) == set(direct)
    for k in direct:
        np.testing.assert_array_equal(served[k], direct[k])


def test_concurrent_requests_coalesce_into_one_batch():
    model, bounds, ids = _decoded_population(16)
    direct = model.evaluate(bounds, ids)
    svc = EvaluationService(autostart=False)
    futs = [svc.submit(model, bounds[s], rank_ids=ids[s], client=c)
            for c, s in (("a", slice(0, 10)), ("b", slice(10, 16)))]
    assert svc.drain_once() == 2
    st = svc.stats()
    assert (st["requests"], st["batches"]) == (2, 1)
    assert st["coalesced_requests"] == 2
    res_a, res_b = futs[0].result(1), futs[1].result(1)
    for k in direct:
        np.testing.assert_array_equal(res_a[k], direct[k][:10])
        np.testing.assert_array_equal(res_b[k], direct[k][10:])
    svc.close()


def test_batch_slots_pin_one_shape():
    """Requests of 5, 11, then 16 candidates through a slotted service
    reuse ONE shape (pad short, split long): one first call, and no
    program beyond the bucket's."""
    model, bounds, ids = _decoded_population(16)
    direct = model.evaluate(bounds, ids)        # warm the program
    with compile_stats.track() as st:
        with EvaluationService(batch_slots=8, autostart=False) as svc:
            c = svc.client("shapes")
            r5 = c.evaluate(model, bounds[:5], rank_ids=ids[:5])
            r11 = c.evaluate(model, bounds[5:], rank_ids=ids[5:])
            r16 = c.evaluate(model, bounds, rank_ids=ids)
    assert st.compiles == 1 and st.programs == 0
    for k in direct:
        np.testing.assert_array_equal(
            np.concatenate([r5[k], r11[k]]), direct[k])
        np.testing.assert_array_equal(r16[k], direct[k])


def test_max_batch_splits_preserve_request_boundaries():
    model, bounds, ids = _decoded_population(16)
    direct = model.evaluate(bounds, ids)
    svc = EvaluationService(max_batch=6, autostart=False)
    futs = [svc.submit(model, bounds[i:i + 4], rank_ids=ids[i:i + 4],
                       client=f"c{i}") for i in range(0, 16, 4)]
    svc.drain_once()
    assert svc.stats()["batches"] == 4      # 4-candidate requests never
    for i, fut in enumerate(futs):          # straddle the 6-cap
        for k in direct:
            np.testing.assert_array_equal(
                fut.result(1)[k], direct[k][i * 4:(i + 1) * 4])
    svc.close()


def test_evaluation_errors_fan_out_to_every_future():
    class Boom:
        kind = "boom"

        def evaluate(self, *a, **k):
            raise ValueError("broken model")

    svc = EvaluationService(autostart=False)
    futs = [svc.submit(Boom(), np.ones((3, 2)), client=c)
            for c in ("a", "b")]
    svc.drain_once()
    for fut in futs:
        with pytest.raises(ValueError, match="broken model"):
            fut.result(1)
    svc.close()


# ----------------------------------------------------------------------
# multi-tenant accounting
# ----------------------------------------------------------------------
def test_per_client_metrics_attribute_tenants():
    metrics.reset()
    model, bounds, ids = _decoded_population(10)
    with EvaluationService() as svc:
        svc.client("alice").evaluate(model, bounds[:7], rank_ids=ids[:7])
        svc.client("bob").evaluate(model, bounds[7:], rank_ids=ids[7:])
        alice = svc.client_metrics("alice")
        bob = svc.client("bob").metrics()
    assert alice["dse.client.alice.requests"]["value"] == 1
    assert alice["dse.client.alice.candidates"]["value"] == 7
    assert bob["dse.client.bob.candidates"]["value"] == 3
    assert alice["dse.client.alice.request_latency_s"]["count"] == 1
    assert not any("bob" in k for k in alice)
    snap = metrics.snapshot()
    assert snap["dse.candidates"]["value"] == 10
    assert snap["dse.request_latency_s"]["count"] == 2


# ----------------------------------------------------------------------
# search integration
# ----------------------------------------------------------------------
def test_run_search_through_service_matches_direct():
    direct = run_search(DESIGN, WL, CONS, strategy="es", key=3,
                        pop_size=8, generations=3, config=BATCHED,
                        device=CPU)
    with EvaluationService() as svc:
        served = run_search(DESIGN, WL, CONS, strategy="es", key=3,
                            pop_size=8, generations=3, config=BATCHED,
                            service=svc.client("search"), device=CPU)
        assert svc.stats()["requests"] >= 3     # actually routed here
    assert served.best is not None
    assert served.log.to_json(timing=False) == \
        direct.log.to_json(timing=False)
    assert served.best.edp == direct.best.edp
    assert served.evaluated == direct.evaluated


def test_islands_share_programs_and_validate_winners():
    metrics.reset()
    with compile_stats.track() as st:
        res = run_islands(DESIGN, WL, CONS, n_islands=3, strategy="es",
                          key=0, pop_size=8, generations=4,
                          migrate_every=2, config=BATCHED, device=CPU)
    # one free-permutation bucket -> one program and one shape for ALL
    # islands
    assert st.programs <= 1 and st.compiles <= 1
    assert len(res.per_island) == 3 and len(res.logs) == 3
    assert res.evaluations == 3 * 8 * 4
    assert res.service_stats["clients"] == ["island0", "island1",
                                            "island2"]
    oracle = Sparseloop(DESIGN)
    for r in res.per_island:
        assert r.best is not None
        ev = oracle.evaluate(WL, r.best_nest)
        assert ev.result.valid
        assert ev.edp == pytest.approx(r.best.edp, rel=1e-6)
    assert res.best.best.edp == min(r.best.edp for r in res.per_island)
    snap = metrics.snapshot()
    for i in range(3):
        assert snap[f"dse.client.island{i}.requests"]["value"] >= 4


def test_island_migration_disabled_still_runs():
    res = run_islands(DESIGN, WL, CONS, n_islands=2, strategy="es",
                      key=1, pop_size=8, generations=2, migrate_every=0,
                      config=BATCHED, device=CPU)
    assert res.best.best is not None
    assert all(len(log.records) == 2 for log in res.logs)


def test_island_seeds_come_from_the_run_seed():
    assert island_seeds(0, 3) == island_seeds(0, 3)
    assert island_seeds(0, 3) != island_seeds(1, 3)
    assert len(set(island_seeds(0, 8))) == 8


# ----------------------------------------------------------------------
# shutdown semantics
# ----------------------------------------------------------------------
def test_close_without_drain_fails_pending_and_refuses_submits():
    model, bounds, ids = _decoded_population(6)
    svc = EvaluationService(autostart=False)
    fut = svc.submit(model, bounds, rank_ids=ids, client="late")
    svc.close(drain=False)
    with pytest.raises(ServiceClosed):
        fut.result(1)
    with pytest.raises(ServiceClosed):
        svc.submit(model, bounds, rank_ids=ids)
    with pytest.raises(ServiceClosed):
        svc.submit_fused(lambda: None)


def test_close_with_drain_serves_pending():
    model, bounds, ids = _decoded_population(6)
    direct = model.evaluate(bounds, ids)
    svc = EvaluationService(autostart=False)
    fut = svc.submit(model, bounds, rank_ids=ids)
    svc.close(drain=True)
    np.testing.assert_array_equal(fut.result(1)["edp"], direct["edp"])


def test_context_exit_drains_in_flight_requests():
    model, bounds, ids = _decoded_population(6)
    with EvaluationService() as svc:
        fut = svc.submit(model, bounds, rank_ids=ids)
    assert fut.done()
    assert len(fut.result(0)["edp"]) == 6


# ----------------------------------------------------------------------
# cache thread-safety (the service's precondition)
# ----------------------------------------------------------------------
def test_concurrent_facade_construction_is_safe_and_shared():
    enc = MapspaceEncoding(WL, 2, CONS)
    out, errs = [None] * 8, []

    def build(i):
        try:
            out[i] = get_bucketed_model(DESIGN, WL, enc.bucket, device=CPU)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=build, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert all(m is out[0] for m in out)    # content-cached: ONE facade


# ----------------------------------------------------------------------
# fused requests and fused island mode
# ----------------------------------------------------------------------
def test_service_fused_requests():
    with EvaluationService(autostart=False) as svc:
        client = svc.client("t0")
        carry, ys = client.run_fused(lambda: ("carry", {"n": 1}))
        assert carry == "carry" and ys == {"n": 1}
        assert svc.stats()["fused_chunks"] == 1
        assert svc.stats()["batches"] == 0
        assert svc.client_metrics("t0")["dse.client.t0.fused_chunks"][
            "value"] == 1


def test_run_search_fused_through_service_matches_direct():
    direct = run_search(DESIGN, WL, CONS, strategy="es", key=4, fused=True,
                        config=SearchConfig(fused_chunk=2), device=CPU)
    with EvaluationService() as svc:
        served = run_search(DESIGN, WL, CONS, strategy="es", key=4,
                            fused=True, config=SearchConfig(fused_chunk=2),
                            service=svc.client("f"), device=CPU)
        assert svc.stats()["fused_chunks"] == 2
    assert served.log.to_json(timing=False) == \
        direct.log.to_json(timing=False)


def test_islands_fused_mode():
    design = scnn_like(three_level_arch())
    wl = matmul(64, 48, 32, densities={"A": ("uniform", 0.4),
                                       "B": ("uniform", 0.6)})
    cons = MapspaceConstraints(budget=256, seed=0, spatial={1: {"n": 8}})
    r = run_islands(design, wl, cons, n_islands=2, generations=4,
                    migrate_every=2, key=0, fused=True, device=CPU)
    # 2 islands x 2 chunks, all through the service's fused path
    assert r.service_stats["fused_chunks"] == 4
    assert r.service_stats["batches"] == 0
    assert r.best.best is not None and r.best.best.result.valid
    assert r.evaluations == 2 * 4 * 32
    assert all(rec.wall_time_s is None
               for lg in r.logs for rec in lg.records)


def test_fused_islands_without_migration_are_the_direct_runs():
    """With migration off, each fused island (one shared program,
    chunks run on the service's thread) follows the fused run_search
    of its own seed on this thread."""
    cfg = SearchConfig(fused_chunk=2)
    r = run_islands(DESIGN, WL, CONS, n_islands=2, generations=3,
                    migrate_every=0, key=5, fused=True, config=cfg,
                    device=CPU)
    for log, seed in zip(r.logs, island_seeds(5, 2)):
        direct = run_search(DESIGN, WL, CONS, strategy="es", key=seed,
                            generations=3, fused=True, config=cfg,
                            device=CPU)
        assert log.to_dict(timing=False)["records"] == \
            direct.log.to_dict(timing=False)["records"]


def test_islands_fused_fallback_warns():
    with pytest.warns(UserWarning, match="not fused-eligible"):
        r = run_islands(DESIGN, WL, CONS, n_islands=2, strategy="hillclimb",
                        key=0, pop_size=8, generations=2, migrate_every=0,
                        fused=True, config=BATCHED, device=CPU)
    assert r.service_stats["fused_chunks"] == 0 and r.best.best is not None
