"""DSE-as-a-service: a persistent batched evaluation service.

A batched evaluation costs a fixed few thousand device operations
whatever its population, so the engine pays off on large populations
and warm programs.  One search amortizes that over its own generations;
this module amortizes it over *many concurrent searches*, the way
``launch/serve.py`` amortizes a model's weights across decode requests:

* An :class:`EvaluationService` owns the process-wide warm program
  caches (``core.batched._PROGRAM_CACHE`` / ``_MODEL_CACHE``) and runs
  one background evaluator thread, the single owner of program
  invocations (and of fused-search graph replays).
* Clients submit **population requests** (the ask/tell interface of
  ``search/runner.py`` is already message-shaped: a request is just the
  decoded ``(bounds, rank_ids, arch_params)`` of one generation) and
  block on a future.
* A **cross-request batcher** drains the queue, groups pending requests
  by their target model facade — facades are content-cached, so two
  searches over the same (design, workload, bucket) literally share one
  facade object — and concatenates their candidate axes into ONE
  program invocation per group.  Responses are sliced back out per
  request and the futures resolved.

Multi-tenant accounting rides on :mod:`repro_torch.obs`: every request
lands in per-client ``dse.client.<name>.*`` counters/histograms plus the
service-wide ``dse.*`` metrics, each coalesced batch is a ``dse.batch``
span and each blocking wait a ``dse.request`` span (the engine's own
``engine.compile`` / ``engine.eval`` spans fire inside the batch), so a
``metrics.snapshot()`` or Perfetto trace shows exactly which client paid
for which first call.

Usage::

    from repro_torch.dse import EvaluationService

    with EvaluationService() as svc:
        client = svc.client("island0")
        res = client.evaluate(bm, bounds, rank_ids=ids)   # blocking
        svc.client_metrics("island0")                     # accounting

``search.run_search(..., service=client)`` routes a whole search's
population evaluations through the service;
``repro_torch.dse.run_islands`` is the first real client — N concurrent
island-ES searches sharing one service (and therefore one program, and
one first call per shape, per bucket *total*).

The service runs on the devices its model facades were built for, and
with ``mesh=`` (a ``PopulationMesh`` starting at that device) shards
every coalesced invocation's candidate axis over the mesh.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np

from .. import obs
from ..core.arch import ArchParams, topology_key
from ..obs import metrics


class ServiceClosed(RuntimeError):
    """The service was shut down before (or while) serving a request."""


class _Future:
    """Minimal thread-safe future: one producer, any waiters."""

    __slots__ = ("_event", "_result", "_exception")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exception = None

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        if not self._event.wait(timeout):
            raise TimeoutError("evaluation request timed out")
        if self._exception is not None:
            raise self._exception
        return self._result


@dataclasses.dataclass
class _Request:
    """One client population awaiting evaluation."""

    client: str
    model: object                       # BatchedModel | BucketedModel
    bounds: np.ndarray
    rank_ids: np.ndarray | None        # None for exact-template models
    arch_params: ArchParams | None     # None = the facade's own design
    future: _Future
    t_submit: float

    @property
    def n(self) -> int:
        return len(self.bounds)


@dataclasses.dataclass
class _FusedRequest:
    """One fused-search chunk awaiting its turn on the evaluator thread.

    Fused searches don't decode populations on the host, so there is
    nothing to concatenate — the value of routing them through the
    service is serialization (the warm program caches and a shared
    program's captured graph keep a single user even when island
    searches run fused) and attribution (the chunk lands in the same
    per-client ``dse.*`` accounting as population requests).  ``call``
    is a zero-argument closure over the
    :class:`~repro_torch.search.fused.FusedProgram` and its carry,
    returning ``(carry, ys)``; it runs on the evaluator thread, whose
    current CUDA stream carries the chunk's copies and replays."""

    client: str
    call: object                        # () -> (carry, ys)
    future: _Future
    t_submit: float


def _normalized_rows(ap: ArchParams, n: int) -> tuple:
    """Per-candidate (storage, compute) rows: broadcast an unbatched
    params object so requests with *different* single designs can still
    concatenate into one batched-arch invocation."""
    storage, comp = ap.leaves()
    if not ap.batched:
        storage = np.broadcast_to(storage, (n,) + storage.shape)
        comp = np.broadcast_to(comp, (n,) + comp.shape)
    return np.asarray(storage), np.asarray(comp)


class EvaluationService:
    """Persistent asynchronous evaluator with cross-request batching.

    One background thread owns every program invocation, so the warm
    program caches have a single writer (the caches are additionally
    lock-protected in ``core.batched`` for direct-path users).  Requests
    arriving within ``batch_window_s`` of each other coalesce: pending
    requests are grouped by target facade (same program + same workload
    params) and evaluated as one concatenated population.

    ``mesh`` is owned by the service — clients never shard: every
    coalesced invocation splits its candidate axis over it
    (``evaluate(..., mesh=)``), so the facades' device must be its first.
    ``autostart=False`` skips the background thread (tests and
    benchmarks then call :meth:`drain_once` for deterministic batching).

    ``batch_slots`` is the continuous-batching move from
    ``launch/serve.py`` applied to program shapes: each new input shape
    pays a first call (counted as a compile by ``compile_stats``), so
    variable coalesced batch sizes (whoever happened to land in a
    drain) would each pay one.  With ``batch_slots`` set, every
    invocation is exactly that many candidates — oversize coalitions
    split into windows, short ones pad by repeating their last row (a
    pure re-evaluation, stripped from the results) — so a whole
    multi-tenant run sees ONE shape per program, and "compiles <=
    bucket count" holds no matter how requests interleave.
    """

    def __init__(self, mesh=None, batch_window_s: float = 0.002,
                 batch_slots: int | None = None,
                 max_batch: int = 65536, autostart: bool = True):
        self.mesh = mesh
        self.batch_window_s = float(batch_window_s)
        self.batch_slots = None if batch_slots is None else int(batch_slots)
        if self.batch_slots is not None and self.batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        self.max_batch = int(max_batch)
        self._queue: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._clients: set[str] = set()
        # first-seen labels per (topology key, program kind) — the
        # span/stats view of how many distinct program families the
        # service is batching for (heterogeneous-topology clients land
        # in different groups and still coalesce within their own)
        self._group_ids: dict[tuple, str] = {}
        # service-wide accounting (metrics mirror these for exports)
        self.requests = 0
        self.batches = 0
        self.coalesced_requests = 0
        self.candidates = 0
        self.fused_chunks = 0
        self._thread: threading.Thread | None = None
        if autostart:
            self._thread = threading.Thread(
                target=self._loop, name="dse-evaluator", daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- API
    def client(self, name: str) -> "ServiceClient":
        """A named handle whose requests land in per-client metrics."""
        return ServiceClient(self, name)

    def submit(self, model, bounds, rank_ids=None, arch_params=None,
               client: str = "anon") -> _Future:
        """Enqueue one population; returns a future resolving to the
        ``evaluate``-shaped dict of per-candidate metric arrays."""
        fut = _Future()
        req = _Request(client=client, model=model,
                       bounds=np.asarray(bounds),
                       rank_ids=(None if rank_ids is None
                                 else np.asarray(rank_ids)),
                       arch_params=arch_params, future=fut,
                       t_submit=time.perf_counter())
        with self._cv:
            if self._closed:
                raise ServiceClosed("submit() on a closed service")
            self._queue.append(req)
            self._clients.add(client)
            metrics.gauge("dse.queue_depth").set(len(self._queue))
            self._cv.notify_all()
        return fut

    def evaluate(self, model, bounds, rank_ids=None, arch_params=None,
                 client: str = "anon",
                 timeout: float | None = None) -> dict[str, np.ndarray]:
        """Blocking submit-and-wait (the ``dse.request`` span covers the
        full enqueue -> batched-evaluate -> fan-out latency)."""
        t0 = time.perf_counter()
        with obs.span("dse.request", client=client,
                      candidates=len(bounds)) as sp:
            fut = self.submit(model, bounds, rank_ids=rank_ids,
                              arch_params=arch_params, client=client)
            if self._thread is None:
                self.drain_once()
            res = fut.result(timeout=timeout)
            dt = time.perf_counter() - t0
            sp.set(latency_s=dt)
        metrics.histogram("dse.request_latency_s").observe(dt)
        metrics.histogram(
            f"dse.client.{client}.request_latency_s").observe(dt)
        return res

    def submit_fused(self, call, client: str = "anon") -> _Future:
        """Enqueue one fused chunk (``call() -> (carry, ys)``); returns
        a future resolving to that tuple.  Fused chunks share the queue
        with population requests so the evaluator thread stays the
        single owner of program invocations."""
        fut = _Future()
        req = _FusedRequest(client=client, call=call, future=fut,
                            t_submit=time.perf_counter())
        with self._cv:
            if self._closed:
                raise ServiceClosed("submit_fused() on a closed service")
            self._queue.append(req)
            self._clients.add(client)
            metrics.gauge("dse.queue_depth").set(len(self._queue))
            self._cv.notify_all()
        return fut

    def run_fused(self, call, client: str = "anon",
                  timeout: float | None = None):
        """Blocking :meth:`submit_fused` — the fused analogue of
        :meth:`evaluate`, with the same ``dse.request`` span and
        per-client latency accounting."""
        t0 = time.perf_counter()
        with obs.span("dse.request", client=client, fused=True) as sp:
            fut = self.submit_fused(call, client=client)
            if self._thread is None:
                self.drain_once()
            res = fut.result(timeout=timeout)
            dt = time.perf_counter() - t0
            sp.set(latency_s=dt)
        metrics.histogram("dse.request_latency_s").observe(dt)
        metrics.histogram(
            f"dse.client.{client}.request_latency_s").observe(dt)
        return res

    def client_metrics(self, name: str) -> dict[str, dict]:
        """This client's slice of the metrics registry — the per-tenant
        accounting snapshot (requests, candidates, latency histogram)."""
        prefix = f"dse.client.{name}."
        return {k: v for k, v in metrics.snapshot().items()
                if k.startswith(prefix)}

    def stats(self) -> dict:
        """Service-wide counters (coalescing effectiveness included)."""
        with self._cv:
            return {
                "requests": self.requests,
                "batches": self.batches,
                "coalesced_requests": self.coalesced_requests,
                "candidates": self.candidates,
                "fused_chunks": self.fused_chunks,
                "pending": len(self._queue),
                "groups": len(self._group_ids),
                "clients": sorted(self._clients),
            }

    def close(self, drain: bool = True) -> None:
        """Stop the service.  ``drain=True`` serves everything already
        queued first; ``drain=False`` fails pending futures with
        :class:`ServiceClosed`."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        # whatever the evaluator thread didn't take with it
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
            metrics.gauge("dse.queue_depth").set(0)
        if pending:
            if drain:
                self._serve(pending)
            else:
                for req in pending:
                    req.future.set_exception(
                        ServiceClosed("service closed with the request "
                                      "still queued"))

    def __enter__(self) -> "EvaluationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc[0] is None)

    # ----------------------------------------------------- batching core
    def drain_once(self) -> int:
        """Synchronously serve everything currently queued (one
        cross-request batching pass); returns the number of requests
        served.  The deterministic entry point for ``autostart=False``
        services — tests use it to pin exact coalescing behavior."""
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
            metrics.gauge("dse.queue_depth").set(0)
        if pending:
            self._serve(pending)
        return len(pending)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
            # coalescing window: let concurrently-asking clients land in
            # the same drain so their generations share one invocation
            if self.batch_window_s > 0:
                time.sleep(self.batch_window_s)
            self.drain_once()

    @staticmethod
    def _group_key(req: _Request) -> tuple:
        """Requests coalesce when they target the SAME facade (facades
        are content-cached, so equal (design, workload, bucket) means
        the same object) and agree on arch-params presence: default-arch
        requests concatenate as-is, explicit-arch requests concatenate
        their per-candidate rows."""
        return (id(req.model), req.arch_params is None)

    def _group_label(self, model) -> str:
        """Stable first-seen label ("g0", "g1", ...) for the model's
        topology group — ``(topology key, program kind)``.  Facades for
        the same topology share a label even across distinct bucket
        objects, so spans/stats count *program families*, not cache
        entries.  Facades without a design (test doubles) fall back to
        identity keys."""
        try:
            key = (topology_key(model.design.arch, model.safs),
                   getattr(model, "kind", None))
        except AttributeError:
            key = (id(model),)
        with self._cv:
            label = self._group_ids.get(key)
            if label is None:
                label = f"g{len(self._group_ids)}"
                self._group_ids[key] = label
        return label

    def _serve(self, pending: list[_Request]) -> None:
        fused = [r for r in pending if isinstance(r, _FusedRequest)]
        pending = [r for r in pending if not isinstance(r, _FusedRequest)]
        for req in fused:
            self._serve_fused(req)
        groups: dict[tuple, list[_Request]] = {}
        for req in pending:
            groups.setdefault(self._group_key(req), []).append(req)
        for reqs in groups.values():
            # cap each invocation: oversize coalitions split, preserving
            # request boundaries
            chunk: list[_Request] = []
            size = 0
            for req in reqs:
                if chunk and size + req.n > self.max_batch:
                    self._serve_group(chunk)
                    chunk, size = [], 0
                chunk.append(req)
                size += req.n
            if chunk:
                self._serve_group(chunk)

    @staticmethod
    def _pad_rows(arr: np.ndarray, to: int) -> np.ndarray:
        """Pad the candidate axis up to ``to`` by repeating the last row
        (an inert re-evaluation; results are stripped)."""
        pad = to - len(arr)
        if pad <= 0:
            return arr
        return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])

    def _invoke(self, model, bounds, ids, ap_rows, n_req: int,
                clients: str, group: str) -> dict[str, np.ndarray]:
        """One program invocation over concatenated candidate arrays, in
        fixed ``batch_slots`` windows when configured (every window
        shares ONE shape: short ones pad, long ones split)."""
        total = len(bounds)
        slots = self.batch_slots or total
        parts: list[dict[str, np.ndarray]] = []
        for start in range(0, total, slots):
            stop = min(start + slots, total)
            live = stop - start
            b = self._pad_rows(bounds[start:stop], slots)
            if len(b) > live:
                metrics.counter("dse.padded_candidates").add(
                    len(b) - live)
            ap = None
            if ap_rows is not None:
                storage, comp, structure = ap_rows
                ap = ArchParams(
                    storage=self._pad_rows(storage[start:stop], slots),
                    compute=self._pad_rows(comp[start:stop], slots),
                    structure=structure)
            with obs.span("dse.batch", requests=n_req,
                          candidates=live, padded=len(b) - live,
                          kind=model.kind, group=group,
                          clients=clients):
                if ids is None:
                    res = model.evaluate(b, mesh=self.mesh, arch_params=ap)
                else:
                    res = model.evaluate(
                        b, self._pad_rows(ids[start:stop], slots),
                        mesh=self.mesh, arch_params=ap)
            parts.append({k: v[:live] for k, v in res.items()})
        if len(parts) == 1:
            return parts[0]
        return {k: np.concatenate([p[k] for p in parts])
                for k in parts[0]}

    def _serve_fused(self, req: _FusedRequest) -> None:
        """Execute one fused chunk on the evaluator thread.  Fused
        chunks never coalesce (each owns its carry) — the engine's own
        ``engine.compile`` / ``engine.eval`` spans fire inside."""
        try:
            with obs.span("dse.fused_chunk", client=req.client):
                res = req.call()
        except BaseException as exc:  # noqa: BLE001 — fan the error out
            req.future.set_exception(exc)
            return
        with self._cv:
            self.requests += 1
            self.fused_chunks += 1
        metrics.counter("dse.requests").add(1)
        metrics.counter("dse.fused_chunks").add(1)
        metrics.counter(f"dse.client.{req.client}.requests").add(1)
        metrics.counter(f"dse.client.{req.client}.fused_chunks").add(1)
        req.future.set_result(res)

    def _serve_group(self, reqs: list[_Request]) -> None:
        model = reqs[0].model
        n_req = len(reqs)
        total = sum(r.n for r in reqs)
        try:
            bounds = (reqs[0].bounds if n_req == 1
                      else np.concatenate([r.bounds for r in reqs]))
            ids = None
            if reqs[0].rank_ids is not None:
                ids = (reqs[0].rank_ids if n_req == 1
                       else np.concatenate([r.rank_ids for r in reqs]))
            ap_rows = None
            if reqs[0].arch_params is not None:
                rows = [_normalized_rows(r.arch_params, r.n)
                        for r in reqs]
                ap_rows = (np.concatenate([s for s, _ in rows]),
                           np.concatenate([c for _, c in rows]),
                           reqs[0].arch_params.structure)
            res = self._invoke(
                model, bounds, ids, ap_rows, n_req,
                ",".join(sorted({r.client for r in reqs})),
                self._group_label(model))
        except BaseException as exc:  # noqa: BLE001 — fan the error out
            for req in reqs:
                req.future.set_exception(exc)
            return
        with self._cv:
            self.requests += n_req
            self.batches += 1
            if n_req > 1:
                self.coalesced_requests += n_req
            self.candidates += total
        metrics.counter("dse.requests").add(n_req)
        metrics.counter("dse.batches").add(1)
        metrics.counter("dse.candidates").add(total)
        if n_req > 1:
            metrics.counter("dse.coalesced_requests").add(n_req)
        metrics.histogram("dse.batch_candidates").observe(total)
        offset = 0
        for req in reqs:
            sl = slice(offset, offset + req.n)
            offset += req.n
            metrics.counter(f"dse.client.{req.client}.requests").add(1)
            metrics.counter(
                f"dse.client.{req.client}.candidates").add(req.n)
            req.future.set_result({k: v[sl] for k, v in res.items()})


class ServiceClient:
    """A named client handle: the object ``search.run_search`` (and the
    island search) treat as their evaluator backend.  All requests made
    through it are attributed to ``name`` in the service's per-tenant
    metrics."""

    def __init__(self, service: EvaluationService, name: str):
        self.service = service
        self.name = name

    def evaluate(self, model, bounds, rank_ids=None, arch_params=None,
                 timeout: float | None = None) -> dict[str, np.ndarray]:
        return self.service.evaluate(
            model, bounds, rank_ids=rank_ids, arch_params=arch_params,
            client=self.name, timeout=timeout)

    def run_fused(self, call, timeout: float | None = None):
        """Route one fused chunk (``call() -> (carry, ys)``)
        through the service's evaluator thread."""
        return self.service.run_fused(call, client=self.name,
                                      timeout=timeout)

    def metrics(self) -> dict[str, dict]:
        return self.service.client_metrics(self.name)
