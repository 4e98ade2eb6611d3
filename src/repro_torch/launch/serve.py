"""Batched serving driver: prefill + decode with continuous batching.

A fixed pool of batch slots runs greedy/temperature decoding; when a slot
finishes (max length), the next queued request is admitted into that
slot by prefilling it and splicing its cache (KV, or recurrent states)
into the pool along each leaf's batch axis.  This is the standard
continuous-batching loop; it runs on the CUDA card (prefill attention
through the flash-attention kernel K4) or, when asked, on the CPU.

The loop itself is :class:`ServeLoop`, a submit/cancel/shutdown object
that tests drive step by step under concurrent clients (queue-depth
gauge, request-latency histogram, mid-batch cancellation, draining
shutdown); ``main()`` is a thin CLI over it.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \
      --reduced --device cpu --requests 8 --batch 4 --prompt-len 16 \
      --gen 24
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import obs
from ..configs import ARCH_NAMES, get_config
from ..core.device import resolve_device
from ..models import get_api
from ..obs import metrics


def _splice_cache(pool, single, slot: int, axes):
    """Write ``single``'s batch-1 cache into batch slot ``slot`` of
    ``pool``, IN PLACE, and return ``pool``.  Both are nested tuples of
    tensors; ``axes`` (``ModelApi.batch_axes``), a tree of the same
    shape, gives each leaf's batch axis: axis 1 for caches stacked over
    layers, axis 2 for the hybrid's Mamba states (stacked over
    super-blocks and the layers inside one)."""
    if isinstance(pool, torch.Tensor):
        pool.select(axes, slot).copy_(single.select(axes, 0))
        return pool
    for p, s, a in zip(pool, single, axes, strict=True):
        _splice_cache(p, s, slot, a)
    return pool


class ServeLoop:
    """Continuous-batching decode loop with explicit request lifecycle.

    ``submit`` enqueues a prompt, ``start`` prefills the first wave,
    each ``step`` runs one decode over the slot pool (completing slots
    refill from the queue), ``cancel`` removes a request whether it is
    still queued or already decoding mid-batch (its slot frees at the
    next step, no latency is recorded), and ``shutdown`` closes
    admissions: ``drain=True`` finishes the in-flight slots first,
    ``drain=False`` abandons them.  Per-request latency (enqueue ->
    last token) lands in the ``serve.request_latency_s`` histogram,
    queue depth in the ``serve.queue_depth`` gauge, generated tokens in
    the ``serve.tokens`` counter; prefills and decode steps are the
    ``serve.prefill`` and ``serve.decode_step`` spans.

    ``params`` is the model (``api.init``), moved to ``device`` (None:
    the CUDA card; the CPU only when asked for).  Greedy decoding takes
    the first maximum, as ``jnp.argmax``; temperature sampling draws
    from a ``torch.Generator`` seeded with ``seed``: the same seed gives
    the same outputs (not ``jax.random``'s).  ``prefills`` counts the
    prefill calls (the first wave and every refill).
    """

    def __init__(self, api, cfg, params, *, batch: int, prompt_len: int,
                 gen: int, temperature: float = 0.0, seed: int = 0,
                 device=None):
        if cfg.enc_dec:
            raise ValueError("ServeLoop drives decoder-only archs")
        self.device = resolve_device(device)
        self.api, self.cfg = api, cfg
        self.params = params.to(self.device)
        self.batch = int(batch)
        self.prompt_len = int(prompt_len)
        self.gen = int(gen)
        self.temperature = float(temperature)
        self.S_max = self.prompt_len + self.gen + 1
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._lat = metrics.histogram("serve.request_latency_s")
        self._depth = metrics.gauge("serve.queue_depth")
        self._tokens = metrics.counter("serve.tokens")
        self._queue: list[int] = []
        self._prompts: dict[int, np.ndarray] = {}
        self._t_submit: dict[int, float] = {}
        self._cancelled: set[int] = set()
        self.outputs: dict[int, list[int]] = {}
        self.latencies: list[float] = []
        self.served = 0
        self.decode_steps = 0
        self.prefills = 0
        self._closed = False
        self._cache = None
        self._tok = None
        self._slot_req: list[int | None] = []
        self._slot_len: list[int] = []
        self._pos = np.zeros(0, np.int32)
        self._t0 = self._t_last = time.perf_counter()

    def _prefill(self, tokens: np.ndarray):
        self.prefills += 1
        return self.api.prefill(self.params,
                                torch.as_tensor(tokens, device=self.device),
                                self.cfg, self.S_max)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ----------------------------------------------------- client API
    def submit(self, rid: int, prompt) -> None:
        """Enqueue one request (a (prompt_len,) token array)."""
        if self._closed:
            raise RuntimeError("submit() on a shut-down ServeLoop")
        if rid in self._prompts:
            raise ValueError(f"duplicate request id {rid}")
        self._prompts[rid] = np.asarray(prompt, np.int32)
        self._t_submit[rid] = time.perf_counter()
        self.outputs[rid] = []
        self._queue.append(rid)
        self._depth.set(len(self._queue))

    def cancel(self, rid: int) -> bool:
        """Drop a request.  Queued: removed immediately.  Decoding: its
        slot frees (and refills) at the next step, with no latency
        observation.  Returns False when unknown or already finished."""
        if rid in self._queue:
            self._queue.remove(rid)
            self._depth.set(len(self._queue))
            self._cancelled.add(rid)
            return True
        if rid in self._slot_req:
            self._cancelled.add(rid)
            return True
        return False

    @property
    def active(self) -> int:
        """Requests currently holding a decode slot."""
        return sum(r is not None for r in self._slot_req)

    @property
    def pending(self) -> int:
        """Requests queued but not yet admitted to a slot."""
        return len(self._queue)

    # ------------------------------------------------------- the loop
    def start(self) -> None:
        """Prefill the first wave (up to ``batch`` queued requests)."""
        if self._cache is not None or not self._queue:
            return
        active = self._queue[:self.batch]
        del self._queue[:len(active)]
        self._depth.set(len(self._queue))
        self._t0 = self._t_last = time.perf_counter()
        batch = np.stack([self._prompts[r] for r in active])
        with obs.span("serve.prefill", requests=len(active)):
            logits, self._cache = self._prefill(batch)
            self._sync()
        self._tok = torch.argmax(logits[:, -1, :], -1)[:, None]
        self._slot_req = list(active)
        self._slot_len = [0] * len(active)
        self._pos = np.full(len(active), self.prompt_len, np.int32)

    def _sample(self, logits) -> np.ndarray:
        last = logits[:, -1, :].float()
        if self.temperature > 0:
            probs = torch.softmax(last / self.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            nxt = torch.argmax(last, -1)
        return nxt.to(torch.int32).cpu().numpy()

    def _finish_slot(self, b: int, tok_np: np.ndarray,
                     served: bool) -> None:
        rid = self._slot_req[b]
        if served:
            self.served += 1
            lat_s = time.perf_counter() - self._t_submit[rid]
            self._lat.observe(lat_s)
            self.latencies.append(lat_s)
        if self._queue and not self._closed:
            r2 = self._queue.pop(0)        # continuous batching: refill
            self._depth.set(len(self._queue))
            with obs.span("serve.prefill", requests=1, refill=True,
                          slot=b):
                lg, c1 = self._prefill(self._prompts[r2][None, :])
            self._cache = _splice_cache(self._cache, c1, b,
                                        self.api.batch_axes)
            tok_np[b] = int(torch.argmax(lg[0, -1]).item())
            self._slot_req[b] = r2
            self._slot_len[b] = 0
            self._pos[b] = self.prompt_len
        else:
            self._slot_req[b] = None

    def step(self) -> bool:
        """One decode step over the slot pool; False when idle (nothing
        admitted, every slot free, or the cache axis is exhausted)."""
        if self._cache is None and self._queue and not self._closed:
            self.start()
        if self._cache is None or self.active == 0:
            return False
        if not (self._pos < self.S_max - 1).any():
            return False
        with obs.span("serve.decode_step", step=self.decode_steps):
            logits, self._cache = self.api.decode_step(
                self.params, self._tok, self._cache,
                torch.as_tensor(self._pos, device=self.device), self.cfg)
        self.decode_steps += 1
        nxt = self._sample(logits)
        self._pos = np.minimum(self._pos + 1, self.S_max - 1)
        tok_np = nxt.copy()
        for b in range(len(self._slot_req)):
            r = self._slot_req[b]
            if r is None:
                continue
            if r in self._cancelled:       # freed mid-batch, no latency
                self._finish_slot(b, tok_np, served=False)
                continue
            self.outputs[r].append(int(nxt[b]))
            self._tokens.add(1)
            self._slot_len[b] += 1
            if self._slot_len[b] >= self.gen:
                self._finish_slot(b, tok_np, served=True)
        self._tok = torch.as_tensor(tok_np, device=self.device)[:, None]
        self._t_last = time.perf_counter()
        return self.active > 0 or (bool(self._queue)
                                   and not self._closed)

    def drain(self) -> None:
        while self.step():
            pass

    def shutdown(self, drain: bool = True) -> None:
        """Close admissions.  ``drain=True`` finishes the in-flight
        slots (queued-but-unstarted requests stay unserved);
        ``drain=False`` abandons the in-flight slots too."""
        self._closed = True
        if drain:
            self.drain()
        else:
            self._slot_req = [None] * len(self._slot_req)

    # --------------------------------------------------------- results
    def result(self) -> dict:
        dt = max(1e-9, self._t_last - self._t0)
        tput = sum(len(v) for v in self.outputs.values()) / dt
        return {
            "outputs": self.outputs,
            "tokens_per_s": tput,
            "latency_s": {
                "count": len(self.latencies),
                "mean_s": (sum(self.latencies) / len(self.latencies)
                           if self.latencies else 0.0),
                "max_s": max(self.latencies, default=0.0),
                "p50_s": self._lat.percentile(50),
                "p99_s": self._lat.percentile(99),
            },
        }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen2-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; pass cpu "
                         "to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.enc_dec:
        raise SystemExit("serve drives decoder-only archs; whisper is "
                         "exercised via tests/examples")
    device = resolve_device(args.device)
    api = get_api(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(cfg, gen, device)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(args.requests, args.prompt_len)
                           ).astype(np.int32)

    loop = ServeLoop(api, cfg, params, batch=args.batch,
                     prompt_len=args.prompt_len, gen=args.gen,
                     temperature=args.temperature, seed=args.seed,
                     device=device)
    for r in range(args.requests):
        loop.submit(r, prompts[r])
    loop.start()
    loop.drain()

    res = loop.result()
    lat = res["latency_s"]
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"[serve] {cfg.name} on {where}: {args.requests} requests, "
          f"{loop.decode_steps} decode steps, {loop.prefills} prefills, "
          f"{res['tokens_per_s']:.1f} tok/s; latency mean "
          f"{lat['mean_s'] * 1e3:.0f} ms p99<={lat['p99_s'] * 1e3:.0f} ms, "
          f"peak queue depth {metrics.gauge('serve.queue_depth').max:.0f}")
    return res


if __name__ == "__main__":
    main()
