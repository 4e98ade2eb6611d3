"""Fault-tolerance primitives for the training runtime (the JAX
package's ``runtime/fault_tolerance.py``; ``StragglerWatchdog`` and
``Heartbeat`` are copies).

At 1000+ nodes the failure model is: slow hosts (stragglers), dead hosts
(preemption/hardware), and partial restarts with a different device
count.  The pieces here:

  * StragglerWatchdog — per-step wall-time EMA + deviation tracking;
    flags steps slower than `threshold x` the trailing mean.  On a real
    cluster the flag feeds the controller that evicts/replaces the slow
    host; here it logs and counts (hook injectable).
  * Heartbeat — background thread touching a liveness file every few
    seconds; an external supervisor (or test) detects missed beats.
  * elastic_mesh — in the reference, the best (data, model) mesh over
    the devices currently alive.  The port runs on one card and has no
    mesh yet (ROADMAP item 6): it raises.
"""
from __future__ import annotations

import pathlib
import threading
import time
from typing import Callable


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.0, warmup: int = 3,
                 on_straggle: Callable[[int, float, float], None] | None
                 = None):
        self.threshold = threshold
        self.warmup = warmup
        self.on_straggle = on_straggle
        self.ema = None
        self.steps = 0
        self.straggles: list[tuple[int, float]] = []
        self._t0 = None

    def start_step(self):
        self._t0 = time.perf_counter()

    def end_step(self) -> float:
        dt = time.perf_counter() - self._t0
        self.steps += 1
        if self.ema is None:
            self.ema = dt
        if self.steps > self.warmup and dt > self.threshold * self.ema:
            self.straggles.append((self.steps, dt))
            if self.on_straggle:
                self.on_straggle(self.steps, dt, self.ema)
        # EMA update after the check so one outlier doesn't mask the next
        self.ema = 0.9 * self.ema + 0.1 * dt
        return dt


class Heartbeat:
    def __init__(self, path: str | pathlib.Path, interval_s: float = 5.0):
        self.path = pathlib.Path(path)
        self.interval = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _beat_once(self) -> None:
        # write-to-temp + rename so a concurrent age() never reads a
        # half-written (empty) file
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        tmp.write_text(str(time.time()))
        tmp.replace(self.path)

    def __enter__(self):
        self.path.parent.mkdir(parents=True, exist_ok=True)

        def beat():
            while not self._stop.wait(self.interval):
                self._beat_once()

        self._beat_once()
        self._thread = threading.Thread(target=beat, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)

    def age(self) -> float:
        return time.time() - float(self.path.read_text())


def elastic_mesh(prefer_model: int = 4):
    """Best-effort (data, model) mesh over the devices currently alive:
    not ported (mesh sharding is ROADMAP Queue 1 item 6); raises."""
    raise NotImplementedError("elastic_mesh: mesh sharding is not ported "
                              "yet (ROADMAP Queue 1 item 6)")
