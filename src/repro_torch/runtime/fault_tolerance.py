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
  * elastic_mesh — the best (data, model) ``DeviceMesh`` over the ranks
    currently alive (one card: (1, 1)).
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


def elastic_mesh(prefer_model: int = 4, device_type: str = "cuda"):
    """Best-effort (data, model) ``DeviceMesh`` over the ranks currently
    alive: the model axis is the largest size up to ``prefer_model``
    that divides their count.  Initialises a process group where none is
    (``launch.mesh.init_local_process_group``: the ``torchrun``
    environment, else this process alone, so one card gives (1, 1))."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..launch.mesh import init_local_process_group
    init_local_process_group(device_type)
    n = dist.get_world_size()
    model = next(m for m in range(min(prefer_model, n), 0, -1) if n % m == 0)
    return init_device_mesh(device_type, (n // model, model),
                            mesh_dim_names=("data", "model"))
