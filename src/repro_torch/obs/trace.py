"""Flight-recorder span tracer: nested, thread-safe, near-no-op when off.

The paper's headline claim is modeling *speed*; this module is how the
repo measures where its own wall-clock goes.  A span is a named interval
on the monotonic clock with arbitrary key/value attributes::

    from repro_torch import obs
    with obs.span("fleet.sweep", configs=10, options=3) as sp:
        ...
        sp.set(compiles=3)          # attach results before the span ends

Spans nest: each thread keeps its own span stack (``threading.local``),
so concurrent serving/search threads never interleave their depths.
Durations come from ``time.perf_counter()`` relative to the tracer's
epoch, so all spans of a process share one timebase and the Chrome-trace
export (:mod:`repro_torch.obs.export`) is directly Perfetto-loadable.

Sinks
-----
* **in-memory** — every finished span lands in ``Tracer.spans`` (tests
  and the trace-smoke read this);
* **JSONL** — ``enable(jsonl=path)`` appends one JSON object per span as
  it finishes (crash-robust event log);
* **Chrome trace** — ``enable(chrome=path)`` writes a Perfetto
  ``trace.json`` when tracing is disabled or the process exits.

Disabled-by-default switch
--------------------------
Tracing is OFF unless enabled in code or via ``REPRO_TRACE``:

* unset / ``0`` / ``off`` — disabled; ``span()`` returns a shared no-op
  context manager (no allocation, no clock read — the near-no-op path);
* ``1`` / ``mem`` — in-memory tracing;
* ``<path>.jsonl`` — in-memory + JSONL event log at that path;
* ``<path>.json`` — in-memory + Chrome trace written there at exit.

The environment is read once at import (``configure_from_env``), so
``REPRO_TRACE=trace.json python -m repro_torch.launch.hillclimb
--device cpu`` writes a search's spans with no code change.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import os
import threading
import time
import warnings

#: the environment variable that switches tracing on
TRACE_ENV = "REPRO_TRACE"

_OFF_WORDS = frozenset({"", "0", "false", "no", "off"})
_MEM_WORDS = frozenset({"1", "true", "yes", "on", "mem", "memory"})


def jsonable(value):
    """Best-effort conversion of span attributes to JSON-serializable
    values (tuples -> lists, numpy scalars -> Python, anything else ->
    ``str``)."""
    if isinstance(value, (str, bool, int, float)) or value is None:
        return value
    if isinstance(value, dict):
        return {str(k): jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple, set, frozenset)):
        return [jsonable(v) for v in value]
    item = getattr(value, "item", None)     # numpy scalars
    if callable(item):
        try:
            return jsonable(item())
        except (TypeError, ValueError):
            pass
    return str(value)


@dataclasses.dataclass
class Span:
    """One finished span: a named interval on the tracer's timebase."""

    name: str
    t_start: float          # seconds since the tracer epoch (monotonic)
    t_end: float
    tid: int                # OS thread ident
    depth: int              # nesting depth on its thread's span stack
    attrs: dict

    @property
    def dur(self) -> float:
        return self.t_end - self.t_start


class _SpanHandle:
    """What ``with span(...) as sp`` yields: lets the body attach result
    attributes before the span is recorded."""

    __slots__ = ("attrs",)

    def __init__(self, attrs: dict):
        self.attrs = attrs

    def set(self, **kw) -> None:
        self.attrs.update(kw)


class _NullHandle:
    __slots__ = ()

    def set(self, **kw) -> None:
        pass


class _NullSpan:
    """Shared no-op context manager — the disabled-tracer fast path
    (no allocation, no clock read)."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_HANDLE

    def __exit__(self, *exc):
        return False


_NULL_HANDLE = _NullHandle()
_NULL_SPAN = _NullSpan()


class JsonlSink:
    """Append-only JSONL event log: one object per finished span."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        self._f = open(self.path, "a")

    def emit(self, span: Span) -> None:
        line = json.dumps(
            {"name": span.name, "ts": span.t_start, "dur": span.dur,
             "tid": span.tid, "depth": span.depth,
             "attrs": jsonable(span.attrs)}, sort_keys=True)
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()


class Tracer:
    """Span collector: per-thread stacks, one shared finished-span list."""

    def __init__(self, sinks=()):
        self.epoch = time.perf_counter()
        self.spans: list[Span] = []
        self.sinks = list(sinks)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        stack = self._stack()
        depth = len(stack)
        stack.append(name)
        handle = _SpanHandle(attrs)
        t0 = time.perf_counter() - self.epoch
        try:
            yield handle
        finally:
            t1 = time.perf_counter() - self.epoch
            stack.pop()
            rec = Span(name=name, t_start=t0, t_end=t1,
                       tid=threading.get_ident(), depth=depth,
                       attrs=handle.attrs)
            with self._lock:
                self.spans.append(rec)
            for sink in self.sinks:
                sink.emit(rec)

    def find(self, name: str) -> list[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def total(self, name: str) -> float:
        """Summed duration (seconds) of all spans with ``name``."""
        return sum(s.dur for s in self.find(name))


# ----------------------------------------------------------------------
# module-global switch
# ----------------------------------------------------------------------

_LOCK = threading.Lock()
_TRACER: Tracer | None = None
_JSONL: JsonlSink | None = None
_CHROME_PATH: str | None = None


def enabled() -> bool:
    return _TRACER is not None


def tracer() -> Tracer | None:
    """The active tracer, or None when tracing is disabled."""
    return _TRACER


def span(name: str, **attrs):
    """Context manager recording one span under the active tracer; a
    shared no-op when tracing is disabled (the hot-path entry point —
    keep the disabled branch first)."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def enable(*, jsonl: str | None = None,
           chrome: str | None = None) -> Tracer:
    """Switch tracing on (in-memory always; plus the optional sinks).
    Replaces any previously active tracer (its pending Chrome export is
    flushed first)."""
    global _TRACER, _JSONL, _CHROME_PATH
    disable()
    with _LOCK:
        sinks = []
        if jsonl:
            _JSONL = JsonlSink(jsonl)
            sinks.append(_JSONL)
        _TRACER = Tracer(sinks)
        _CHROME_PATH = chrome
        return _TRACER


def disable() -> None:
    """Switch tracing off; flushes the pending Chrome export (if one was
    requested) and closes the JSONL sink."""
    global _TRACER, _JSONL, _CHROME_PATH
    with _LOCK:
        if _TRACER is not None and _CHROME_PATH:
            from .export import write_chrome_trace
            write_chrome_trace(_CHROME_PATH, _TRACER.spans)
        if _JSONL is not None:
            _JSONL.close()
        _TRACER = None
        _JSONL = None
        _CHROME_PATH = None


def configure_from_env(env=None) -> Tracer | None:
    """Apply the ``REPRO_TRACE`` switch (see module docstring).  Returns
    the tracer, or None when the value keeps tracing disabled."""
    raw = (os.environ if env is None else env).get(TRACE_ENV, "")
    word = raw.strip()
    low = word.lower()
    if low in _OFF_WORDS:
        disable()
        return None
    if low in _MEM_WORDS:
        return enable()
    if low.endswith(".jsonl"):
        return enable(jsonl=word)
    if low.endswith(".json"):
        return enable(chrome=word)
    warnings.warn(
        f"{TRACE_ENV}={raw!r} not recognized (use 1/mem, a .jsonl path, "
        f"or a .json path); enabling in-memory tracing", stacklevel=2)
    return enable()


# flush the Chrome export on interpreter exit so `REPRO_TRACE=out.json`
# needs no explicit shutdown call
atexit.register(disable)
configure_from_env()
