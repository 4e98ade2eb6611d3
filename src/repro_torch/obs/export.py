"""Chrome-trace (Perfetto) export + schema validation for span traces.

``write_chrome_trace`` turns a list of :class:`repro_torch.obs.trace.Span`
into the Chrome trace-event JSON format — open the file at
https://ui.perfetto.dev (or chrome://tracing) to see the flight
recording: one track per thread, compile spans next to eval spans,
attributes in the args pane.

``validate_chrome_trace`` is the small schema check CI runs on the
emitted artifact: required keys, non-negative monotone timestamps, and
*balanced* spans — on each thread track, complete events must nest
properly (a span either contains or is disjoint from every other; a
partial overlap means the recorder's stack discipline broke).
"""
from __future__ import annotations

import json
import os

from .trace import Span, jsonable

#: slack (µs) for containment checks: ts/dur are rounded to 3 decimals,
#: so parent/child edges can disagree by a few nanoseconds
_EPS_US = 0.01


def chrome_trace_events(spans: list[Span],
                        metrics_snapshot: dict | None = None
                        ) -> list[dict]:
    """Spans -> Chrome trace events ("X" complete events, µs timebase),
    plus thread-name metadata and an optional final metrics snapshot."""
    tid_of: dict[int, int] = {}
    for s in spans:
        tid_of.setdefault(s.tid, len(tid_of))
    events = []
    for s in spans:
        events.append({
            "name": s.name, "cat": "repro", "ph": "X",
            "ts": round(s.t_start * 1e6, 3),
            "dur": round(max(0.0, s.dur) * 1e6, 3),
            "pid": 0, "tid": tid_of[s.tid],
            "args": jsonable(s.attrs),
        })
    for raw, tid in tid_of.items():
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": f"thread-{raw}"}})
    if metrics_snapshot:
        t_end = max((e["ts"] + e["dur"] for e in events
                     if e.get("ph") == "X"), default=0.0)
        events.append({"name": "metrics", "ph": "i", "s": "g",
                       "ts": t_end, "pid": 0, "tid": 0,
                       "args": jsonable(metrics_snapshot)})
    return events


def write_chrome_trace(path: str, spans: list[Span],
                       metrics_snapshot: dict | None = None) -> str:
    """Write a Perfetto-loadable ``trace.json`` (atomic: tmp +
    ``os.replace``).  Returns the path."""
    path = os.fspath(path)
    obj = {"traceEvents": chrome_trace_events(spans, metrics_snapshot),
           "displayTimeUnit": "ms"}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


def validate_chrome_trace(obj: dict) -> list[str]:
    """Error messages for a Chrome-trace JSON object; empty when valid.

    Checks the bench-smoke schema contract: a non-empty ``traceEvents``
    list, every complete event carrying name/ts/dur/pid/tid with
    non-negative finite timestamps, and per-thread *balance* — sorted by
    start time, complete events must properly nest (partial overlap on
    one track means unbalanced enter/exit)."""
    errors: list[str] = []
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing, not a list, or empty"]
    complete: dict[object, list[tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict) or "ph" not in ev:
            errors.append(f"event {i}: not an object with 'ph'")
            continue
        if ev["ph"] != "X":
            continue
        missing = [k for k in ("name", "ts", "dur", "pid", "tid")
                   if k not in ev]
        if missing:
            errors.append(f"event {i}: missing keys {missing}")
            continue
        ts, dur = ev["ts"], ev["dur"]
        if not (isinstance(ts, (int, float)) and ts >= 0):
            errors.append(f"event {i} ({ev['name']}): bad ts {ts!r}")
            continue
        if not (isinstance(dur, (int, float)) and dur >= 0):
            errors.append(f"event {i} ({ev['name']}): bad dur {dur!r}")
            continue
        complete.setdefault((ev["pid"], ev["tid"]), []).append(
            (float(ts), float(ts) + float(dur), str(ev["name"])))
    if not complete and not errors:
        errors.append("no complete ('X') events in traceEvents")
    for track, evs in complete.items():
        # longest-first at equal start so a parent precedes its children
        evs.sort(key=lambda e: (e[0], -(e[1] - e[0])))
        stack: list[tuple[float, float, str]] = []
        prev_ts = -1.0
        for ts, end, name in evs:
            if ts < prev_ts:            # sort invariant, belt-and-braces
                errors.append(f"track {track}: non-monotone ts at {name}")
            prev_ts = ts
            while stack and stack[-1][1] <= ts + _EPS_US:
                stack.pop()
            if stack and end > stack[-1][1] + _EPS_US:
                errors.append(
                    f"track {track}: span {name!r} [{ts}, {end}] "
                    f"partially overlaps enclosing {stack[-1][2]!r} "
                    f"[{stack[-1][0]}, {stack[-1][1]}] — unbalanced")
                continue
            stack.append((ts, end, name))
    return errors


def validate_chrome_trace_file(path: str) -> list[str]:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot read {path}: {e}"]
    return validate_chrome_trace(obj)
