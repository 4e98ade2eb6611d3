"""Observability: span tracing + metrics for the flight recorder.

Public surface::

    from repro_torch import obs
    with obs.span("fleet.sweep", configs=10) as sp:
        sp.set(compiles=3)
    obs.enable(chrome="trace.json")   # or REPRO_TRACE=trace.json
    obs.metrics.histogram("serve.request_latency_s").observe(dt)

See :mod:`repro_torch.obs.trace` (tracer, ``REPRO_TRACE`` switch),
:mod:`repro_torch.obs.metrics` (counters/gauges/histograms), and
:mod:`repro_torch.obs.export` (Perfetto export + schema validation).
"""
from . import metrics
from .export import (chrome_trace_events, validate_chrome_trace,
                     validate_chrome_trace_file, write_chrome_trace)
from .trace import (TRACE_ENV, JsonlSink, Span, Tracer, configure_from_env,
                    disable, enable, enabled, span, tracer)

__all__ = [
    "TRACE_ENV", "JsonlSink", "Span", "Tracer", "chrome_trace_events",
    "configure_from_env", "disable", "enable", "enabled", "metrics",
    "span", "tracer", "validate_chrome_trace",
    "validate_chrome_trace_file", "write_chrome_trace",
]
