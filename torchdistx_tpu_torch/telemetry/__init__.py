"""Telemetry: spans, counters, gauges, histograms and trace export.

Counterpart of ``torchdistx_tpu.telemetry``: the training loop
(``parallel/fit.py``), checkpoint IO (``utils/checkpoint.py``) and the
resilience package report through it.

Quick start::

    from torchdistx_tpu_torch import telemetry

    telemetry.configure(collect=True)          # in-memory collector
    # ... train ...
    telemetry.snapshot()                       # {"counters", "gauges", "spans"}

    # or from the environment, with a JSON-lines trace file:
    #   TDX_TELEMETRY=/tmp/trace.jsonl python train.py
    # and spans as torch.profiler ranges:
    #   TDX_TELEMETRY_PROFILER=1

Instrumenting your own code::

    with telemetry.span("my.phase", size=n):
        ...
    telemetry.counter("my.events").add()
    telemetry.gauge("my.rate").set(v)
"""

from ._core import (  # noqa: F401
    Histogram,
    Span,
    add_listener,
    on_reset,
    configure,
    counter,
    counters,
    drain,
    emit_counters,
    enabled,
    event,
    events_enabled,
    flight_dump,
    flight_records,
    gauge,
    gauges,
    histogram,
    histograms,
    registry_view,
    remove,
    remove_listener,
    reset,
    snapshot,
    span,
    start_span,
    tracing,
)

__all__ = [
    "Histogram",
    "Span",
    "add_listener",
    "on_reset",
    "configure",
    "counter",
    "counters",
    "drain",
    "emit_counters",
    "enabled",
    "event",
    "events_enabled",
    "flight_dump",
    "flight_records",
    "gauge",
    "gauges",
    "histogram",
    "histograms",
    "registry_view",
    "remove",
    "remove_listener",
    "reset",
    "snapshot",
    "span",
    "start_span",
    "tracing",
]
