"""ray_lightning_tpu_torch.obs — the serving path's observability (PyTorch
port of the stdlib-only half of ``ray_lightning_tpu/obs``).

- :mod:`obs.trace` — request tracing: typed lifecycle spans in a bounded
  ring (:class:`RequestTracer`), exported as Chrome trace-event JSON
  (:func:`to_chrome_trace`, :func:`merge_chrome_trace`).
- :mod:`obs.events` — the structured event log (:class:`EventLog`,
  :func:`get_event_log`).
- :mod:`obs.registry` — counter/gauge/histogram registry
  (:class:`MetricsRegistry`, :func:`get_registry`) rendered as Prometheus
  text.
- :mod:`obs.anatomy` — the per-request phase ledger
  (:func:`assemble_anatomy`, :func:`render_anatomy`) with its coverage
  contract: phases plus unaccounted equal the observed latency.
- :mod:`obs.journal` — deterministic capture and replay
  (:class:`WorkloadJournal`, :func:`load_journal`,
  :func:`replay_journal`).

Every module here is stdlib-only; none imports torch at import time.
"""
from ray_lightning_tpu_torch.obs.anatomy import (
    aggregate_phases,
    assemble_anatomy,
    breach_attribution,
    format_attribution,
    ledger_from_phase_map,
    render_anatomy,
)
from ray_lightning_tpu_torch.obs.events import EventLog, get_event_log
from ray_lightning_tpu_torch.obs.journal import (
    WorkloadJournal,
    engine_header,
    load_journal,
    replay_journal,
)
from ray_lightning_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    parse_prometheus_text,
)
from ray_lightning_tpu_torch.obs.trace import (
    RequestTracer,
    merge_chrome_trace,
    to_chrome_trace,
)

__all__ = [
    "Counter",
    "EventLog",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "RequestTracer",
    "WorkloadJournal",
    "aggregate_phases",
    "assemble_anatomy",
    "breach_attribution",
    "engine_header",
    "format_attribution",
    "get_event_log",
    "get_registry",
    "ledger_from_phase_map",
    "load_journal",
    "merge_chrome_trace",
    "parse_prometheus_text",
    "render_anatomy",
    "replay_journal",
    "to_chrome_trace",
]
