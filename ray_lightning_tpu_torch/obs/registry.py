"""Counter/gauge/histogram registry with Prometheus text rendering.

The PyTorch port keeps its own copy of ``ray_lightning_tpu/obs/registry.py``
(stdlib only); the port's serving metrics and engine record into it.

The metrics half of the observability layer (obs/trace.py is the tracing
half): serve, trainer, and fabric code record into a
:class:`MetricsRegistry`, and any surface that wants the numbers renders
them — the ``rlt serve --serve.metrics_port`` HTTP endpoint and
``ServeReplica.metrics_text()`` ship the Prometheus text exposition
format; ``stats()`` embeds :meth:`MetricsRegistry.to_dict`.

Design constraints (why not prometheus_client):

- zero dependencies — the container only has what it has;
- recording must be cheap enough for the serve hot loop (a dict update
  under one lock, no string formatting until render time);
- one process-global default registry (:func:`get_registry`), because
  the scrape surface is per-process (each replica actor renders its own
  registry; the driver renders its own and concatenates).

Label support is deliberately minimal: labels are passed as kwargs at
record time and become part of the sample key. Series are born on first
touch, exactly like Prometheus client libraries.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: Default histogram buckets: latency-flavored, seconds.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

_RESERVED = {"le"}


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


class _Metric:
    """Shared sample-map plumbing; subclasses define semantics."""

    kind = "untyped"

    def __init__(self, name: str, help_: str, lock: threading.Lock) -> None:
        self.name = name
        self.help = help_
        self._lock = lock
        #: label-key tuple -> float (counters/gauges)
        self._samples: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def _check_labels(self, labels: Dict[str, Any]) -> None:
        bad = _RESERVED.intersection(labels)
        if bad:
            raise ValueError(f"reserved label name(s) {sorted(bad)}")

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._samples.get(_label_key(labels), 0.0)

    def samples(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        with self._lock:
            return dict(self._samples)

    def remove(self, **labels: Any) -> bool:
        """Drop one labelled series (e.g. a dead worker's gauges) so a
        scrape stops reporting stale values forever; returns whether the
        series existed. Series re-appear on the next record, exactly
        like first touch."""
        key = _label_key(labels)
        with self._lock:
            return self._samples.pop(key, None) is not None

    def render(self) -> List[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for key, val in sorted(self.samples().items()):
            out.append(f"{self.name}{_fmt_labels(key)} {_fmt_value(val)}")
        return out


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self._check_labels(labels)
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        self._check_labels(labels)
        with self._lock:
            self._samples[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        self._check_labels(labels)
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + amount


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_: str,
        lock: threading.Lock,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help_, lock)
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("need at least one bucket bound")
        self.buckets = tuple(bs)
        #: label-key -> [per-bucket counts..., +Inf count]; _samples holds
        #: the sums, _counts the observation counts.
        self._bucket_counts: Dict[Tuple[Tuple[str, str], ...], List[int]] = {}
        self._counts: Dict[Tuple[Tuple[str, str], ...], int] = {}

    def observe(self, value: float, **labels: Any) -> None:
        self._check_labels(labels)
        v = float(value)
        key = _label_key(labels)
        with self._lock:
            counts = self._bucket_counts.get(key)
            if counts is None:
                counts = self._bucket_counts[key] = [0] * (
                    len(self.buckets) + 1
                )
            # Non-cumulative per-bucket tallies; cumulated at render time
            # so the hot path is one index bump.
            for i, b in enumerate(self.buckets):
                if v <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._samples[key] = self._samples.get(key, 0.0) + v
            self._counts[key] = self._counts.get(key, 0) + 1

    def count(self, **labels: Any) -> int:
        with self._lock:
            return self._counts.get(_label_key(labels), 0)

    def remove(self, **labels: Any) -> bool:
        key = _label_key(labels)
        with self._lock:
            found = self._bucket_counts.pop(key, None) is not None
            self._samples.pop(key, None)
            self._counts.pop(key, None)
            return found

    def render(self) -> List[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        with self._lock:
            items = sorted(self._bucket_counts.items())
            sums = dict(self._samples)
            counts = dict(self._counts)
        for key, per_bucket in items:
            cum = 0
            for bound, n in zip(self.buckets, per_bucket):
                cum += n
                le = _fmt_labels(key, f'le="{_fmt_value(bound)}"')
                out.append(f"{self.name}_bucket{le} {cum}")
            cum += per_bucket[-1]
            le = _fmt_labels(key, 'le="+Inf"')
            out.append(f"{self.name}_bucket{le} {cum}")
            out.append(
                f"{self.name}_sum{_fmt_labels(key)} "
                f"{_fmt_value(sums.get(key, 0.0))}"
            )
            out.append(
                f"{self.name}_count{_fmt_labels(key)} {counts.get(key, 0)}"
            )
        return out


class MetricsRegistry:
    """Thread-safe named-metric registry.

    Registration is idempotent: asking for an existing name returns the
    existing metric (and raises if the kind differs), so independent
    subsystems can declare the metrics they feed without coordinating.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_make(self, cls: type, name: str, help_: str, **kw: Any):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                    )
                return m
            # Metrics share the registry lock: recording is a dict update
            # under one uncontended-in-practice lock, cheap enough for the
            # serve hot loop.
            m = cls(name, help_, self._lock, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help_)

    def histogram(
        self,
        name: str,
        help_: str = "",
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_make(Histogram, name, help_, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def render(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> Dict[str, Any]:
        """Plain-dict snapshot for JSON surfaces (stats endpoints).

        Labelled series render as ``{label=\"v\"}`` suffixed keys;
        histograms export count/sum only (buckets are a scrape-format
        concern).
        """
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        out: Dict[str, Any] = {}
        for m in metrics:
            if isinstance(m, Histogram):
                for key in m.samples():
                    sfx = _fmt_labels(key)
                    out[f"{m.name}_count{sfx}"] = m.count(
                        **{k: v for k, v in key}
                    )
                    out[f"{m.name}_sum{sfx}"] = m.samples()[key]
            else:
                for key, val in m.samples().items():
                    out[f"{m.name}{_fmt_labels(key)}"] = val
        return out


def relabel_text(text: str, **labels: Any) -> str:
    """Inject extra labels into every sample line of rendered exposition
    text (comments pass through). Used when aggregating several
    processes' registries into one scrape — e.g. per-replica sections
    become ``replica="0"``-labelled series instead of duplicates."""
    if not labels:
        return text
    extra = ",".join(f'{k}="{_escape(str(v))}"' for k, v in sorted(labels.items()))
    out: List[str] = []
    for line in text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            out.append(line)
            continue
        name_part, sep, val_part = stripped.rpartition(" ")
        if not sep:
            out.append(line)
            continue
        if name_part.endswith("}"):
            body = name_part[:-1]
            joiner = "," if not body.endswith("{") else ""
            out.append(f"{body}{joiner}{extra}}} {val_part}")
        else:
            out.append(f"{name_part}{{{extra}}} {val_part}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def parse_prometheus_text(text: str) -> Dict[str, Dict[str, float]]:
    """Parse exposition-format text into {metric: {labelstr: value}}.

    Round-trip companion to :meth:`MetricsRegistry.render` — used by the
    tests and scrape tooling to assert counter values survive the wire.
    The label string is the rendered ``{k="v",...}`` form ("" when bare).
    """
    out: Dict[str, Dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, val_part = line.rpartition(" ")
        if not name_part:
            continue
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labels = "{" + rest
        else:
            name, labels = name_part, ""
        val = float(val_part) if val_part not in ("+Inf", "-Inf") else (
            math.inf if val_part == "+Inf" else -math.inf
        )
        out.setdefault(name, {})[labels] = val
    return out


#: Process-global default registry: each process (driver, replica actor,
#: training worker) records into its own and exposes it whole.
_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY
