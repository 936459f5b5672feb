"""Flight recorder: self-contained forensic bundles for post-mortems.

The PyTorch port's copy of ``ray_lightning_tpu/obs/blackbox.py``.

When something goes wrong — the watchdog flips a component to
``unhealthy``, the trainer's fit raises, an operator asks for a dump
— the process should leave a BLACK BOX: everything needed to diagnose
the failure without reproducing it. :func:`dump_bundle` writes one
bundle directory containing:

- ``metrics.prom``   — the registry rendered in Prometheus text format
- ``events.jsonl``   — the structured event-log tail (obs.events)
- ``trace.json``     — recent request traces as Chrome trace JSON
- ``journal.jsonl``  — the workload journal (obs.journal): the recorded
                       request stream + outcomes, replayable through
                       ``obs.journal.replay_journal``
- ``health.json``    — the health report at dump time (obs.health)
- ``heartbeats.json``— the fabric heartbeat snapshot (driver-side)
- ``config.json``    — the serve/train config the process ran with
- ``versions.json``  — python/platform/torch/CUDA versions + card names
- ``stacks.txt``     — an all-threads stack dump via ``faulthandler``
                       (the "where is it stuck" answer for hangs)
- ``manifest.json``  — reason, timestamp, file list, collector errors

Every artifact is collected independently: a broken collector records
its error in the manifest instead of losing the rest of the bundle.

:class:`FlightRecorder` wraps ``dump_bundle`` with the operational
policy — automatic dumps are rate-limited (``min_interval_s``) and the
output directory keeps only the last ``keep`` bundles, so a flapping
watchdog cannot fill a disk. ``crash_dump`` is the module-level
convenience the trainer's exception path uses (process registry +
event log, ``RLT_BLACKBOX_DIR`` destination).
"""
from __future__ import annotations

import faulthandler
import json
import os
import platform
import re
import sys
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_lightning_tpu_torch.obs.events import EventLog, get_event_log
from ray_lightning_tpu_torch.obs.registry import MetricsRegistry, get_registry


def default_blackbox_dir() -> str:
    """``RLT_BLACKBOX_DIR`` or a per-user tempdir fallback."""
    return os.environ.get("RLT_BLACKBOX_DIR") or os.path.join(
        tempfile.gettempdir(), "rlt_blackbox"
    )


def collect_versions() -> Dict[str, Any]:
    """Runtime provenance: torch, its CUDA and the cards' names. Read
    only when torch is already imported and its CUDA runtime already
    initialized — a forensic dump must never be the thing that creates a
    CUDA context."""
    out: Dict[str, Any] = {
        "python": sys.version,
        "platform": platform.platform(),
        "pid": os.getpid(),
    }
    torch = sys.modules.get("torch")
    if torch is not None:
        try:
            out["torch"] = torch.__version__
            out["cuda"] = torch.version.cuda
            if torch.cuda.is_initialized():
                out["devices"] = [
                    f"cuda:{i}:{torch.cuda.get_device_name(i)}"
                    for i in range(torch.cuda.device_count())
                ]
        except Exception as exc:  # noqa: BLE001 - a wedged runtime is
            out["torch_error"] = repr(exc)  # exactly when we're dumping
    return out


def _slug(reason: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", reason).strip("-")[:48] or "dump"


def dump_bundle(
    outdir: str,
    *,
    registry: Optional[MetricsRegistry] = None,
    events: Optional[EventLog] = None,
    tracer: Optional[Any] = None,
    journal: Optional[Any] = None,
    health: Optional[Any] = None,
    heartbeats: Optional[Dict[str, Any]] = None,
    config: Optional[Dict[str, Any]] = None,
    reason: str = "manual",
    trace_n: int = 16,
    events_n: int = 512,
) -> Dict[str, Any]:
    """Write one forensic bundle under ``outdir``; returns its manifest
    (``dir``, ``files``, per-collector ``errors``). ``health`` may be a
    dict or an :class:`obs.health.HealthReport`; ``tracer`` a
    :class:`obs.trace.RequestTracer`."""
    ts = time.time()
    stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(ts))
    bundle_dir = os.path.join(
        outdir, f"bundle-{stamp}-{os.getpid()}-{_slug(reason)}"
    )
    os.makedirs(bundle_dir, exist_ok=True)
    files: List[str] = []
    errors: Dict[str, str] = {}

    def write(name: str, produce: Callable[[], str]) -> None:
        try:
            content = produce()
        except Exception as exc:  # noqa: BLE001 - record, keep dumping
            errors[name] = repr(exc)
            return
        if content is None:
            return
        with open(os.path.join(bundle_dir, name), "w") as f:
            f.write(content)
        files.append(name)

    if registry is not None:
        write("metrics.prom", registry.render)
    if events is not None:
        write("events.jsonl", lambda: events.to_jsonl(events_n))
    if tracer is not None:
        def _trace() -> str:
            from ray_lightning_tpu_torch.obs.trace import to_chrome_trace

            traces = tracer.recent_traces(trace_n)
            return json.dumps(
                to_chrome_trace({r: e for r, e in traces.items() if e})
            )
        write("trace.json", _trace)
    if journal is not None:
        # The workload journal (obs.journal) makes the bundle
        # REPLAYABLE: ``obs.journal.replay_journal`` re-drives the
        # recorded request stream bit-exactly.
        write("journal.jsonl", journal.to_jsonl)
    if health is not None:
        write("health.json", lambda: json.dumps(
            health.to_dict() if hasattr(health, "to_dict") else health,
            default=str, indent=2,
        ))
    if heartbeats is not None:
        write("heartbeats.json",
              lambda: json.dumps(heartbeats, default=str, indent=2))
    if config is not None:
        write("config.json",
              lambda: json.dumps(config, default=str, indent=2))
    write("versions.json", lambda: json.dumps(collect_versions(), indent=2))

    # All-threads stack dump: the hang-forensics centerpiece. Written
    # directly (not via write()) because faulthandler wants a real fd.
    try:
        stacks_path = os.path.join(bundle_dir, "stacks.txt")
        with open(stacks_path, "w") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
        files.append("stacks.txt")
    except Exception as exc:  # noqa: BLE001
        errors["stacks.txt"] = repr(exc)

    manifest = {
        "reason": reason,
        "ts": ts,
        "dir": bundle_dir,
        "files": sorted(files),
        "errors": errors,
    }
    with open(os.path.join(bundle_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def read_bundle(bundle_dir: str) -> Dict[str, str]:
    """``{filename: text}`` of a bundle — the pull format the
    ``debug_dump(pull=True)`` RPCs ship over the wire."""
    out: Dict[str, str] = {}
    for name in sorted(os.listdir(bundle_dir)):
        path = os.path.join(bundle_dir, name)
        if os.path.isfile(path):
            with open(path, "r", errors="replace") as f:
                out[name] = f.read()
    return out


class FlightRecorder:
    """Bundle policy: rate-limited automatic dumps, bounded retention.

    The ``*_fn`` sources are called AT DUMP TIME so a bundle always
    carries current state; ``maybe_dump`` is the watchdog's trigger
    (rate-limited), ``dump`` the on-demand RPC's (always fires). Both
    prune the output directory to the newest ``keep`` bundles.
    """

    def __init__(
        self,
        outdir: Optional[str] = None,
        keep: int = 3,
        min_interval_s: float = 30.0,
        registry: Optional[MetricsRegistry] = None,
        events: Optional[EventLog] = None,
        tracer: Optional[Any] = None,
        journal: Optional[Any] = None,
        health_fn: Optional[Callable[[], Any]] = None,
        heartbeats_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        config: Optional[Dict[str, Any]] = None,
    ) -> None:
        self.outdir = outdir or default_blackbox_dir()
        self.keep = max(1, int(keep))
        self.min_interval_s = float(min_interval_s)
        self._registry = registry
        self._events = events
        self._tracer = tracer
        self._journal = journal
        self._health_fn = health_fn
        self._heartbeats_fn = heartbeats_fn
        self._config = config
        self._lock = threading.Lock()
        self._last_dump: Optional[float] = None

    def bundles(self) -> List[str]:
        """Bundle directories under ``outdir``, oldest first."""
        try:
            names = sorted(
                n for n in os.listdir(self.outdir)
                if n.startswith("bundle-")
                and os.path.isdir(os.path.join(self.outdir, n))
            )
        except OSError:
            return []
        return [os.path.join(self.outdir, n) for n in names]

    def dump(self, reason: str = "manual") -> Dict[str, Any]:
        with self._lock:
            self._last_dump = time.monotonic()
        manifest = dump_bundle(
            self.outdir,
            registry=self._registry,
            events=self._events,
            tracer=self._tracer,
            journal=self._journal,
            health=self._health_fn() if self._health_fn else None,
            heartbeats=self._heartbeats_fn() if self._heartbeats_fn else None,
            config=self._config,
            reason=reason,
        )
        self._prune()
        return manifest

    def maybe_dump(self, reason: str = "auto") -> Optional[Dict[str, Any]]:
        """Rate-limited dump: None when the last one was less than
        ``min_interval_s`` ago (a flapping watchdog must not spam)."""
        with self._lock:
            now = time.monotonic()
            if (
                self._last_dump is not None
                and now - self._last_dump < self.min_interval_s
            ):
                return None
        return self.dump(reason)

    def _prune(self) -> None:
        import shutil

        bundles = self.bundles()
        for stale in bundles[: max(0, len(bundles) - self.keep)]:
            try:
                shutil.rmtree(stale)
            except OSError:
                pass


# ---------------------------------------------------------------------------
# Process-default crash recorder (the trainer exception path)
# ---------------------------------------------------------------------------
_DEFAULT: Optional[FlightRecorder] = None
_DEFAULT_LOCK = threading.Lock()


def default_recorder() -> FlightRecorder:
    """Lazy process-default recorder over the process registry + event
    log, writing to ``RLT_BLACKBOX_DIR``; rebuilt if the env-configured
    destination changes."""
    global _DEFAULT
    outdir = default_blackbox_dir()
    with _DEFAULT_LOCK:
        if _DEFAULT is None or _DEFAULT.outdir != outdir:
            _DEFAULT = FlightRecorder(
                outdir=outdir,
                min_interval_s=5.0,
                registry=get_registry(),
                events=get_event_log(),
            )
        return _DEFAULT


def crash_dump(reason: str) -> Optional[Dict[str, Any]]:
    """Best-effort bundle on an exception path: rate-limited, and NEVER
    raises — forensics must not mask the original error."""
    try:
        return default_recorder().maybe_dump(reason)
    except Exception:  # noqa: BLE001
        return None
