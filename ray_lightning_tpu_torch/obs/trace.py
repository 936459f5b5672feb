"""Request tracing: typed lifecycle spans + Chrome trace-event export.

The PyTorch port keeps its own copy of ``ray_lightning_tpu/obs/trace.py``
(stdlib only): the same span vocabulary and wire forms, so a trace dump
from either package reads the same.

Every serve request leaves a trail of timestamped events — submit →
queued → admitted → each prefill chunk → prefix-cache seed → each decode
fold it rode → first token → finish/cancel/expire — appended to a
bounded per-replica ring buffer (:class:`RequestTracer`). Recording is a
tuple append under one lock, no I/O and no string formatting, so the
decode hot loop pays nanoseconds per event (the bench measures the
observer effect as ``obs_overhead``; the smoke test pins it < 5%).

Reconstruction happens at READ time: ``trace(request_id)`` scans the
ring, and :func:`to_chrome_trace` converts traces into Chrome
trace-event JSON — the `{"traceEvents": [...]}` format Perfetto and
chrome://tracing open directly. Lifecycle phases (queued / prefill /
decode) are derived as complete ("X") events from the markers; the raw
markers ride along as instant ("i") events on the same track.

Event names (the ``SPAN_*`` constants) are the trace's type system; the
well-formedness contract per admitted request is::

    submit <= queued <= admitted <= [prefill_chunk...] <= first_token
           <= finish | cancel | expire

with ``prefix_seed`` inside the admission block (between queued and the
first chunk — the engine records it while seeding the slot) on a
prefix-cache hit, and ``decode_fold`` events between first_token and the
terminal event. tests/test_obs.py asserts it across chunked-prefill x
prefix-hit x mid-fold-cancel.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# -- span names (the typed vocabulary) ---------------------------------
#: Request entered the DRIVER-side client (``submit()`` entry or batch
#: coalescing enqueue) — the earliest client-observed instant, and the
#: anchor the anatomy ledger's ``batch_window`` phase starts from.
SPAN_CLIENT_RECV = "client_recv"
#: Driver finished route planning for the request (attrs: replica) —
#: closes ``batch_window`` and opens ``route_plan`` in the ledger.
SPAN_CLIENT_PLAN = "client_plan"
#: Request left the DRIVER-side client (recorded by ServeClient in its
#: own process-local tracer — the cross-process anchor every stitched
#: trace hangs off: replica/follower spans resolve back to it by
#: request id, and the client→admitted gap becomes the derived
#: ``client_wait`` span in :func:`merge_chrome_trace`).
SPAN_CLIENT_SUBMIT = "client_submit"
SPAN_SUBMIT = "submit"          #: request arrived at the RPC surface
SPAN_QUEUED = "queued"          #: entered the scheduler queue
SPAN_ADMITTED = "admitted"      #: entered an engine slot
SPAN_PREFIX_SEED = "prefix_seed"  #: slot KV seeded from the prefix pool
SPAN_PREFILL = "prefill"        #: monolithic (fused) prefill dispatched
SPAN_PREFILL_CHUNK = "prefill_chunk"  #: one chunk of a chunked prefill
SPAN_FIRST_TOKEN = "first_token"
SPAN_DECODE_FOLD = "decode_fold"  #: one engine fold this request rode
#: draft/verify accounting of one speculative fold this request rode
#: (attrs: tokens emitted, drafted, accepted)
SPAN_SPEC_VERIFY = "spec_verify"
SPAN_FINISH = "finish"
SPAN_CANCEL = "cancel"
SPAN_EXPIRE = "expire"
#: Fleet KV plane: the request parked transfer-pending while its warm
#: pages fetch from a peer (attrs: peer, blocks).
SPAN_KV_FETCH = "kv_fetch"
#: Persistent KV store: the request parked while its chain fetches from
#: the object store (no live peer held it; attrs: blocks).
SPAN_KVSTORE_FETCH = "kvstore_fetch"
#: Persistent KV store: a parked/stored chain imported back into this
#: replica's pool — the request admits warm on its next queue pass.
SPAN_KV_RESTORE = "kv_restore"
#: Session parking: an idle conversation's chain exported to the
#: persistent store and its device pages freed (attrs: blocks, stored,
#: freed).
SPAN_KV_PARK = "kv_park"
#: Fleet KV plane: a parked transfer resolved — warm pages landed (or
#: the fetch failed and the request falls back to cold prefill). Attrs:
#: source ("peer" | "store"), ok, and on failure the reason. Closes the
#: ledger's ``kv_fetch`` phase; the land→admit gap is ``transfer_park``.
SPAN_KV_LAND = "kv_land"
#: Disaggregated prefill, decode side: shipped KV pages imported into
#: this replica's pool (attrs: src, blocks, layerwise). Recorded by the
#: fleet plane's service loop — the only mark of the ship transit
#: landing before the stream's resubmit arrives.
SPAN_KV_SHIP_LAND = "kv_ship_land"
#: Disaggregated prefill: this engine finished the prefill and shipped
#: the KV pages to a decode replica (attrs: target, blocks) — terminal
#: HERE, the stream continues on the target.
SPAN_SHIPPED = "shipped"

TERMINAL_SPANS = (SPAN_FINISH, SPAN_CANCEL, SPAN_EXPIRE, SPAN_SHIPPED)


class RequestTracer:
    """Bounded ring buffer of (request_id, span, t, attrs) events.

    ``capacity`` bounds memory for a long-lived replica: old requests'
    events fall off the back as new ones append. ``enabled=False`` turns
    :meth:`event` into an immediate return (the bench's tracing-off
    mode); flipping it at runtime is safe.
    """

    def __init__(self, capacity: int = 8192, enabled: bool = True) -> None:
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=self.capacity)
        #: Total events evicted by ring wrap over this tracer's lifetime.
        self.dropped = 0
        # Request ids that lost at least one event to ring wrap. Pruned
        # against the live ring once per `capacity` evictions, so a rid
        # only stays here while it still has events in the ring — i.e.
        # while its retained trace is genuinely partial.
        self._evicted: set = set()
        #: Wall-clock minus monotonic at construction. Events record on
        #: the cheap monotonic clock; cross-process merges add this
        #: offset so rings recorded in different processes (each with its
        #: own monotonic base) align on one wall-clock timeline.
        self.wall_offset = time.time() - time.monotonic()

    # -- hot path ---------------------------------------------------------
    def event(
        self,
        request_id: str,
        span: str,
        t: Optional[float] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Append one event. ``t`` defaults to ``time.monotonic()`` now;
        ``attrs`` is stored by reference (callers must not mutate it)."""
        if not self.enabled:
            return
        if t is None:
            t = time.monotonic()
        with self._lock:
            if len(self._events) == self.capacity and self.capacity > 0:
                self._evicted.add(self._events[0][0])
                self.dropped += 1
                if self.dropped % self.capacity == 0:
                    live = {r for r, _, _, _ in self._events}
                    self._evicted &= live
            self._events.append((request_id, span, t, attrs))

    # -- read side --------------------------------------------------------
    def _scan(self) -> List[Tuple[str, str, float, Optional[Dict[str, Any]]]]:
        with self._lock:
            return list(self._events)

    def is_truncated(self, request_id: str) -> bool:
        """True when ring wrap evicted some of this request's events
        while others remain — the retained trace is partial and any
        duration derived from its first event under-counts."""
        with self._lock:
            return request_id in self._evicted

    def trace(self, request_id: str) -> List[Dict[str, Any]]:
        """All of one request's events, oldest first, as dicts. When the
        ring wrapped over part of this request's history, the first
        retained event carries ``truncated: True`` — consumers must not
        treat its timestamp as the request's start."""
        out = []
        for rid, span, t, attrs in self._scan():
            if rid != request_id:
                continue
            ev: Dict[str, Any] = {"span": span, "t": t}
            if attrs:
                ev.update(attrs)
            out.append(ev)
        if out and self.is_truncated(request_id):
            out[0] = dict(out[0], truncated=True)
        return out

    def recent_traces(self, n: int = 8) -> Dict[str, List[Dict[str, Any]]]:
        """The last ``n`` distinct request ids (by latest event) with
        their full event lists."""
        events = self._scan()
        order: List[str] = []
        for rid, _, _, _ in reversed(events):
            if rid not in order:
                order.append(rid)
            if len(order) >= n:
                break
        keep = set(order)
        traces: Dict[str, List[Dict[str, Any]]] = {rid: [] for rid in order}
        for rid, span, t, attrs in events:
            if rid in keep:
                ev: Dict[str, Any] = {"span": span, "t": t}
                if attrs:
                    ev.update(attrs)
                traces[rid].append(ev)
        return traces

    def request_ids(self) -> List[str]:
        seen: List[str] = []
        for rid, _, _, _ in self._scan():
            if rid not in seen:
                seen.append(rid)
        return seen

    def dump(self, n: int = 16) -> Dict[str, Any]:
        """The wire form of this process's ring for cross-process trace
        stitching: the ``n`` most recent traces plus the wall-clock
        offset :func:`merge_chrome_trace` needs to align them with rings
        from other processes. ``truncated`` lists the dumped request ids
        whose retained traces are partial (ring wrap ate early events) —
        the anatomy layer turns that into ``unaccounted`` provenance
        instead of mis-attributing the missing time. The key is omitted
        entirely when nothing was truncated, keeping the healthy-path
        wire form unchanged."""
        traces = self.recent_traces(n)
        with self._lock:
            truncated = sorted(r for r in traces if r in self._evicted)
        out: Dict[str, Any] = {
            "wall_offset": self.wall_offset,
            "traces": traces,
        }
        if truncated:
            out["truncated"] = truncated
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# -- Chrome trace-event export -----------------------------------------
_PHASES = (
    # (name, start marker(s), end marker(s))
    ("queued", (SPAN_SUBMIT, SPAN_QUEUED), (SPAN_ADMITTED,)),
    ("prefill", (SPAN_ADMITTED,), (SPAN_FIRST_TOKEN,) + TERMINAL_SPANS),
    ("decode", (SPAN_FIRST_TOKEN,), TERMINAL_SPANS),
)


def _first_t(evs: List[Dict[str, Any]], spans: Tuple[str, ...]) -> Optional[float]:
    for ev in evs:
        if ev["span"] in spans:
            return ev["t"]
    return None


def _emit_tracks(
    events: List[Dict[str, Any]],
    pid: int,
    traces: Dict[str, List[Dict[str, Any]]],
    us,
) -> None:
    """Append one process's request tracks (thread metadata, derived
    lifecycle phases, raw markers) onto ``events``. Shared by the
    single-process and merged exports so both render identically."""
    for tid, (rid, evs) in enumerate(sorted(traces.items()), start=1):
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "args": {"name": f"request {rid}"},
            }
        )
        evs = sorted(evs, key=lambda e: e["t"])
        for phase, starts, ends in _PHASES:
            ts = _first_t(evs, starts)
            te = _first_t(evs, ends)
            if ts is None or te is None or te < ts:
                continue
            events.append(
                {
                    "ph": "X",
                    "name": phase,
                    "cat": "lifecycle",
                    "pid": pid,
                    "tid": tid,
                    "ts": us(ts),
                    "dur": max(round((te - ts) * 1e6, 1), 0.1),
                    "args": {"request_id": rid},
                }
            )
        for ev in evs:
            args = {k: v for k, v in ev.items() if k not in ("span", "t")}
            args["request_id"] = rid
            events.append(
                {
                    "ph": "i",
                    "name": ev["span"],
                    "cat": "marker",
                    "s": "t",
                    "pid": pid,
                    "tid": tid,
                    "ts": us(ev["t"]),
                    "args": args,
                }
            )


def to_chrome_trace(
    traces: Dict[str, List[Dict[str, Any]]],
    process_name: str = "rlt-serve",
    pid: int = 0,
) -> Dict[str, Any]:
    """Convert ``{request_id: [event, ...]}`` into Chrome trace-event
    JSON (dict form; ``json.dump`` it to get a file Perfetto opens).

    Each request gets its own thread track (tid). Derived lifecycle
    phases become complete ("X") events; every raw marker becomes an
    instant ("i") event carrying its attrs as args. Timestamps are
    microseconds relative to the earliest event in the export.
    """
    all_t = [ev["t"] for evs in traces.values() for ev in evs]
    t0 = min(all_t) if all_t else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 1)

    events: List[Dict[str, Any]] = [
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": process_name},
        }
    ]
    _emit_tracks(events, pid, traces, us)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def merge_chrome_trace(
    processes: List[Dict[str, Any]],
) -> Dict[str, Any]:
    """Stitch several processes' trace rings into ONE Chrome trace.

    ``processes`` is a list of ``{"name", "traces", "wall_offset"}``
    dicts — the :meth:`RequestTracer.dump` wire form plus a display
    name (``client`` / ``replica0`` / ``follower1`` ...). Each process
    becomes its own pid track (process_name metadata), each request its
    own thread track within it, and every event's monotonic timestamp
    is shifted by its process's ``wall_offset`` so spans recorded on
    different monotonic bases line up on one wall-clock timeline.

    Cross-process derivation: a request with a :data:`SPAN_CLIENT_SUBMIT`
    in one process and a :data:`SPAN_ADMITTED` (or first token) in
    another gets a ``client_wait`` complete span on the client's track —
    the client-observed queue time (RPC hop + scheduler queue) that no
    single process's ring can see.
    """
    norm: List[Tuple[int, str, Dict[str, List[Dict[str, Any]]]]] = []
    for pid, proc in enumerate(processes):
        off = float(proc.get("wall_offset") or 0.0)
        traces = {
            rid: [dict(ev, t=float(ev["t"]) + off) for ev in evs]
            for rid, evs in (proc.get("traces") or {}).items()
            if evs
        }
        norm.append((pid, str(proc.get("name") or f"process{pid}"), traces))

    all_t = [
        ev["t"] for _, _, traces in norm
        for evs in traces.values() for ev in evs
    ]
    t0 = min(all_t) if all_t else 0.0

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 1)

    events: List[Dict[str, Any]] = []
    for pid, name, traces in norm:
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "args": {"name": name},
            }
        )
        _emit_tracks(events, pid, traces, us)

    # The cross-process span: client submit -> remote admission (falling
    # back to the first token for engines driven without a scheduler).
    landed: Dict[str, float] = {}
    for _, _, traces in norm:
        for rid, evs in traces.items():
            t_adm = _first_t(
                sorted(evs, key=lambda e: e["t"]),
                (SPAN_ADMITTED, SPAN_FIRST_TOKEN),
            )
            if t_adm is not None and (
                rid not in landed or t_adm < landed[rid]
            ):
                landed[rid] = t_adm
    for pid, _, traces in norm:
        for tid, (rid, evs) in enumerate(sorted(traces.items()), start=1):
            t_sub = _first_t(evs, (SPAN_CLIENT_SUBMIT,))
            t_adm = landed.get(rid)
            if t_sub is None or t_adm is None or t_adm < t_sub:
                continue
            events.append(
                {
                    "ph": "X",
                    "name": "client_wait",
                    "cat": "lifecycle",
                    "pid": pid,
                    "tid": tid,
                    "ts": us(t_sub),
                    "dur": max(round((t_adm - t_sub) * 1e6, 1), 0.1),
                    "args": {"request_id": rid},
                }
            )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
