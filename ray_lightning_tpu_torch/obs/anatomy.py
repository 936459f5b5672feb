"""Request anatomy: the per-request phase ledger.

The PyTorch port keeps its own copy of ``ray_lightning_tpu/obs/anatomy.py``
(stdlib only). ``anatomy_from_client``, which reads a live fleet client,
waits for the client (ROADMAP queue 1 item 10).

One request's latency hides in many places: the driver's batch window
and route planning, the scheduler queue, a transfer-pending park while
warm KV pages fetch from a peer or the persistent store, the prefill
(solo chunks or piggybacked inside decode folds), a disaggregated
prefill→decode ship, the decode itself, and the stream's final hop back
to the caller. A DistServe-style fleet spreads those phases over three
or more processes, so no single ring can answer "where did the time
go?" — this module is the joining layer.

:func:`assemble_anatomy` stitches the :class:`~.trace.RequestTracer`
dumps of every process (client + replicas + followers), the driver-side
journal entries, and the typed event ring under ONE request id into a
**phase ledger**: a chronological list of phase rows, each attributed
to the process it ran on, drawn from the canonical vocabulary

    client_wait   driver→replica handoff (RPC transit, re-drives)
    batch_window  coalescing wait inside the driver's batcher
    route_plan    driver routing/planning (plan → submit RPC)
    queue         scheduler queue (submit → admission decision)
    transfer_park re-queued wait after a KV transfer landed
    kv_fetch      parked on a warm-page fetch (detail: peer | store)
    prefill       slot entry → first token (detail: solo | piggyback)
    ship          disaggregated prefill→decode KV handoff (export,
                  transit, decode-side import)
    decode        first token → terminal
    stream_gap    replica terminal → the client observing the end

with ``hedged`` / ``migrated`` / ``failover`` markers riding alongside
(they are occurrences, not durations — their time lands in the phases
that contain them).

**Coverage contract**: the rows are clipped to a single non-overlapping
timeline (a hedged loser's spans never double-count), so

    observed_s == accounted_s + unaccounted_s        (exactly)

where ``observed_s`` is the client-observed latency (first client event
→ journal outcome, when available). Unattributed time is reported as
``unaccounted`` — never silently absorbed into a neighboring phase —
and ``coverage`` is the accounted fraction; callers state a tolerance
(default 10%) and ``covered`` says whether the ledger met it. A ring
that wrapped over part of the request's history flags ``truncated`` and
the missing span shows up as unaccounted WITH provenance, not as a
mis-attribution.

The compact per-request ``{phase: seconds}`` maps the scheduler folds
into journal outcome records and the metrics window are the same
vocabulary one layer down: :func:`aggregate_phases` rolls them into
percentile blocks (the fleet decomposition, the replay diff) and
:func:`breach_attribution` turns a block into "kv_fetch 58%, queue
22%" — the Watchdog's SLO-breach verdicts name their top contributing
phases with it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.obs import trace as _trace

#: Canonical phase order (rendering + aggregation stability).
PHASES = (
    "client_wait",
    "batch_window",
    "route_plan",
    "queue",
    "transfer_park",
    "kv_fetch",
    "prefill",
    "ship",
    "decode",
    "stream_gap",
)

#: Marker names (occurrences, not durations).
MARKERS = ("hedged", "migrated", "failover")

#: Default coverage tolerance: phases + unaccounted always sum exactly;
#: ``covered`` is whether unaccounted stayed under this fraction.
DEFAULT_TOLERANCE = 0.10

_PHASE_ORDER = {p: i for i, p in enumerate(PHASES)}

_FETCH_SPANS = (_trace.SPAN_KV_FETCH, _trace.SPAN_KVSTORE_FETCH)
_START_SPANS = (_trace.SPAN_SUBMIT, _trace.SPAN_QUEUED)


def _first(evs: Sequence[Dict[str, Any]], spans: Tuple[str, ...],
           after: float = float("-inf")) -> Optional[Dict[str, Any]]:
    for ev in evs:
        if ev["span"] in spans and ev["t"] >= after:
            return ev
    return None


def _event_rid(ev: Dict[str, Any]) -> Optional[str]:
    rid = ev.get("request_id")
    if rid is None:
        rid = (ev.get("kv") or {}).get("request_id")
    return None if rid is None else str(rid)


class _Segment:
    """One visit of the request to one scheduler process: submit (or an
    early ship-land) through a terminal span."""

    def __init__(self, proc: str, evs: List[Dict[str, Any]]) -> None:
        self.proc = proc
        self.evs = evs
        self.t_sub = (_first(evs, _START_SPANS) or {}).get("t")
        term = _first(evs, _trace.TERMINAL_SPANS)
        self.t_term = term.get("t") if term else None
        self.end_span = term.get("span") if term else None
        self.t_ship_land = (
            _first(evs, (_trace.SPAN_KV_SHIP_LAND,)) or {}
        ).get("t")
        ts = [ev["t"] for ev in evs]
        self.t_start = min(ts)
        self.t_end = max(ts)

    def order_key(self) -> float:
        return self.t_sub if self.t_sub is not None else self.t_start

    def intervals(self) -> List[Tuple[float, float, str, str, str]]:
        """Phase intervals within this segment: (start, end, phase,
        process, detail)."""
        evs = self.evs
        out: List[Tuple[float, float, str, str, str]] = []
        t_sub = self.t_sub
        fetch = _first(evs, _FETCH_SPANS)
        t_fetch = fetch.get("t") if fetch else None
        src = None
        if fetch is not None:
            src = (
                "store"
                if fetch["span"] == _trace.SPAN_KVSTORE_FETCH
                else "peer"
            )
        land = _first(
            evs, (_trace.SPAN_KV_LAND,),
            after=t_fetch if t_fetch is not None else float("-inf"),
        )
        t_land = land.get("t") if land else None
        if land is not None and land.get("source"):
            src = str(land["source"])
        admit = _first(evs, (_trace.SPAN_ADMITTED,))
        t_admit = admit.get("t") if admit else None
        first = _first(evs, (_trace.SPAN_FIRST_TOKEN,))
        t_first = first.get("t") if first else None
        ship = _first(evs, (_trace.SPAN_SHIPPED,))
        t_ship = ship.get("t") if ship else None
        t_term = self.t_term

        def _next(*cands: Optional[float]) -> Optional[float]:
            real = [c for c in cands if c is not None]
            return min(real) if real else None

        if t_sub is not None:
            e = _next(t_fetch, t_admit, t_ship, t_term)
            if e is not None and e > t_sub:
                out.append((t_sub, e, "queue", self.proc, ""))
        if t_fetch is not None:
            e = _next(t_land, t_admit, t_term)
            if e is not None and e > t_fetch:
                out.append(
                    (t_fetch, e, "kv_fetch", self.proc, src or "")
                )
        if t_land is not None:
            e = _next(t_admit, t_term)
            if e is not None and e > t_land:
                out.append((t_land, e, "transfer_park", self.proc, ""))
        if t_admit is not None:
            e = _next(t_first, t_ship, t_term)
            if e is not None and e > t_admit:
                detail = str((first or {}).get("mode") or "")
                if not detail and self.t_ship_land is not None:
                    detail = "warm"
                out.append((t_admit, e, "prefill", self.proc, detail))
        if t_ship is not None:
            s = _next(t_first)
            if s is None or s > t_ship:
                s = t_admit
            if s is not None and t_ship > s:
                out.append((s, t_ship, "ship", self.proc, "export"))
        if (
            t_first is not None
            and t_term is not None
            and t_term > t_first
            and (t_ship is None or t_ship >= t_term)
        ):
            out.append((t_first, t_term, "decode", self.proc, ""))
        return out


def _split_segments(
    proc: str, evs: List[Dict[str, Any]]
) -> List[_Segment]:
    """Split one process's events for a request into visit segments: a
    fresh ``submit`` after a terminal span starts a new visit (the same
    process can see a request twice — e.g. a migration bouncing back)."""
    segs: List[_Segment] = []
    cur: List[Dict[str, Any]] = []
    terminal_seen = False
    for ev in evs:
        if (
            ev["span"] in _START_SPANS
            and terminal_seen
            and cur
        ):
            segs.append(_Segment(proc, cur))
            cur, terminal_seen = [], False
        cur.append(ev)
        if ev["span"] in _trace.TERMINAL_SPANS:
            terminal_seen = True
    if cur:
        segs.append(_Segment(proc, cur))
    return segs


def assemble_anatomy(
    request_id: str,
    processes: Sequence[Dict[str, Any]],
    journal: Optional[Sequence[Dict[str, Any]]] = None,
    events: Optional[Sequence[Dict[str, Any]]] = None,
    tolerance: float = DEFAULT_TOLERANCE,
) -> Dict[str, Any]:
    """Stitch one request's cross-process phase ledger.

    ``processes`` is the ``ServeClient.trace_dumps()`` wire form: a list
    of ``{"name", "wall_offset", "traces", ["truncated"]}`` dicts (the
    :meth:`RequestTracer.dump` shape plus a display name). ``journal``
    is the driver-side journal's entries (its ``outcome`` record pins
    the client-observed end; its ``submit`` record is a start
    fallback). ``events`` is a merged typed-event list (wall-clock) —
    the hedge/failover/migration markers live there.

    Returns the ledger dict: ``phases`` rows (chronological, clipped to
    one non-overlapping timeline), ``totals`` per phase, ``observed_s``
    == ``accounted_s`` + ``unaccounted_s`` exactly, ``coverage``,
    ``covered`` (against ``tolerance``), ``markers``, the ``outcome``
    chain, ``processes`` seen, and truncation ``provenance``.
    """
    rid = str(request_id)
    per_proc: List[Tuple[str, List[Dict[str, Any]]]] = []
    truncated_procs: List[str] = []
    for i, proc in enumerate(processes):
        name = str(proc.get("name") or f"process{i}")
        off = float(proc.get("wall_offset") or 0.0)
        evs = (proc.get("traces") or {}).get(rid) or []
        if not evs:
            continue
        if rid in (proc.get("truncated") or ()) or any(
            ev.get("truncated") for ev in evs
        ):
            truncated_procs.append(name)
        per_proc.append((
            name,
            sorted(
                (dict(ev, t=float(ev["t"]) + off) for ev in evs),
                key=lambda e: e["t"],
            ),
        ))

    jr_submit_wall: Optional[float] = None
    jr_outcome_wall: Optional[float] = None
    jr_outcome: Optional[str] = None
    jr_phases: Optional[Dict[str, Any]] = None
    for entry in journal or ():
        if str(entry.get("request_id")) != rid:
            continue
        kind = entry.get("kind")
        if kind == "submit" and entry.get("t_wall") is not None:
            t = float(entry["t_wall"])
            if jr_submit_wall is None or t < jr_submit_wall:
                jr_submit_wall = t
        elif kind == "outcome" and entry.get("t_wall") is not None:
            t = float(entry["t_wall"])
            if jr_outcome_wall is None or t > jr_outcome_wall:
                jr_outcome_wall = t
                jr_outcome = entry.get("outcome")
                jr_phases = entry.get("phases")

    if not per_proc and jr_phases:
        # Offline journal-only mode: no rings survive (a captured
        # incident autopsied cold) — the outcome record's compact
        # ledger is the whole story.
        return ledger_from_phase_map(
            rid, jr_phases, outcome=jr_outcome or "unknown"
        )
    if not per_proc:
        return {"request_id": rid, "found": False}

    # -- client milestones + scheduler segments -------------------------
    client_proc = None
    t_recv = t_plan = t_csub = None
    segments: List[_Segment] = []
    for name, evs in per_proc:
        ev = _first(evs, (_trace.SPAN_CLIENT_RECV,))
        if ev is not None and t_recv is None:
            t_recv, client_proc = ev["t"], name
        ev = _first(evs, (_trace.SPAN_CLIENT_PLAN,))
        if ev is not None and t_plan is None:
            t_plan = ev["t"]
            client_proc = client_proc or name
        ev = _first(evs, (_trace.SPAN_CLIENT_SUBMIT,))
        if ev is not None and t_csub is None:
            t_csub = ev["t"]
            client_proc = client_proc or name
        sched_evs = [
            e for e in evs
            if e["span"] not in (
                _trace.SPAN_CLIENT_RECV,
                _trace.SPAN_CLIENT_PLAN,
                _trace.SPAN_CLIENT_SUBMIT,
            )
        ]
        if sched_evs and _first(sched_evs, _START_SPANS) is not None:
            segments.extend(_split_segments(name, sched_evs))
    segments.sort(key=_Segment.order_key)
    client_proc = client_proc or "client"

    # -- candidate intervals --------------------------------------------
    cand: List[Tuple[float, float, str, str, str]] = []
    if t_recv is not None:
        e = t_plan if t_plan is not None else t_csub
        if e is not None and e > t_recv:
            cand.append((t_recv, e, "batch_window", client_proc, ""))
    if t_plan is not None and t_csub is not None and t_csub > t_plan:
        cand.append((t_plan, t_csub, "route_plan", client_proc, ""))
    if t_csub is not None and segments:
        t0 = segments[0].order_key()
        if t0 > t_csub:
            cand.append((t_csub, t0, "client_wait", client_proc, "rpc"))
    for seg in segments:
        cand.extend(seg.intervals())
    # Inter-segment gaps: a shipped handoff becomes the ship transit
    # (split at the decode side's import mark when it exists); any
    # other re-drive (migration, failover, hedge) is client_wait.
    for prev, nxt in zip(segments, segments[1:]):
        t_from = prev.t_term if prev.t_term is not None else prev.t_end
        t_to = nxt.order_key()
        if t_to <= t_from:
            continue
        if prev.end_span == _trace.SPAN_SHIPPED:
            t_shl = nxt.t_ship_land
            if t_shl is not None and t_from < t_shl <= t_to:
                cand.append(
                    (t_from, t_shl, "ship", nxt.proc, "transit")
                )
                if t_to > t_shl:
                    cand.append((
                        t_shl, t_to, "client_wait", client_proc,
                        "re-drive",
                    ))
            else:
                cand.append((t_from, t_to, "ship", nxt.proc, "transit"))
        else:
            cand.append(
                (t_from, t_to, "client_wait", client_proc, "re-drive")
            )

    # -- observed window -------------------------------------------------
    all_t = [ev["t"] for _, evs in per_proc for ev in evs]
    starts = [
        t for t in (t_recv, t_csub, jr_submit_wall) if t is not None
    ]
    t_start = min(starts) if starts else min(all_t)
    last_term = max(
        (s.t_term for s in segments if s.t_term is not None),
        default=None,
    )
    ends = [t for t in (jr_outcome_wall, last_term) if t is not None]
    t_end = max(ends) if ends else max(all_t)
    if t_end < t_start:
        t_end = t_start
    if (
        last_term is not None
        and jr_outcome_wall is not None
        and jr_outcome_wall > last_term
    ):
        cand.append((
            last_term, jr_outcome_wall, "stream_gap", client_proc, "",
        ))

    # -- clip to one non-overlapping timeline ---------------------------
    cand.sort(key=lambda iv: (iv[0], _PHASE_ORDER.get(iv[2], 99)))
    rows: List[Dict[str, Any]] = []
    cursor = t_start
    for s, e, phase, proc, detail in cand:
        s = max(s, cursor)
        e = min(e, t_end)
        if e <= s:
            continue
        row = {
            "phase": phase,
            "process": proc,
            "start_s": round(s - t_start, 6),
            "duration_s": round(e - s, 6),
        }
        if detail:
            row["detail"] = detail
        rows.append(row)
        cursor = e

    totals: Dict[str, float] = {}
    for row in rows:
        totals[row["phase"]] = round(
            totals.get(row["phase"], 0.0) + row["duration_s"], 6
        )
    observed = round(t_end - t_start, 6)
    accounted = round(sum(r["duration_s"] for r in rows), 6)
    unaccounted = round(max(0.0, observed - accounted), 6)

    # -- markers + outcome chain ----------------------------------------
    markers: List[str] = []
    for ev in events or ():
        if _event_rid(ev) != rid:
            continue
        name = ev.get("name")
        if name == "request_hedged" and "hedged" not in markers:
            markers.append("hedged")
        elif name == "failover" and "failover" not in markers:
            markers.append("failover")
        elif (
            name in ("cancel", "expire")
            and (ev.get("migrated") or (ev.get("kv") or {}).get(
                "migrated"
            ))
            and "migrated" not in markers
        ):
            markers.append("migrated")
    # Overlapping segments without a ship handoff = a hedge raced two
    # replicas (the loser's spans were clipped out of the timeline).
    for prev, nxt in zip(segments, segments[1:]):
        if (
            prev.t_term is not None
            and nxt.order_key() < prev.t_term
            and "hedged" not in markers
        ):
            markers.append("hedged")
    outcome_chain = [
        {
            "process": seg.proc,
            "outcome": {
                _trace.SPAN_FINISH: "finished",
                _trace.SPAN_CANCEL: "cancelled",
                _trace.SPAN_EXPIRE: "expired",
                _trace.SPAN_SHIPPED: "shipped",
            }.get(seg.end_span or "", seg.end_span or "open"),
        }
        for seg in segments
    ]
    if jr_outcome is not None:
        outcome_chain.append(
            {"process": client_proc, "outcome": jr_outcome}
        )

    provenance: List[str] = []
    if truncated_procs:
        provenance.append(
            "ring wrapped on %s: early spans lost; unaccounted time "
            "includes the pre-wrap window" % ", ".join(truncated_procs)
        )

    return {
        "request_id": rid,
        "found": True,
        "phases": rows,
        "totals": totals,
        "observed_s": observed,
        "accounted_s": accounted,
        "unaccounted_s": unaccounted,
        "coverage": round(accounted / observed, 4) if observed else 1.0,
        "covered": (
            unaccounted <= tolerance * observed if observed else True
        ),
        "tolerance": tolerance,
        "markers": markers,
        "outcome": outcome_chain,
        "processes": [name for name, _ in per_proc],
        "truncated": bool(truncated_procs),
        "provenance": provenance,
    }


def ledger_from_phase_map(
    request_id: str,
    phases: Dict[str, Any],
    outcome: str = "unknown",
    process: str = "journal",
) -> Dict[str, Any]:
    """A ledger from ONE compact ``{phase: seconds}`` map (a journal
    outcome record's serialized ledger) — the offline-autopsy shape
    ``rlt why <journal> <id>`` renders with no live fleet. Scheduler-
    local by construction: cross-process phases are absent, and the
    observed window is the map's own sum (coverage is exact)."""
    detail = {
        k: v for k, v in phases.items()
        if not isinstance(v, (int, float))
    }
    rows: List[Dict[str, Any]] = []
    start = 0.0
    for phase in PHASES:
        v = phases.get(phase)
        if not isinstance(v, (int, float)) or v <= 0:
            continue
        row = {
            "phase": phase,
            "process": process,
            "start_s": round(start, 6),
            "duration_s": round(float(v), 6),
        }
        if phase == "kv_fetch" and detail.get("kv_fetch_source"):
            row["detail"] = str(detail["kv_fetch_source"])
        rows.append(row)
        start += float(v)
    observed = round(sum(r["duration_s"] for r in rows), 6)
    return {
        "request_id": str(request_id),
        "found": bool(rows),
        "phases": rows,
        "totals": {r["phase"]: r["duration_s"] for r in rows},
        "observed_s": observed,
        "accounted_s": observed,
        "unaccounted_s": 0.0,
        "coverage": 1.0,
        "covered": True,
        "tolerance": 0.0,
        "markers": [],
        "outcome": [{"process": process, "outcome": outcome}],
        "processes": [process],
        "truncated": False,
        "provenance": [
            "journal outcome record (scheduler-local phases only; "
            "cross-process phases not captured)"
        ],
    }


# -- aggregation (fleet decomposition, replay diff) ---------------------
def aggregate_phases(
    phase_maps: Sequence[Dict[str, Any]],
) -> Dict[str, Dict[str, float]]:
    """Fold compact ``{phase: seconds}`` maps into per-phase percentile
    rows (nearest-rank) — the shape the fleet ``phases`` block and the
    replay phase diff share."""
    by_phase: Dict[str, List[float]] = {}
    for m in phase_maps:
        for phase, v in (m or {}).items():
            if isinstance(v, (int, float)):
                by_phase.setdefault(phase, []).append(float(v))
    out: Dict[str, Dict[str, float]] = {}
    for phase, vals in by_phase.items():
        vals.sort()
        n = len(vals)

        def pct(q: float) -> float:
            return vals[min(n - 1, int(round(q * (n - 1))))]

        out[phase] = {
            "p50_s": round(pct(0.50), 6),
            "p95_s": round(pct(0.95), 6),
            "p99_s": round(pct(0.99), 6),
            "mean_s": round(sum(vals) / n, 6),
            "count": n,
        }
    return out


def breach_attribution(
    phases_block: Optional[Dict[str, Any]],
    top: int = 3,
    min_share: float = 0.05,
) -> List[Tuple[str, float]]:
    """Top contributing phases by share of windowed request time.

    ``phases_block`` is a metrics-snapshot ``phases`` block (or its
    ``by_phase`` sub-dict, or an :func:`aggregate_phases` result).
    Shares weight each phase by its total windowed seconds (mean ×
    count), so a rare-but-huge phase and a common-but-fat one compare
    honestly. Returns ``[(phase, share), ...]`` best-first, dropping
    slivers under ``min_share``.
    """
    if not phases_block:
        return []
    by_phase = phases_block.get("by_phase", phases_block)
    weights: Dict[str, float] = {}
    for phase, row in by_phase.items():
        if not isinstance(row, dict):
            continue
        w = float(row.get("mean_s", 0.0)) * int(row.get("count", 0))
        if w > 0:
            weights[phase] = w
    total = sum(weights.values())
    if total <= 0:
        return []
    ranked = sorted(
        ((p, w / total) for p, w in weights.items()),
        key=lambda kv: -kv[1],
    )
    return [
        (p, round(s, 4)) for p, s in ranked[:top] if s >= min_share
    ]


def format_attribution(shares: Sequence[Tuple[str, float]]) -> str:
    """``[(phase, share)]`` → ``"kv_fetch 58%, queue 22%"``."""
    return ", ".join(f"{p} {round(100 * s)}%" for p, s in shares)


# -- rendering ----------------------------------------------------------
def render_anatomy(ledger: Dict[str, Any]) -> str:
    """The human face of one ledger (``rlt why``): a timeline table with
    per-phase durations, the process each ran on, the outcome chain,
    and the coverage line."""
    rid = ledger.get("request_id", "?")
    if not ledger.get("found"):
        return f"request {rid}: not found (rings rotated or wrong id?)"
    lines: List[str] = []
    chain = " -> ".join(
        f"{o['outcome']}@{o['process']}" for o in ledger["outcome"]
    ) or "open"
    obs_ms = 1e3 * ledger["observed_s"]
    lines.append(f"request {rid} — outcome: {chain}")
    lines.append(
        "observed %.3f ms = accounted %.3f ms + unaccounted %.3f ms "
        "(coverage %.1f%%%s)"
        % (
            obs_ms,
            1e3 * ledger["accounted_s"],
            1e3 * ledger["unaccounted_s"],
            100 * ledger["coverage"],
            "" if ledger.get("covered") else
            " — BELOW tolerance %.0f%%" % (
                100 * (1 - ledger.get("tolerance", DEFAULT_TOLERANCE))
            ),
        )
    )
    if ledger.get("markers"):
        lines.append("markers: " + ", ".join(ledger["markers"]))
    for note in ledger.get("provenance") or ():
        lines.append("note: " + note)
    header = f"  {'phase':<14} {'process':<12} {'start_ms':>10} {'dur_ms':>10}  detail"
    lines.append(header)
    for row in ledger["phases"]:
        lines.append(
            "  %-14s %-12s %10.3f %10.3f  %s"
            % (
                row["phase"],
                row["process"],
                1e3 * row["start_s"],
                1e3 * row["duration_s"],
                row.get("detail", ""),
            )
        )
    if ledger["unaccounted_s"] > 0:
        lines.append(
            "  %-14s %-12s %10s %10.3f  %s"
            % (
                "unaccounted", "-", "-",
                1e3 * ledger["unaccounted_s"],
                "truncated rings" if ledger.get("truncated") else "",
            )
        )
    tot = ledger.get("totals") or {}
    if tot:
        lines.append(
            "totals: " + "  ".join(
                f"{p}={1e3 * tot[p]:.3f}ms"
                for p in PHASES if p in tot
            )
        )
    return "\n".join(lines)

