"""Workload journal: deterministic capture & replay for serve sessions.

The PyTorch port's copy of ``ray_lightning_tpu/obs/journal.py``: the same
entry and header forms, so a journal captured by either package replays
through the port's scheduler (:func:`build_replay_scheduler` over the
port's ``build_engine``). A header section the port cannot rebuild (the
router, the fleet KV plane, the KV store) is refused naming its ROADMAP
item; the multi-replica router replay waits for the router (item 10).

The serving engine's contracts make execution deterministic given its
inputs — compiles are frozen at construction, greedy output is
bit-identical to solo ``gpt_generate`` regardless of batching/chunking/
spec, and sampled requests draw per-slot rng chains seeded only by
``SamplingParams.seed`` (one split per emitted token, batchmates
independent). The ONLY nondeterminism in a serve session is therefore
the externally-sourced request stream. This module journals exactly
that stream, so any production incident becomes a local repro and any
captured trace doubles as a benchmark:

- :class:`WorkloadJournal` — a bounded in-memory ring (plus optional
  streaming JSONL spill with rotation) of one entry per externally
  sourced input: a config/checkpoint-identity **header**, one
  ``submit`` entry per ``Scheduler.submit`` (prompt tokens, the full
  ``SamplingParams`` including the seed, priority/deadline/tenant/
  request id, monotonic + wall timestamps), one ``cancel`` entry per
  ``Scheduler.cancel``, and one ``outcome`` entry per terminal request
  (the emitted token values + the cost-ledger record, written at the
  ledger close so it rides the same flush as billing).
- :func:`load_journal` — read a journal back from a JSONL file (or a
  spill directory, or replica-tagged ``/journal`` route output).
- :func:`replay_journal` — rebuild an engine/scheduler from the
  recorded header and re-drive the stream, asserting **bit-exact
  per-request token output** against the recorded outcomes with a
  first-divergence report on mismatch; in ``timing="wall"`` mode the
  recorded inter-arrivals are honored and a perf comparison (tokens/s,
  TTFT p50/p95, goodput) against the recorded run's ledger is emitted.

Exposure: ``ServeReplica.journal_dump`` RPC, the ``/journal`` httpd
route, a ``journal.jsonl`` collector in ``obs.blackbox.dump_bundle``
(doctor bundles become replayable), and the ``rlt replay <journal>``
CLI. Hot-path budget matches the tracer/event log: one dict append
under one lock per request lifecycle event — never per token.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

#: Journal schema version (the header carries it; replay checks it).
JOURNAL_VERSION = 1

#: SamplingParams fields a submit entry records (and replay restores).
SAMPLING_FIELDS = (
    "max_new_tokens", "temperature", "top_k", "top_p", "seed", "eos_token",
)


def checkpoint_identity(ckpt_path: Optional[str]) -> Dict[str, Any]:
    """Cheap checkpoint provenance for the header: the path plus file
    size/mtime when it exists — enough to flag "you are replaying
    against a different checkpoint" without hashing gigabytes."""
    out: Dict[str, Any] = {"ckpt_path": ckpt_path}
    if ckpt_path:
        try:
            st = os.stat(ckpt_path)
            out["ckpt_bytes"] = int(st.st_size)
            out["ckpt_mtime"] = round(st.st_mtime, 3)
        except OSError:
            pass
    return out


def engine_header(
    engine: Any,
    *,
    ckpt_path: Optional[str] = None,
    int8: bool = False,
    spec_draft_ckpt: Optional[str] = None,
    spec_draft_config: Optional[Dict[str, Any]] = None,
    spec_draft_int8: bool = False,
    max_prefills_per_step: int = 1,
    max_prefill_chunks_per_step: int = 1,
    priority_age_s: Optional[float] = None,
    router: Optional[Dict[str, Any]] = None,
    kvfleet: Optional[Dict[str, Any]] = None,
    kvstore: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The config/checkpoint-identity header from a live engine: the
    RESOLVED knobs (buckets expanded, chunk coerced, mesh normalized),
    so a replay rebuilds a bit-identical engine even when the recorded
    process took defaults."""
    import dataclasses

    header: Dict[str, Any] = {
        "version": JOURNAL_VERSION,
        "created_wall": time.time(),
        "created_mono": time.monotonic(),
        "model_config": dataclasses.asdict(engine.cfg),
        "int8": bool(int8),
        "engine": {
            "num_slots": engine.num_slots,
            "max_seq": engine.max_seq,
            "prefill_buckets": list(engine.prefill_buckets),
            "decode_fold": engine.decode_fold,
            # Fused-dispatch knobs: a replay must rebuild the same
            # pre-lowered fold ladder and piggyback row budget — the
            # per-dispatch K choice and the chunk-rides-the-fold plan
            # are deterministic functions of the op stream, but only on
            # an engine built with the same knobs.
            "fold_ladder": list(getattr(engine, "fold_ladder", ()) or ()),
            "piggyback_chunks": getattr(engine, "piggyback_chunks", 0),
            "pipeline": engine.pipeline,
            "prefill_chunk": engine.prefill_chunk,
            # Paged engines fold the prefix pool into the page allocator:
            # record the PAGED knobs and zero the prefix ones (the engine
            # rejects the combination, and a replay must rebuild the
            # same paged config — page size shapes alias/evict behavior).
            "prefix_blocks": (
                0 if getattr(engine, "paged", False)
                else engine.prefix_blocks
            ),
            "prefix_block": (
                16 if getattr(engine, "paged", False)
                else engine.prefix_block
            ),
            "kv_page": getattr(engine, "kv_page", 0),
            "kv_pages": getattr(engine, "kv_pages", 0),
            # Tiered prefix-cache knobs: a replay must rebuild the same
            # tier config — hit/miss/spill decisions shape admission
            # timing, and a recorded host-tier hit should hit on replay.
            "prefix_host_mb": getattr(engine, "prefix_host_mb", 0.0),
            "prefix_disk_dir": getattr(engine, "prefix_disk_dir", None),
            "prefix_disk_mb": getattr(engine, "prefix_disk_mb", 0.0),
            "spec": engine.spec,
            "spec_depth": engine.spec_depth,
            "spec_window": engine.spec_window,
            "spec_draft_ckpt": spec_draft_ckpt,
            "spec_draft_config": spec_draft_config,
            "spec_draft_int8": bool(spec_draft_int8),
            # Persistent-store knobs ride the ENGINE section (they are
            # engine ctor params, _ENGINE_REBUILD_KEYS carries them into
            # a replay's build_engine) — replaying against the recorded
            # store dir reproduces recorded store hits.
            "kvstore_dir": getattr(engine, "kvstore_dir", None),
            "kvstore_mb": getattr(engine, "kvstore_mb", 0.0),
            # Model-identity namespace: without it a replay against the
            # recorded store dir would derive a namespace from ITS view
            # of the config and could silently miss (or worse, hit a
            # different model's entries).
            "kvstore_namespace": getattr(engine, "kvstore_namespace", ""),
            "mesh": engine.mesh_desc,
        },
        "scheduler": {
            "max_prefills_per_step": int(max_prefills_per_step),
            "max_prefill_chunks_per_step": int(max_prefill_chunks_per_step),
            "priority_age_s": priority_age_s,
        },
    }
    if router is not None:
        # Router/autoscaler knobs (serve.router.ROUTER_HEADER_KEYS):
        # the driver-side policy that shaped this replica's traffic —
        # provenance a replay surfaces (the single-engine replay itself
        # has no fleet to route over).
        header["router"] = dict(router)
    if kvfleet is not None:
        # Fleet-KV/disagg knobs (serve.kvfleet.KVFLEET_HEADER_KEYS):
        # role + transfer budgets. A disaggregated capture replays on
        # one engine — shipped outcomes are recorded truncations (like
        # the drain's migrations), so the replay stays bit-exact while the
        # section tells the operator what shaped the traffic.
        header["kvfleet"] = dict(kvfleet)
    if kvstore is not None:
        # Persistent-store provenance (serve.kvstore.KVSTORE_HEADER_KEYS):
        # dir/budget/write-through policy — the fleet-shared tier that
        # shaped this capture's hit pattern (`rlt replay` surfaces it as
        # kvstore_config).
        header["kvstore"] = dict(kvstore)
    header.update(checkpoint_identity(ckpt_path))
    return header


class WorkloadJournal:
    """Bounded ring of the externally-sourced serve inputs + outcomes.

    ``capacity`` bounds the in-memory ring (oldest entries rotate out);
    ``spill_dir`` additionally streams every entry to rotating JSONL
    files (``journal-00000.jsonl`` ...), each starting with the header
    line so every kept file is independently replayable. ``spill_keep``
    bounds the rotated set — a long-lived replica cannot fill a disk.
    """

    def __init__(
        self,
        capacity: int = 4096,
        spill_dir: Optional[str] = None,
        spill_max_bytes: int = 8_000_000,
        spill_keep: int = 4,
        enabled: bool = True,
    ) -> None:
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled)
        self.spill_dir = spill_dir
        self.spill_max_bytes = max(1, int(spill_max_bytes))
        self.spill_keep = max(1, int(spill_keep))
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=self.capacity)
        self._header: Optional[Dict[str, Any]] = None
        #: monotonic -> wall mapping for this process (every entry
        #: carries both stamps so a replay can honor inter-arrivals AND
        #: line up with external logs).
        self._wall_offset = time.time() - time.monotonic()
        # Spill state (guarded by the same lock as the ring).
        self._spill_file: Optional[Any] = None
        self._spill_bytes = 0
        self._spill_index = -1

    # -- spill (under self._lock) ----------------------------------------
    def _spill_rotate(self) -> None:
        if self._spill_file is not None:
            self._spill_file.close()
        self._spill_index += 1
        os.makedirs(self.spill_dir, exist_ok=True)
        # Prune: keep the newest ``spill_keep`` files including the one
        # about to open.
        names = sorted(
            n for n in os.listdir(self.spill_dir)
            if n.startswith("journal-") and n.endswith(".jsonl")
        )
        for stale in names[: max(0, len(names) - (self.spill_keep - 1))]:
            try:
                os.remove(os.path.join(self.spill_dir, stale))
            except OSError:
                pass
        path = os.path.join(
            self.spill_dir, f"journal-{self._spill_index:05d}.jsonl"
        )
        self._spill_file = open(path, "w")
        self._spill_bytes = 0
        if self._header is not None:
            line = json.dumps(
                {"kind": "header", **self._header}, default=str
            ) + "\n"
            self._spill_file.write(line)
            self._spill_bytes += len(line)

    def _spill_line(self, entry: Dict[str, Any]) -> None:
        if self.spill_dir is None:
            return
        if (
            self._spill_file is None
            or self._spill_bytes > self.spill_max_bytes
        ):
            self._spill_rotate()
        line = json.dumps(entry, default=str) + "\n"
        self._spill_file.write(line)
        # Flush at terminal entries only (one flush per completed
        # request, not per submit) — the hot-loop budget. The in-memory
        # ring is what crash bundles read, so a buffered submit can at
        # worst go missing from the SPILL of a hard-killed process.
        if entry.get("kind") != "submit":
            self._spill_file.flush()
        self._spill_bytes += len(line)

    def _append(self, entry: Dict[str, Any]) -> None:
        with self._lock:
            self._entries.append(entry)
            self._spill_line(entry)

    def _stamp(self, t_mono: Optional[float]) -> Dict[str, float]:
        t = time.monotonic() if t_mono is None else float(t_mono)
        return {
            "t_mono": round(t, 6),
            "t_wall": round(t + self._wall_offset, 6),
        }

    # -- recording (the scheduler's hooks) --------------------------------
    def set_header(self, header: Dict[str, Any]) -> None:
        with self._lock:
            self._header = dict(header)

    def record_submit(
        self,
        *,
        request_id: str,
        prompt: Iterable[int],
        sampling: Dict[str, Any],
        priority: int = 0,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        t_mono: Optional[float] = None,
    ) -> None:
        if not self.enabled:
            return
        self._append({
            "kind": "submit",
            "request_id": request_id,
            "prompt": [int(t) for t in prompt],
            "sampling": {
                k: sampling.get(k) for k in SAMPLING_FIELDS
            },
            "priority": int(priority),
            "deadline_s": deadline_s,
            "tenant": tenant,
            **self._stamp(t_mono),
        })

    def record_cancel(
        self, request_id: str, known: bool = True,
        t_mono: Optional[float] = None,
    ) -> None:
        if not self.enabled:
            return
        self._append({
            "kind": "cancel",
            "request_id": request_id,
            "known": bool(known),
            **self._stamp(t_mono),
        })

    def record_outcome(
        self, request_id: str, outcome: str,
        cost: Optional[Dict[str, Any]] = None,
        tokens: Optional[List[int]] = None,
        ttft_s: Optional[float] = None,
        phases: Optional[Dict[str, Any]] = None,
    ) -> None:
        """One request reached terminal state: emit its outcome entry —
        the emitted token VALUES the replay asserts against (the
        scheduler accumulates them inline in loops it already runs, so
        the journal adds no per-step pass), plus the cost-ledger record
        and TTFT for the wall-mode perf comparison. ``phases`` is the
        compact anatomy ledger (``{phase: seconds}``) — it makes a
        captured incident autopsy-able offline (``rlt why <journal>
        <id>``) and lets wall-mode replay diff recorded vs replayed
        phase timings."""
        if not self.enabled:
            return
        entry: Dict[str, Any] = {
            "kind": "outcome",
            "request_id": request_id,
            "outcome": outcome,
            "tokens": [int(t) for t in tokens] if tokens else [],
            **self._stamp(None),
        }
        if ttft_s is not None:
            entry["ttft_s"] = round(float(ttft_s), 6)
        if cost is not None:
            entry["cost"] = {
                k: v for k, v in cost.items() if k != "request_id"
            }
        if phases:
            entry["phases"] = dict(phases)
        self._append(entry)

    # -- read side --------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def dump(self, n: Optional[int] = None) -> Dict[str, Any]:
        """The wire form (``ServeReplica.journal_dump`` ships it):
        header + the newest ``n`` entries (all when None)."""
        with self._lock:
            entries = list(self._entries)
            header = dict(self._header) if self._header else None
        if n is not None:
            entries = entries[-int(n):]
        return {"header": header, "entries": entries}

    def to_jsonl(self, n: Optional[int] = None) -> str:
        """The replayable JSONL form: one header line, one entry per
        line (the ``journal.jsonl`` bundle file and ``/journal`` body)."""
        return dump_to_jsonl(self.dump(n))

    def close(self) -> None:
        with self._lock:
            if self._spill_file is not None:
                self._spill_file.close()
                self._spill_file = None


def dump_to_jsonl(
    dump: Dict[str, Any], replica: Optional[int] = None
) -> str:
    """Serialize one journal dump as JSONL; ``replica`` tags every line
    (the multi-replica ``/journal`` route format — ``load_journal``
    filters the tag back out)."""
    lines: List[str] = []
    if dump.get("header") is not None:
        row = {"kind": "header", **dump["header"]}
        if replica is not None:
            row["replica"] = int(replica)
        lines.append(json.dumps(row, default=str))
    for e in dump.get("entries") or []:
        row = dict(e)
        if replica is not None:
            row["replica"] = int(replica)
        lines.append(json.dumps(row, default=str))
    return "\n".join(lines) + ("\n" if lines else "")


def _read_journal_rows(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Parse a journal JSONL file (or spill directory) into raw rows +
    a torn-line count — the shared substrate of ``load_journal`` (one
    replica's stream) and ``load_journal_streams`` (every stream)."""
    paths = [path]
    if os.path.isdir(path):
        paths = [
            os.path.join(path, n)
            for n in sorted(os.listdir(path))
            if n.startswith("journal-") and n.endswith(".jsonl")
        ]
        if not paths:
            raise ValueError(f"no journal-*.jsonl files in {path!r}")
    rows: List[Dict[str, Any]] = []
    torn = 0
    for p in paths:
        with open(p, errors="replace") as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    row = json.loads(ln)
                except ValueError:
                    torn += 1
                    continue
                if not isinstance(row, dict):
                    torn += 1
                    continue
                rows.append(row)
    return rows, torn


def load_journal_streams(path: str) -> List[Dict[str, Any]]:
    """Read EVERY replica stream from a (possibly replica-tagged)
    journal: one ``{"header", "entries", "replica", "torn_lines"}``
    dump per tag, tag order (an untagged journal yields one stream with
    ``replica`` None) — the multi-replica substrate the router replay
    re-drives."""
    rows, torn = _read_journal_rows(path)
    tags: List[Optional[int]] = sorted(
        {r["replica"] for r in rows if "replica" in r}
    ) or [None]
    out: List[Dict[str, Any]] = []
    for tag in tags:
        header = None
        entries: List[Dict[str, Any]] = []
        for r in rows:
            if tag is not None and r.get("replica", tag) != tag:
                continue
            r = {k: v for k, v in r.items() if k != "replica"}
            if r.get("kind") == "header":
                header = {k: v for k, v in r.items() if k != "kind"}
            else:
                entries.append(r)
        out.append({
            "header": header, "entries": entries, "replica": tag,
            "path": path, "torn_lines": torn,
        })
    return out


def load_journal(
    path: str, replica: Optional[int] = None
) -> Dict[str, Any]:
    """Read a journal back: a JSONL file, or a spill DIRECTORY (the
    rotated files concatenate oldest-first). Replica-tagged lines (the
    multi-replica ``/journal`` body) are filtered to ``replica``
    (default: the lowest tag present); untagged journals ignore it.
    Crash consistency: a journal written by a process that died hard
    (fault-injected kill, OOM, SIGKILL) legitimately ends in a TORN
    line — the spill buffer was cut mid-record. Unparseable lines are
    skipped and counted (``torn_lines`` in the result) instead of
    failing the whole load; the replay/failover machinery must be able
    to read exactly the journals that crashes produce.

    Returns ``{"header": ..., "entries": [...], "torn_lines": n}``."""
    rows, torn = _read_journal_rows(path)
    tags = sorted(
        {r["replica"] for r in rows if "replica" in r}
    )
    if tags:
        want = tags[0] if replica is None else int(replica)
        rows = [r for r in rows if r.get("replica", want) == want]
        for r in rows:
            r.pop("replica", None)
    header = None
    entries: List[Dict[str, Any]] = []
    for r in rows:
        if r.get("kind") == "header":
            header = {k: v for k, v in r.items() if k != "kind"}
        else:
            entries.append(r)
    return {
        "header": header, "entries": entries, "path": path,
        "torn_lines": torn,
    }


def incomplete_requests(journal: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The failover set: ``submit`` entries with no terminal ``outcome``
    entry — exactly the requests a crashed replica stranded (the process
    died before ``_acct_close`` flushed them, or the ring rotated the
    outcome away). An outcome-less submit is DATA, not corruption: it
    carries everything a resubmission needs (prompt, full SamplingParams
    including the seed, priority/deadline/tenant), and seed-chained rng
    makes the replayed request emit bit-identical tokens."""
    entries = journal.get("entries") or []
    done = {
        e.get("request_id")
        for e in entries
        if e.get("kind") == "outcome"
    }
    return [
        e for e in entries
        if e.get("kind") == "submit" and e.get("request_id") not in done
    ]


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------
#: engine_header keys build_engine accepts verbatim. The header's
#: ``router`` section (driver-side policy knobs, see
#: serve.router.ROUTER_HEADER_KEYS) rebuilds separately through
#: ``serve.router.router_config_from_header`` — replay surfaces it as
#: ``router_config`` so a replayed capture knows the policy that shaped
#: its traffic.
_ENGINE_REBUILD_KEYS = frozenset((
    "num_slots", "max_seq", "prefill_buckets", "decode_fold", "pipeline",
    "prefill_chunk", "prefix_blocks", "prefix_block", "prefix_host_mb",
    "prefix_disk_dir", "prefix_disk_mb", "kvstore_dir", "kvstore_mb",
    "kv_page", "kv_pages",
    "spec", "spec_depth",
    "spec_window", "spec_draft_ckpt", "spec_draft_config",
    "spec_draft_int8", "mesh",
    "fold_ladder", "piggyback_chunks", "kvstore_namespace",
))


#: Header sections of a fleet capture and the ROADMAP item whose port
#: can rebuild them.
_UNPORTED_SECTIONS = {
    "router": "queue 1 item 10 (router)",
    "kvfleet": "queue 1 item 9 (fleet KV plane)",
    "kvstore": "queue 1 item 9 (KV object store)",
}


def build_replay_scheduler(
    header: Dict[str, Any],
    *,
    ckpt_path: Optional[str] = None,
    model_config: Optional[Dict[str, Any]] = None,
    params: Any = None,
    device: Any = "cuda",
) -> Any:
    """Rebuild an engine + scheduler from a journal header (the replay
    substrate) on ``device``. ``ckpt_path``/``model_config``/``params``
    override the recorded identity — the knob that turns a captured trace
    into a benchmark for a DIFFERENT engine build. An engine knob the port
    does not have raises (``build_engine``), and so does a header section
    of a fleet capture, each naming its ROADMAP item."""
    from ray_lightning_tpu_torch.serve.scheduler import Scheduler
    from ray_lightning_tpu_torch.serve.server import build_engine

    for section, item in _UNPORTED_SECTIONS.items():
        if header.get(section):
            raise NotImplementedError(
                f"journal header section {section!r} is not ported yet "
                f"(ROADMAP {item})"
            )
    eng_cfg = {
        k: v for k, v in (header.get("engine") or {}).items()
        if k in _ENGINE_REBUILD_KEYS
    }
    unknown = sorted(set(header.get("engine") or {}) - _ENGINE_REBUILD_KEYS)
    if unknown:
        raise NotImplementedError(
            f"journal header engine knobs {unknown} have no counterpart in "
            "the port's build_engine"
        )
    engine = build_engine(
        ckpt_path=ckpt_path or header.get("ckpt_path"),
        model_config=(
            model_config if model_config is not None
            else header.get("model_config")
        ),
        params=params,
        int8=bool(header.get("int8", False)),
        device=device,
        **eng_cfg,
    )
    sched_cfg = dict(header.get("scheduler") or {})
    return Scheduler(
        engine,
        max_prefills_per_step=int(
            sched_cfg.get("max_prefills_per_step", 1)
        ),
        max_prefill_chunks_per_step=int(
            sched_cfg.get("max_prefill_chunks_per_step", 1)
        ),
        priority_age_s=sched_cfg.get("priority_age_s"),
    )


def _pct(sorted_vals: List[float], q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(
        len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1)))
    )
    return sorted_vals[idx]


def _recorded_perf(
    entries: List[Dict[str, Any]], outcomes: Dict[str, Dict[str, Any]]
) -> Dict[str, Any]:
    """The recorded run's perf from its own journal: tokens/s over the
    submit->last-outcome span, TTFT percentiles from the outcome
    entries, goodput (sum/sum) from the embedded ledger records."""
    sub_t = [e["t_mono"] for e in entries if e["kind"] == "submit"]
    out_t = [o["t_mono"] for o in outcomes.values()]
    tokens = sum(len(o.get("tokens") or []) for o in outcomes.values())
    span = (max(out_t) - min(sub_t)) if sub_t and out_t else 0.0
    ttfts = sorted(
        o["ttft_s"] for o in outcomes.values() if o.get("ttft_s") is not None
    )
    dev = sum(
        float((o.get("cost") or {}).get("device_s", 0.0))
        for o in outcomes.values()
    )
    return {
        "tokens": tokens,
        "span_s": round(span, 6),
        "tokens_per_sec": round(tokens / span, 3) if span > 0 else None,
        "ttft_p50_s": _pct(ttfts, 0.50),
        "ttft_p95_s": _pct(ttfts, 0.95),
        "goodput_tokens_per_device_s": (
            round(tokens / dev, 3) if dev > 0 else None
        ),
    }


def replay_journal(
    journal: Dict[str, Any],
    *,
    ckpt_path: Optional[str] = None,
    model_config: Optional[Dict[str, Any]] = None,
    params: Any = None,
    scheduler: Any = None,
    timing: str = "virtual",
    max_steps: int = 200_000,
    device: Any = "cuda",
) -> Dict[str, Any]:
    """Re-drive a recorded stream and assert bit-exact token output.

    ``timing="virtual"`` (default) replays as fast as the engine will
    go: submissions land in recorded order and each recorded
    cancellation fires deterministically once its request has emitted
    the recorded token count — so truncated requests compare exactly
    on their recorded prefix and finished requests compare exactly in
    full. ``timing="wall"`` honors the recorded inter-arrival times
    (submits, cancels, and deadlines fire at their recorded offsets)
    and emits a perf comparison against the recorded run's ledger.

    Returns a verdict dict: ``exact`` (every compared request matched),
    ``divergence`` (first mismatch: request id, token index, expected
    vs got) or None, per-request rows, and ``perf`` in wall mode.
    """
    if timing not in ("virtual", "wall"):
        raise ValueError(
            f"timing must be 'virtual' or 'wall', got {timing!r}"
        )
    header = journal.get("header")
    entries = list(journal.get("entries") or [])
    if scheduler is None:
        if header is None:
            raise ValueError(
                "journal has no header; pass a prebuilt scheduler= or "
                "record with a header (ServeReplica journals always do)"
            )
        scheduler = build_replay_scheduler(
            header,
            ckpt_path=ckpt_path,
            model_config=model_config,
            params=params,
            device=device,
        )
    from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

    submits = [e for e in entries if e.get("kind") == "submit"]
    cancels = [e for e in entries if e.get("kind") == "cancel"]
    outcomes = {
        e["request_id"]: e for e in entries if e.get("kind") == "outcome"
    }
    cancelled_rids = {
        e["request_id"] for e in cancels if e.get("known", True)
    }
    replayed: Dict[str, List[int]] = {}
    replay_outcome: Dict[str, str] = {}
    open_rids = [
        e["request_id"] for e in submits
        if e["request_id"] not in outcomes
    ]

    def _submit(entry: Dict[str, Any], deadline_s: Optional[float]) -> None:
        sp = {
            k: v for k, v in (entry.get("sampling") or {}).items()
            if k in SAMPLING_FIELDS and v is not None
        }
        scheduler.submit(
            entry["prompt"],
            SamplingParams(**sp),
            request_id=entry["request_id"],
            priority=int(entry.get("priority", 0)),
            deadline_s=deadline_s,
            tenant=entry.get("tenant"),
        )

    def _harvest(events: Iterable[Any]) -> None:
        for ev in events:
            if ev.token is not None:
                replayed.setdefault(ev.request_id, []).append(
                    int(ev.token)
                )
            if ev.done:
                replay_outcome[ev.request_id] = (
                    "finished" if ev.reason in ("token", "finished")
                    else ev.reason
                )

    t_replay0 = time.monotonic()
    if timing == "virtual":
        # Deterministic truncation: a recorded cancel/expiry fires once
        # its request has emitted the recorded token count, so the
        # recorded prefix is always covered before eviction.
        cancel_after: Dict[str, int] = {}
        done_cancel: set = set()
        for e in submits:
            rid = e["request_id"]
            out = outcomes.get(rid)
            if out is None:
                continue  # in flight at capture; nothing to compare
            k = len(out.get("tokens") or [])
            if out["outcome"] == "finished":
                _submit(e, None)
            elif k > 0:
                _submit(e, None)
                cancel_after[rid] = k
            elif out["outcome"] == "expired":
                # Queued-expired with zero output: an already-past
                # deadline reproduces the expiry deterministically.
                _submit(e, 0.0)
            else:
                _submit(e, None)
                scheduler.cancel(rid)  # queued-cancel path
        steps = 0
        while scheduler.has_work() and steps < max_steps:
            _harvest(scheduler.step())
            steps += 1
            for rid, k in cancel_after.items():
                if rid not in done_cancel and len(
                    replayed.get(rid, [])
                ) >= k:
                    scheduler.cancel(rid)
                    done_cancel.add(rid)
    else:
        # Wall timing: the recorded stream at its recorded pace.
        stream = sorted(
            [e for e in entries if e.get("kind") in ("submit", "cancel")],
            key=lambda e: e.get("t_mono", 0.0),
        )
        base = stream[0]["t_mono"] if stream else 0.0
        idx = 0
        steps = 0
        while (
            idx < len(stream) or scheduler.has_work()
        ) and steps < max_steps:
            now = time.monotonic() - t_replay0
            while idx < len(stream) and (
                stream[idx].get("t_mono", 0.0) - base
            ) <= now:
                e = stream[idx]
                idx += 1
                if e["kind"] == "submit":
                    _submit(e, e.get("deadline_s"))
                elif e.get("known", True):
                    scheduler.cancel(e["request_id"])
            if scheduler.has_work():
                _harvest(scheduler.step())
                steps += 1
            elif idx < len(stream):
                time.sleep(
                    min(
                        0.002,
                        max(
                            0.0,
                            stream[idx]["t_mono"] - base - (
                                time.monotonic() - t_replay0
                            ),
                        ),
                    )
                )
    replay_span = time.monotonic() - t_replay0

    # -- exactness: first divergence in recorded order --------------------
    divergence: Optional[Dict[str, Any]] = None
    rows: List[Dict[str, Any]] = []
    compared = tokens_compared = 0
    for e in submits:
        rid = e["request_id"]
        out = outcomes.get(rid)
        if out is None:
            continue
        want = [int(t) for t in (out.get("tokens") or [])]
        got = replayed.get(rid, [])
        truncated = out["outcome"] != "finished"
        # Wall-mode truncations re-fire at recorded WALL offsets, so the
        # replayed count may differ; only the common prefix is asserted.
        limit = min(len(want), len(got)) if (
            truncated and timing == "wall"
        ) else len(want)
        row_div = None
        for i in range(min(limit, len(got))):
            if want[i] != got[i]:
                row_div = {
                    "request_id": rid, "token_index": i,
                    "expected": want[i], "got": got[i],
                }
                break
        if row_div is None and len(got) < limit:
            row_div = {
                "request_id": rid, "token_index": len(got),
                "expected": want[len(got)], "got": None,
            }
        if row_div is None and not truncated and len(got) > len(want):
            row_div = {
                "request_id": rid, "token_index": len(want),
                "expected": None, "got": got[len(want)],
            }
        compared += 1
        tokens_compared += limit
        rows.append({
            "request_id": rid,
            "outcome_recorded": out["outcome"],
            "outcome_replayed": replay_outcome.get(rid),
            "tokens_recorded": len(want),
            "tokens_replayed": len(got),
            "match": row_div is None,
        })
        if divergence is None and row_div is not None:
            divergence = row_div
    result: Dict[str, Any] = {
        "exact": divergence is None and compared > 0,
        "divergence": divergence,
        "timing": timing,
        "requests": len(submits),
        "compared": compared,
        "open": len(open_rids),
        "tokens_compared": tokens_compared,
        "replay_span_s": round(replay_span, 6),
        "rows": rows,
    }
    if timing == "wall":
        snap = scheduler.metrics.snapshot()
        rep_tokens = sum(len(v) for v in replayed.values())
        recorded = _recorded_perf(entries, outcomes)
        replayed_perf = {
            "tokens": rep_tokens,
            "span_s": round(replay_span, 6),
            "tokens_per_sec": (
                round(rep_tokens / replay_span, 3)
                if replay_span > 0 else None
            ),
            "ttft_p50_s": snap.get("ttft_p50_s"),
            "ttft_p95_s": snap.get("ttft_p95_s"),
            "goodput_tokens_per_device_s": (
                snap.get("cost", {}).get("goodput_tokens_per_device_s")
            ),
        }
        ratio = {}
        for key in ("tokens_per_sec", "goodput_tokens_per_device_s"):
            a, b = replayed_perf.get(key), recorded.get(key)
            if a and b:
                ratio[key] = round(a / b, 4)
        result["perf"] = {
            "recorded": recorded,
            "replayed": replayed_perf,
            "replay_vs_recorded": ratio,
        }
        # Phase-level diff: the recorded outcomes' compact anatomy
        # ledgers vs the ones the replay scheduler just produced —
        # "the incident's kv_fetch was 40x this machine's" is the
        # autopsy answer a throughput ratio can't give.
        rec_phases = [
            o["phases"] for o in outcomes.values()
            if isinstance(o.get("phases"), dict)
        ]
        phase_fn = getattr(scheduler.metrics, "phase_records", None)
        rep_phases = phase_fn() if phase_fn is not None else []
        if rec_phases or rep_phases:
            from ray_lightning_tpu_torch.obs.anatomy import aggregate_phases

            result["perf"]["phases"] = {
                "recorded": aggregate_phases(rec_phases),
                "replayed": aggregate_phases(rep_phases),
            }
    return result

