"""Continuous-batching scheduler: iteration-level admission over a
DecodeEngine, and the request lifecycle record (PyTorch port).

Port of ``ray_lightning_tpu/serve/scheduler.py``. At every step boundary
the scheduler (1) applies queued prefix-block imports and an armed
preemption drain, (2) drops cancelled and expired work, (3) admits queued
requests into free engine slots, bounded by ``max_prefills_per_step`` so a
burst of prompt prefills cannot starve in-flight decode, (4) on a chunked
engine advances up to ``max_prefill_chunks_per_step`` prefill chunks (the
chunk-vs-fold interleave), and (5) runs one decode fold for everything
resident. With the engine's ``piggyback_chunks`` on, step (4) is skipped:
the chunks ride the fold's dispatch, and their completions are read after
it. On a paged engine a request is admitted only when the engine's
allocatable pages cover its whole life; otherwise the queue head waits in
place (backpressure, a ``kv_pages_backpressure`` event per episode), and
an admission never runs out of pages in the engine. Requests carry
per-request sampling params, a priority (lower value is served first; FIFO
within a priority, with optional aging toward priority 0 via
``priority_age_s``), a tenant and an optional deadline.

The lifecycle record, each part off unless given:

- ``tracer`` (``obs/trace.py``): the request's spans, shared with the
  engine (prefill dispatches, chunks, prefix seeds);
- ``events`` (``obs/events.py``): admission bursts, cancels, expiries,
  drains, backpressure, the engine's pool evictions;
- ``journal`` (``obs/journal.py``): every submit and cancel, and each
  terminal request's emitted tokens, the replay substrate;
- ``faults`` (``serve/faults.py``): the named points ``post_admit``,
  ``mid_prefill_chunk``, ``fold_boundary`` and ``post_finish_pre_ack``;
- the cost ledger (always on): per-request queue seconds, chunks, prefix
  hits, folds, speculative shares, emitted tokens and an estimated
  device-seconds share (each step's wall time split over its requests),
  emitted once at the terminal through ``ServeMetrics.record_cost``, with
  the per-request phase ledger (``phase_ledger``, ``obs/anatomy.py``'s
  vocabulary) through ``record_phases`` and the journal.

The preemption drain (:meth:`request_drain`, :meth:`drain_result`)
classifies residents into finish-in-grace and migrate, cancels the migrate
set and the queue, and exports their cached prefix blocks; a survivor
takes them through :meth:`enqueue_prefix_import`.

The fleet KV plane (``kvfleet``, ``serve/kvfleet.py``): a request
submitted with a router's ``kv_hint`` whose chain the local tiers lack is
parked while its blocks are fetched from the peer (or, with ``store:
True``, from the KV object store), re-queued under its original order
when they land, and admitted warm; a refusal, a timeout or a stale entry
re-queues it cold. A request submitted with ``ship_to`` (the router
gives it one on a prefill replica) ends here after its first token: the
prompt's blocks ship to that decode replica and a ``shipped`` terminal is
emitted. With a
``kvstore`` (``serve/kvstore.py``) and ``kvstore_writethrough`` every
completed prefill's chain is written to the store, and
:meth:`request_park` moves an idle conversation's chain there and frees
its pages.

The scheduler owns no threads: ``step()`` is driven by whoever hosts the
engine. ``submit``/``cancel`` are thread-safe; the lock guards only the
queue state, and every engine call runs outside it.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.obs import trace as _trace
from ray_lightning_tpu_torch.serve.metrics import CANARY_TENANT, ServeMetrics

if TYPE_CHECKING:
    from ray_lightning_tpu_torch.obs.events import EventLog
    from ray_lightning_tpu_torch.obs.journal import WorkloadJournal
    from ray_lightning_tpu_torch.obs.trace import RequestTracer
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decode knobs."""

    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    eos_token: Optional[int] = None


@dataclass
class Request:
    prompt: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: str = ""
    priority: int = 0
    #: Tenant/API-key label: rides into the cost ledger (None bills to the
    #: "default" tenant).
    tenant: Optional[str] = None
    #: Relative deadline in seconds from submission; queued requests past
    #: it are expired, in-flight ones are cancelled at the next boundary.
    deadline_s: Optional[float] = None
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    #: Fleet KV plane: the router's warm-peer hint (``{"peer": idx,
    #: "digests": [hex, ...]}``, or ``{"store": True, ...}`` for the KV
    #: object store). When the local tiers miss, admission parks the
    #: request and fetches the chain instead of prefilling cold. Consumed
    #: after one attempt; a timeout or a stale entry falls back to cold.
    kv_hint: Optional[Dict[str, Any]] = None
    #: Disaggregated prefill: the decode replica this request's finished
    #: prefill ships to (prefill role). None decodes here.
    ship_to: Optional[int] = None

    def expired(self, now: float) -> bool:
        return (
            self.deadline_s is not None
            and now - self.submitted_at > self.deadline_s
        )


@dataclass(frozen=True)
class TokenEvent:
    """One scheduler-step outcome for one request."""

    request_id: str
    token: Optional[int]  # None for lifecycle-only events
    done: bool
    #: "token" | "finished" | "cancelled" | "expired" | "migrated" |
    #: "shipped" ("migrated": evicted by a preemption drain for
    #: resubmission on a survivor; "shipped": a prefill-role completion
    #: whose blocks went to ``ship_to``, where the client resubmits it.
    #: Both are terminal on this engine, not for the request).
    reason: str = "token"
    #: The decode replica a "shipped" request's blocks went to.
    ship_to: Optional[int] = None
    #: The shipped digest chain (hexes): the client's resubmission carries
    #: it back as a fetch hint, so a lost ship fetches from the shipper
    #: instead of prefilling cold.
    ship_digests: Optional[List[str]] = None


class Scheduler:
    def __init__(
        self,
        engine: "DecodeEngine",
        metrics: Optional[ServeMetrics] = None,
        max_prefills_per_step: int = 1,
        max_prefill_chunks_per_step: int = 1,
        priority_age_s: Optional[float] = None,
        tracer: Optional["RequestTracer"] = None,
        events: Optional["EventLog"] = None,
        journal: Optional["WorkloadJournal"] = None,
        faults: Optional[Any] = None,
        kvfleet: Optional[Any] = None,
        role: str = "mixed",
        kvstore: Optional[Any] = None,
        kvstore_writethrough: bool = False,
    ) -> None:
        self.engine = engine
        #: Fleet KV plane (serve/kvfleet.py:KVFleetPlane): cross-replica
        #: prefix fetches and disaggregated shipping; None is the isolated
        #: engine. ``role`` labels the phase records (mixed, prefill or
        #: decode).
        self.kvfleet = kvfleet
        self.role = str(role)
        #: KV object store (serve/kvstore.py:FleetKVStore): with
        #: ``kvstore_writethrough`` every completed prefill's chain is
        #: written there; session parking writes there too.
        self.kvstore = kvstore
        self.kvstore_writethrough = bool(kvstore_writethrough)
        self.role = str(role)
        self.faults = faults
        self.metrics = metrics or ServeMetrics(engine.num_slots)
        self.metrics.set_role(self.role)
        #: Request tracer, shared with the engine for its own spans.
        self.tracer = tracer
        if tracer is not None and engine.tracer is None:
            engine.tracer = tracer
        # The plane records the marks only it sees (a ship landing) and
        # reports its fault point through this scheduler's tracer and
        # injector.
        if kvfleet is not None:
            if kvfleet.tracer is None:
                kvfleet.tracer = tracer
            if kvfleet.faults is None:
                kvfleet.faults = faults
        #: Per-request phase ledger, folded from the lifecycle timestamps
        #: at each terminal (a handful of float subtractions); set False
        #: to measure the record's cost with every observer off.
        self.phase_ledger = True
        #: Structured event log, shared with the engine for its pool
        #: evictions: one event per occurrence, never per token.
        self.events = events
        if events is not None and engine.events is None:
            engine.events = events
        #: Workload journal; token values accumulate inline in step()'s
        #: loops and flush at the ledger close.
        self.journal = journal
        self._jr_tokens: Dict[str, List[int]] = {}
        self._jr_ttft: Dict[str, float] = {}
        self.max_prefills_per_step = max(1, int(max_prefills_per_step))
        #: Chunk-vs-fold interleave budget: prefill chunks advanced per
        #: step (chunked engines only).
        self.max_prefill_chunks_per_step = max(
            1, int(max_prefill_chunks_per_step)
        )
        #: Aging rate: a queued request's effective priority drops by 1
        #: toward 0 every ``priority_age_s`` seconds, so low-priority work
        #: cannot starve forever. None = pure (priority, seq) ordering.
        self.priority_age_s = (
            None if priority_age_s is None else float(priority_age_s)
        )
        self._lock = threading.RLock()
        self._seq = itertools.count()
        #: (priority, seq, Request) min-heap: FIFO within a priority.
        self._pending: List[Any] = []
        self._cancelled: set = set()
        #: Subset of _cancelled evicted by a preemption drain: their
        #: terminal events read "migrated".
        self._migrating: set = set()
        self._slot_req: Dict[int, Request] = {}
        #: Requests popped for admission but not yet in _slot_req (admit
        #: runs outside the lock); cancel() must still find them.
        self._admitting: set = set()
        #: The engine's cumulative prefix-tier, page and spec counters at
        #: the last diff.
        self._prefix_seen: Dict[str, Dict[str, int]] = {}
        self._kv_seen: Dict[str, int] = {}
        self._spec_seen = (0, 0, 0)
        #: Steps whose queue head waited for KV pages (paged engines), and
        #: the latch that fires the backpressure event once per episode.
        self.kv_backpressure_steps = 0
        self._kv_parked = False
        #: Cost ledger: request_id -> the accounting record, from submit to
        #: terminal.
        self._acct: Dict[str, Dict[str, Any]] = {}
        #: Preemption drain: the armed budget (s) the next step() consumes,
        #: and the plan it produced.
        self._drain_req: Optional[float] = None
        self._drain_result: Optional[Dict[str, Any]] = None
        self._drain_cv = threading.Condition()
        #: Peer prefix blocks queued for import at the top of step().
        self._pending_imports: List[Any] = []
        #: Requests parked while their blocks are fetched: request_id ->
        #: (priority, seq, Request). They re-queue under their original
        #: (priority, seq) when the fetch lands or fails.
        self._transfer_pending: Dict[str, Any] = {}
        #: Session parking: the armed park (tokens, request_id) the next
        #: step() consumes, and its record.
        self._park_req: Optional[Any] = None
        self._park_result: Optional[Dict[str, Any]] = None
        self._park_cv = threading.Condition()

    # -- cost ledger ------------------------------------------------------
    def _acct_open(self, req: Request) -> None:
        self._acct[req.request_id] = {
            "request_id": req.request_id,
            "tenant": req.tenant,
            "prompt_tokens": len(req.prompt),
            "submitted_at": req.submitted_at,
            "queue_s": 0.0,
            "prefill_chunks": 0,
            "prefix_hit_tokens": 0,
            "decode_folds": 0,
            "spec_verifies": 0.0,
            "spec_accepted_tokens": 0.0,
            "emitted_tokens": 0,
            "device_s": 0.0,
        }

    def _acct_close(self, rid: str, outcome: str) -> None:
        """Finalize one request's ledger record and emit it (metrics
        window, registry series, a typed event, the journal outcome). Safe
        for unknown ids."""
        rec = self._acct.pop(rid, None)
        if rec is None:
            return
        rec["outcome"] = outcome
        rec["total_s"] = round(time.monotonic() - rec.pop("submitted_at"), 6)
        rec["queue_s"] = round(rec["queue_s"], 6)
        rec["device_s"] = round(rec["device_s"], 6)
        rec["spec_verifies"] = round(rec["spec_verifies"], 3)
        rec["spec_accepted_tokens"] = round(rec["spec_accepted_tokens"], 3)
        # The stashes pop out of the record whether or not the ledger is
        # on. A fetched request's queue time splits into kv_fetch (park to
        # land) and transfer_park (land to admission).
        fetch_s = rec.pop("_kv_fetch_s", 0.0)
        land_t = rec.pop("_kv_land_t", None)
        kv_src = rec.pop("_kv_src", None)
        rec.pop("_kv_park_t", None)
        admit_t = rec.pop("_admit_t", None)
        ttft = rec.pop("_ttft_s", None)
        phases: Optional[Dict[str, Any]] = None
        if self.phase_ledger:
            park_s = (
                max(0.0, admit_t - land_t)
                if admit_t is not None and land_t is not None
                else 0.0
            )
            phases = {"queue": max(0.0, rec["queue_s"] - fetch_s - park_s)}
            if fetch_s > 0.0:
                phases["kv_fetch"] = fetch_s
                if kv_src:
                    phases["kv_fetch_source"] = kv_src
            if park_s > 0.0:
                phases["transfer_park"] = park_s
            if ttft is not None:
                phases["prefill"] = max(0.0, ttft - rec["queue_s"])
                tail = max(0.0, rec["total_s"] - ttft)
                phases["ship" if outcome == "shipped" else "decode"] = tail
            phases = {
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in phases.items()
            }
            self.metrics.record_phases(
                phases, tenant=rec["tenant"], outcome=outcome
            )
        self.metrics.record_cost(rec)
        self._event(
            "request_cost",
            request_id=rid,
            tenant=rec["tenant"] or "default",
            outcome=outcome,
            emitted_tokens=rec["emitted_tokens"],
            device_s=rec["device_s"],
            queue_s=rec["queue_s"],
        )
        if self.journal is not None:
            self.journal.record_outcome(
                rid, outcome, cost=rec,
                tokens=self._jr_tokens.pop(rid, None),
                ttft_s=self._jr_ttft.pop(rid, None),
                phases=phases,
            )

    def _trace(
        self, rid: str, span: str, t: Optional[float] = None, **attrs: Any
    ) -> None:
        if self.tracer is not None:
            self.tracer.event(rid, span, t=t, attrs=attrs or None)

    def _event(self, name: str, level: str = "info", **kv: Any) -> None:
        if self.events is not None:
            self.events.record("scheduler", name, level=level, **kv)

    def _fault(self, point: str) -> None:
        if self.faults is not None:
            self.faults.hit(point)

    # -- intake (thread-safe) --------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        *,
        request_id: Optional[str] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        tenant: Optional[str] = None,
        kv_hint: Optional[Dict[str, Any]] = None,
        ship_to: Optional[int] = None,
    ) -> str:
        """Queue a request; returns its id. Rejects (ValueError) requests
        that can never fit the engine, instead of queueing them to fail.

        ``kv_hint`` and ``ship_to`` are the fleet KV plane's placement
        hints (see :class:`Request`): routing metadata, not the request's
        identity, so the journal does not record them, and a failover
        resubmission or a replay decodes locally."""
        sampling = sampling or SamplingParams()
        prompt = [int(t) for t in prompt]
        if not prompt or sampling.max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens >= 1")
        self.engine.check_prompt_len(len(prompt))
        if len(prompt) + sampling.max_new_tokens > self.engine.max_seq:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({sampling.max_new_tokens}) exceeds engine max_seq "
                f"{self.engine.max_seq}"
            )
        req = Request(
            prompt=prompt,
            sampling=sampling,
            request_id=request_id or uuid.uuid4().hex[:12],
            priority=int(priority),
            deadline_s=deadline_s,
            submitted_at=time.monotonic(),
            tenant=tenant,
            kv_hint=dict(kv_hint) if kv_hint else None,
            ship_to=None if ship_to is None else int(ship_to),
        )
        with self._lock:
            heapq.heappush(
                self._pending, (req.priority, next(self._seq), req)
            )
            depth = self._organic_depth_locked()
            self.metrics.record_submit(depth)
            self._acct_open(req)
        if self.journal is not None:
            s = req.sampling
            self.journal.record_submit(
                request_id=req.request_id,
                prompt=req.prompt,
                sampling={
                    "max_new_tokens": s.max_new_tokens,
                    "temperature": s.temperature,
                    "top_k": s.top_k,
                    "top_p": s.top_p,
                    "seed": s.seed,
                    "eos_token": s.eos_token,
                },
                priority=req.priority,
                deadline_s=req.deadline_s,
                tenant=req.tenant,
                t_mono=req.submitted_at,
            )
        if self.tracer is not None:
            self.tracer.event(
                req.request_id, _trace.SPAN_SUBMIT, t=req.submitted_at,
                attrs={"prompt_tokens": len(prompt), "priority": req.priority},
            )
            self.tracer.event(
                req.request_id, _trace.SPAN_QUEUED,
                attrs={"queue_depth": depth},
            )
        return req.request_id

    def cancel(self, request_id: str) -> bool:
        """Mark a request cancelled; queued ones are dropped and in-flight
        ones evicted at the next step boundary. Returns whether the id was
        known (queued or in flight)."""
        with self._lock:
            known = (
                request_id in self._admitting
                or request_id in self._transfer_pending
                or any(r.request_id == request_id for _, _, r in self._pending)
                or any(
                    r.request_id == request_id
                    for r in self._slot_req.values()
                )
            )
            if known:
                self._cancelled.add(request_id)
        if self.journal is not None:
            self.journal.record_cancel(request_id, known)
        return known

    def queue_depth(self) -> int:
        """Organic queue depth: pending requests less the reserved canary
        tenant's."""
        with self._lock:
            return self._organic_depth_locked()

    def _organic_depth_locked(self) -> int:
        return sum(
            1 for _, _, r in self._pending if r.tenant != CANARY_TENANT
        )

    def has_work(self) -> bool:
        with self._lock:
            if (
                bool(self._pending)
                or self.engine.num_active > 0
                or self._drain_req is not None
                or self._park_req is not None
                or bool(self._pending_imports)
                or bool(self._transfer_pending)
            ):
                return True
        # The plane's inbox is probed outside the lock: it may cross a
        # process boundary.
        return self.kvfleet is not None and self.kvfleet.pending()

    # -- preemption drain (thread-safe arm/wait; work runs in step()) -----
    def request_drain(self, budget_s: float) -> None:
        """Arm a graceful drain: the next step() classifies in-flight work
        into finish-in-grace and migrate (cancelling and exporting the
        migrate set) and publishes the plan for :meth:`drain_result`."""
        with self._lock:
            self._drain_req = float(budget_s)

    def drain_result(
        self, timeout: Optional[float] = 10.0
    ) -> Optional[Dict[str, Any]]:
        """Block until the armed drain's plan is ready (None on timeout);
        consumes the plan."""
        with self._drain_cv:
            if self._drain_result is None:
                self._drain_cv.wait(timeout)
            plan, self._drain_result = self._drain_result, None
            return plan

    # -- session parking (thread-safe arm/wait; work runs in step()) -----
    def request_park(self, tokens: Sequence[int],
                     request_id: Optional[str] = None) -> None:
        """Arm a session park: the next step() exports the conversation's
        cached chain (``tokens``: prompt and generated tokens), writes it
        to the KV object store and frees the local pages only if every
        block was stored (a partial write keeps them: lost loudly, never
        silently). The next turn hits the chain back through a store
        fetch, on any replica."""
        with self._lock:
            self._park_req = ([int(t) for t in tokens], request_id)

    def park_result(
        self, timeout: Optional[float] = 10.0
    ) -> Optional[Dict[str, Any]]:
        """Block until the armed park's record is ready (None on
        timeout); consumes the record."""
        with self._park_cv:
            if self._park_result is None:
                self._park_cv.wait(timeout)
            out, self._park_result = self._park_result, None
            return out

    def _apply_park(self) -> None:
        """Consume an armed park (inside step()): export, write to the
        store, free the local copies."""
        with self._lock:
            req, self._park_req = self._park_req, None
        if req is None:
            return
        tokens, rid = req
        blocks: List[Any] = []
        stored = freed = 0
        if self.engine.prefix_blocks:
            blocks = self.engine.export_prefix_blocks(tokens)
        if blocks and self.kvstore is not None:
            stored = self.kvstore.put_blocks(blocks)
            if stored == len(blocks):
                freed = self.engine.evict_prefix_chain([b[0] for b in blocks])
        result = {
            "digests": [b[0] for b in blocks],
            "blocks": len(blocks),
            "stored": stored,
            "freed": freed,
        }
        if rid is not None:
            self._trace(rid, _trace.SPAN_KV_PARK, blocks=len(blocks),
                        stored=stored, freed=freed)
        self._event(
            "kv_park", level="info" if stored == len(blocks) else "warn",
            request_id=rid, blocks=len(blocks), stored=stored, freed=freed,
        )
        with self._park_cv:
            self._park_result = result
            self._park_cv.notify_all()

    def enqueue_prefix_import(self, blocks: Any) -> int:
        """Queue a peer's exported prefix blocks for import at the top of
        the next step() (engine state changes on the loop thread only).
        Returns the number of blocks queued."""
        with self._lock:
            self._pending_imports.append(blocks)
        return len(blocks)

    def _service_kvfleet(self) -> None:
        """One pump of the fleet KV plane (loop thread): answer peers'
        fetches, import inbound ships and fetch replies, and re-queue the
        parked requests whose transfer landed (warm) or failed (cold)."""
        eng = self.engine
        svc = self.kvfleet.service(
            export_fn=eng.export_blocks_by_digest,
            import_fn=eng.import_prefix_blocks,
            layer_import_fn=eng.import_prefix_block_layer,
            abort_fn=eng.abort_layer_imports,
        )
        resumed: List[Tuple[str, str]] = []
        store_rids = set(svc.get("store_fetched") or ())
        with self._lock:
            for rid, _n in svc["fetched"]:
                entry = self._transfer_pending.pop(rid, None)
                if entry is not None:
                    # The blocks are in the pool: the request re-queues
                    # under its original (priority, seq) and hits warm.
                    heapq.heappush(self._pending, entry)
                    resumed.append((rid, "warm"))
        for rid in store_rids:
            self._trace(rid, _trace.SPAN_KV_RESTORE)
        with self._lock:
            for rid, reason in svc["failed"]:
                entry = self._transfer_pending.pop(rid, None)
                if entry is not None:
                    heapq.heappush(self._pending, entry)
                    resumed.append((rid, reason))
        t_land = time.monotonic()
        for rid, how in resumed:
            # The transfer settled: this closes the ledger's kv_fetch
            # phase; land to admission becomes transfer_park.
            acct = self._acct.get(rid)
            src = "store" if rid in store_rids else (
                (acct or {}).get("_kv_src") or "peer"
            )
            if acct is not None and "_kv_park_t" in acct:
                acct["_kv_fetch_s"] = t_land - acct["_kv_park_t"]
                acct["_kv_land_t"] = t_land
            self._trace(
                rid, _trace.SPAN_KV_LAND, t=t_land, source=src,
                ok=how == "warm",
                **({} if how == "warm" else {"reason": how}),
            )
            self._event(
                "kv_transfer_resume",
                level="info" if how == "warm" else "warn",
                request_id=rid, outcome=how,
            )

    def _apply_drain(self, events: List[TokenEvent]) -> None:
        """Consume an armed drain (inside step()). A resident request whose
        estimated completion fits in half the grace window runs to
        completion; the other residents and the whole queue are cancelled
        and listed as the migrate set, each with its prompt's cached
        prefix blocks. With no decode-rate sample everything migrates."""
        with self._lock:
            budget = self._drain_req
            if budget is None:
                return
            self._drain_req = None
            rate = float(
                self.metrics.snapshot().get("decode_tokens_per_sec") or 0.0
            )
            resident = list(self._slot_req.values())
            n_res = max(1, len(resident))
            finish: List[str] = []
            migrate: List[Request] = []
            for req in resident:
                acct = self._acct.get(req.request_id) or {}
                left = max(
                    0,
                    req.sampling.max_new_tokens
                    - int(acct.get("emitted_tokens", 0)),
                )
                est = (left * n_res / rate) if rate > 0 else None
                if est is not None and est <= 0.5 * budget:
                    finish.append(req.request_id)
                else:
                    migrate.append(req)
                    # The boundary eviction scan of this same step evicts
                    # it; _migrating makes its terminal read "migrated".
                    self._cancelled.add(req.request_id)
                    self._migrating.add(req.request_id)
            queued = [r for _, _, r in self._pending]
            # Parked transfers are queued work too: their fetches die with
            # this replica (a late reply is discarded).
            queued += [r for _, _, r in self._transfer_pending.values()]
            self._pending = []
            self._transfer_pending = {}
            for req in queued:
                self._cancelled.discard(req.request_id)
                migrate.append(req)
                self.metrics.record_cancel(queue_depth=0)
                self._trace(req.request_id, _trace.SPAN_CANCEL)
                self._acct_close(req.request_id, "migrated")
                events.append(
                    TokenEvent(req.request_id, None, True, "migrated")
                )
        if self.journal is not None:
            # A drain's cancel looks like any other cancel to a replay.
            for req in migrate:
                self.journal.record_cancel(req.request_id, True)
        # A tensor-parallel gang's export gathers whole blocks, so its
        # migrants leave warm too.
        export = getattr(self.engine, "prefix_blocks", 0) > 0
        plan = {
            "budget_s": budget,
            "finish": finish,
            "migrate": [
                {
                    "request_id": req.request_id,
                    "blocks": (self.engine.export_prefix_blocks(req.prompt)
                               if export else []),
                }
                for req in migrate
            ],
        }
        self._event(
            "drain_plan", level="warn",
            budget_s=round(budget, 3), finish=len(finish),
            migrate=len(migrate),
            kv_blocks=sum(len(m["blocks"]) for m in plan["migrate"]),
        )
        with self._drain_cv:
            self._drain_result = plan
            self._drain_cv.notify_all()

    # -- the loop ---------------------------------------------------------
    def step(self) -> List[TokenEvent]:
        """One iteration: apply imports and an armed drain, evict
        cancelled/expired, admit (bounded), advance prefill chunks
        (chunked engines, bounded), run one engine fold. Queue decisions
        happen under the lock; every engine call runs outside it."""
        events: List[TokenEvent] = []
        t0 = time.monotonic()
        with self._lock:
            imports, self._pending_imports = self._pending_imports, []
        for blocks in imports:
            self.engine.import_prefix_blocks(blocks)
        if self.kvfleet is not None:
            # Before the admission scan, so a shipped or fetched chain is
            # in the pool when its request is admitted.
            self._service_kvfleet()
        if self._drain_req is not None:
            self._apply_drain(events)
        if self._park_req is not None:
            self._apply_park()
        to_evict: List[Any] = []
        admits: List[Request] = []
        #: (priority, seq, Request, peer, digests): candidates popped for
        #: a fetch instead of admission (the fetch request is sent outside
        #: the lock; a refusal re-queues them for a cold prefill).
        to_fetch: List[Any] = []
        #: (rid, outcome) terminals of this step's engine work; their
        #: ledger records close after the step's device-seconds are
        #: attributed, so a request's last fold is in its bill.
        closed: List[Tuple[str, str]] = []
        with self._lock:
            resident_rids = [r.request_id for r in self._slot_req.values()]
            if self.priority_age_s is not None and self._pending:
                self._pending = [
                    (
                        max(
                            0,
                            r.priority
                            - int((t0 - r.submitted_at) / self.priority_age_s),
                        ),
                        s,
                        r,
                    )
                    for _, s, r in self._pending
                ]
                heapq.heapify(self._pending)
            for slot, req in list(self._slot_req.items()):
                rid = req.request_id
                cancelled = rid in self._cancelled
                if cancelled or req.expired(t0):
                    del self._slot_req[slot]
                    self._cancelled.discard(rid)
                    if rid in self._migrating:
                        self._migrating.discard(rid)
                        kind = "migrated"
                    else:
                        kind = "cancelled" if cancelled else "expired"
                    to_evict.append((slot, req, kind))
            budget = min(
                self.max_prefills_per_step,
                len(self.engine.free_slots()) + len(to_evict),
            )
            # A paged engine adds a page budget: the head is admitted only
            # while the allocatable pages cover its whole life, else it
            # waits in place (priority order kept) for residents to finish.
            paged = getattr(self.engine, "paged", False)
            pages_left = self.engine.pages_available() if paged else 0
            parked = False
            while len(admits) < budget and self._pending:
                prio, seqno, req = self._pending[0]
                rid = req.request_id
                if rid in self._cancelled:
                    heapq.heappop(self._pending)
                    self._cancelled.discard(rid)
                    self.metrics.record_cancel(
                        queue_depth=self._organic_depth_locked()
                    )
                    self._trace(rid, _trace.SPAN_CANCEL)
                    self._event("cancel", request_id=rid, where="queued")
                    self._acct_close(rid, "cancelled")
                    events.append(TokenEvent(rid, None, True, "cancelled"))
                    continue
                if req.expired(t0):
                    heapq.heappop(self._pending)
                    self.metrics.record_expire(
                        queue_depth=self._organic_depth_locked()
                    )
                    self._trace(rid, _trace.SPAN_EXPIRE)
                    self._event("expire", level="warn", request_id=rid,
                                where="queued")
                    self._acct_close(rid, "expired")
                    events.append(TokenEvent(rid, None, True, "expired"))
                    continue
                if self.kvfleet is not None and req.kv_hint is not None:
                    # A peer (or, with "store", the object store) holds
                    # this prompt's chain. One attempt per request (the
                    # hint is consumed), and only when the local tiers
                    # hold less than the hint promises (a host-side probe,
                    # safe under the lock).
                    hint, req.kv_hint = req.kv_hint, None
                    digests = list(hint.get("digests") or [])
                    peer = hint.get("peer")
                    from_store = bool(hint.get("store"))
                    if (
                        digests
                        and (peer is not None or from_store)
                        and self.engine.prefix_blocks
                        and self.engine.cached_prefix_blocks(req.prompt)
                        < len(digests)
                    ):
                        heapq.heappop(self._pending)
                        to_fetch.append((
                            prio, seqno, req,
                            None if from_store else int(peer), digests,
                        ))
                        continue
                if paged:
                    need = self.engine.pages_for(
                        len(req.prompt), req.sampling.max_new_tokens
                    )
                    if need > pages_left:
                        parked = True
                        break
                    pages_left -= need
                heapq.heappop(self._pending)
                admits.append(req)
                self._admitting.add(rid)
            if parked and not self._kv_parked:
                self._event(
                    "kv_pages_backpressure", level="warn",
                    queue_depth=len(self._pending),
                    pages_available=pages_left,
                )
            self._kv_parked = parked
            self.kv_backpressure_steps += int(parked)
        for prio, seqno, req, peer, digests in to_fetch:
            # The fetch request (a queue put, maybe across processes) goes
            # out here; a refusal (a budget, an unknown peer) re-queues the
            # request for a cold prefill next step. ``peer`` None reads the
            # object store instead of a live replica.
            ok = (
                self.kvfleet.request_store_fetch(req.request_id, digests)
                if peer is None
                else self.kvfleet.request_fetch(req.request_id, peer, digests)
            )
            if ok:
                with self._lock:
                    self._transfer_pending[req.request_id] = (prio, seqno, req)
                acct = self._acct.get(req.request_id)
                if acct is not None:
                    acct["_kv_park_t"] = time.monotonic()
                    acct["_kv_src"] = "store" if peer is None else "peer"
                self._trace(
                    req.request_id,
                    _trace.SPAN_KVSTORE_FETCH if peer is None
                    else _trace.SPAN_KV_FETCH,
                    peer=peer, blocks=len(digests),
                )
                self._event(
                    "kv_transfer_park", request_id=req.request_id,
                    peer=peer, blocks=len(digests), store=peer is None,
                )
            else:
                with self._lock:
                    heapq.heappush(self._pending, (prio, seqno, req))
        # -- engine work, lock NOT held --------------------------------
        for slot, req, kind in to_evict:
            self.engine.release(slot)
            (
                self.metrics.record_expire
                if kind == "expired"
                else self.metrics.record_cancel
            )(queue_depth=self.queue_depth())
            self._trace(
                req.request_id,
                _trace.SPAN_EXPIRE if kind == "expired" else _trace.SPAN_CANCEL,
                slot=slot,
            )
            self._event(
                "expire" if kind == "expired" else "cancel",
                level="warn" if kind == "expired" else "info",
                request_id=req.request_id, where="slot", slot=slot,
                migrated=kind == "migrated",
            )
            closed.append((req.request_id, kind))
            events.append(TokenEvent(req.request_id, None, True, kind))
        newly: Dict[int, Request] = {}
        finished_rids: List[str] = []
        finished_slots: List[int] = []
        admit_tokens = 0
        if admits:
            t_admit = time.monotonic()
            results = self.engine.admit_many(
                [
                    dict(
                        prompt=req.prompt,
                        request_id=req.request_id,
                        max_new_tokens=req.sampling.max_new_tokens,
                        temperature=req.sampling.temperature,
                        top_k=req.sampling.top_k,
                        top_p=req.sampling.top_p,
                        seed=req.sampling.seed,
                        eos_token=req.sampling.eos_token,
                    )
                    for req in admits
                ]
            )
            # One event per burst, not per admission.
            self._event("admit_burst", n=len(admits),
                        queue_depth=self.queue_depth())
            for req, (slot, first_tok, done) in zip(admits, results):
                req.admitted_at = t_admit
                self.metrics.record_admit(
                    t_admit - req.submitted_at, self.queue_depth()
                )
                acct = self._acct.get(req.request_id)
                if acct is not None:
                    acct["queue_s"] = t_admit - req.submitted_at
                    acct["_admit_t"] = t_admit
                # Record-time timestamp: the engine's own admission spans
                # (prefix_seed, prefill) land before this one, and a
                # trace's timestamps must be monotonic in record order.
                self._trace(
                    req.request_id, _trace.SPAN_ADMITTED, slot=slot,
                    queue_s=round(t_admit - req.submitted_at, 6),
                )
                if first_tok is None:
                    newly[slot] = req  # chunked prefill in progress
                    continue
                now = time.monotonic()
                admit_tokens += 1
                self.metrics.record_first_token(
                    now - req.submitted_at, now - t_admit, 1, 0,
                    len(req.prompt),
                )
                self._trace(
                    req.request_id, _trace.SPAN_FIRST_TOKEN, t=now,
                    ttft_s=round(now - req.submitted_at, 6),
                )
                if acct is not None:
                    acct["emitted_tokens"] += 1
                    acct["_ttft_s"] = now - req.submitted_at
                if self.journal is not None:
                    self._jr_tokens[req.request_id] = [int(first_tok)]
                    self._jr_ttft[req.request_id] = now - req.submitted_at
                events.append(
                    TokenEvent(
                        req.request_id, first_tok, done,
                        "finished" if done else "token",
                    )
                )
                if done:
                    self.metrics.record_finish(queue_depth=self.queue_depth())
                    self._trace(req.request_id, _trace.SPAN_FINISH)
                    finished_rids.append(req.request_id)
                    closed.append((req.request_id, "finished"))
                else:
                    newly[slot] = req
            # Requests hold slots; chunked ones have no first token yet.
            self._fault("post_admit")
        # Chunked prefills advance between the admissions and the fold, or,
        # piggybacked, inside the fold's dispatch: their completions are
        # read after it and finish the same way.
        piggyback = getattr(self.engine, "piggyback_chunks", 0) > 0
        prefilling = getattr(self.engine, "num_prefilling", 0)
        chunk_events: List[Any] = []
        prefilled = 0
        if not piggyback:
            chunk_events = self.engine.prefill_step(
                self.max_prefill_chunks_per_step
            )
            prefilled = self._finish_prefills(
                chunk_events, newly, events, finished_rids, finished_slots,
                closed,
            )
            if chunk_events or prefilling:
                # A multi-chunk prompt is part-way through its prefill.
                self._fault("mid_prefill_chunk")
        active = self.engine.num_active
        fold_results = self.engine.step()
        if piggyback:
            pb_events = self.engine.pop_chunk_events()
            if pb_events:
                chunk_events = pb_events
                prefilled = self._finish_prefills(
                    pb_events, newly, events, finished_rids, finished_slots,
                    closed, piggyback=True,
                )
            if pb_events or prefilling:
                self._fault("mid_prefill_chunk")
        # Tokens per request this fold: the granularity of the decode
        # spans, the spec attribution and the cost ledger.
        fold_tokens: Dict[str, int] = {}
        for _, rid, _, _ in fold_results:
            fold_tokens[rid] = fold_tokens.get(rid, 0) + 1
        self._diff_counters(fold_tokens)
        for rid, n in fold_tokens.items():
            acct = self._acct.get(rid)
            if acct is not None:
                acct["decode_folds"] += 1
                acct["emitted_tokens"] += n
        if self.tracer is not None:
            # One span per request per fold (never per token), before the
            # finish spans, so a trace's folds precede its terminal.
            for rid, n in fold_tokens.items():
                self.tracer.event(
                    rid, _trace.SPAN_DECODE_FOLD, attrs={"tokens": n}
                )
        jr_on = self.journal is not None
        for slot, rid, tok, done in fold_results:
            if jr_on:
                self._jr_tokens.setdefault(rid, []).append(int(tok))
            events.append(
                TokenEvent(rid, tok, done, "finished" if done else "token")
            )
            if done:
                self.metrics.record_finish(queue_depth=self.queue_depth())
                self._trace(rid, _trace.SPAN_FINISH)
                finished_slots.append(slot)
                finished_rids.append(rid)
                closed.append((rid, "finished"))
        if fold_results:
            # Tokens harvested and journaled, the step not yet returned.
            self._fault("fold_boundary")
        with self._lock:
            self._slot_req.update(newly)
            for req in admits:
                self._admitting.discard(req.request_id)
            for slot in finished_slots:
                self._slot_req.pop(slot, None)
            # A cancel that raced a same-fold finish would otherwise pin
            # the id in _cancelled and evict a later request reusing it.
            self._cancelled.difference_update(finished_rids)
            self._migrating.difference_update(finished_rids)
        # Device-seconds: this step's wall time split evenly over the
        # requests that held engine state through it (an estimate, but it
        # sums exactly to the serving wall time).
        wall = time.monotonic() - t0
        participants = set(resident_rids)
        participants.update(req.request_id for req in admits)
        participants.update(fold_tokens)
        participants.update(ev[1].request_id for ev in chunk_events)
        if participants:
            share = wall / len(participants)
            for rid in participants:
                acct = self._acct.get(rid)
                if acct is not None:
                    acct["device_s"] += share
        for rid, outcome in closed:
            self._acct_close(rid, outcome)
        if any(outcome == "finished" for _, outcome in closed):
            # The terminal ledger and journal flush happened; the step's
            # events have not reached the caller.
            self._fault("post_finish_pre_ack")
        self.metrics.record_step(
            wall, active,
            len(fold_results) + prefilled + admit_tokens, self.queue_depth(),
        )
        return events

    def _diff_counters(self, fold_tokens: Dict[str, int]) -> None:
        """Diff the engine's cumulative counters (spec accepts, prefix
        tiers, KV pages) into this step's metrics records, and attribute
        the spec shares to the fold's riders (ledger and spans)."""
        eng = self.engine
        # getattr defaults, as the reference reads them: a host-only engine
        # double (or a gang leader's wrapper) need not carry every counter.
        if getattr(eng, "spec", "off") != "off":
            v, d, a = (eng.spec_verifies, eng.spec_drafted_tokens,
                       eng.spec_accepted_tokens)
            dv = v - self._spec_seen[0]
            if dv:
                da = a - self._spec_seen[2]
                self.metrics.record_spec(dv, d - self._spec_seen[1], da)
                # The verify forwards are batched over slots, so the
                # per-request shares are estimates: accepted tokens in
                # proportion to the tokens emitted, verifies split evenly.
                total = sum(fold_tokens.values())
                for rid, n in fold_tokens.items():
                    acct = self._acct.get(rid)
                    if acct is not None:
                        acct["spec_verifies"] += dv / len(fold_tokens)
                        if total:
                            acct["spec_accepted_tokens"] += da * n / total
                if self.tracer is not None:
                    for rid, n in fold_tokens.items():
                        self.tracer.event(
                            rid, _trace.SPAN_SPEC_VERIFY,
                            attrs={
                                "tokens": n,
                                "drafted": d - self._spec_seen[1],
                                "accepted": da,
                            },
                        )
            self._spec_seen = (v, d, a)
        if getattr(eng, "prefix_blocks", 0):
            # One record per step that saw tier traffic (admissions walk
            # the tiers; steady decode never does).
            tiers = eng.prefix_tier_counters()
            if tiers != self._prefix_seen:
                seen = self._prefix_seen
                self.metrics.record_prefix_tiers(
                    {
                        t: {k: n - seen.get(t, {}).get(k, 0)
                            for k, n in kv.items()}
                        for t, kv in tiers.items()
                    },
                    eng.prefix_tier_bytes(),
                )
                self._prefix_seen = tiers
        if getattr(eng, "paged", False):
            kv = eng.kv_page_counters()
            if kv != self._kv_seen:
                self.metrics.record_kv_pages(
                    {k: n - self._kv_seen.get(k, 0) for k, n in kv.items()},
                    eng.kv_page_stats(),
                )
                self._kv_seen = kv

    def _finish_prefills(
        self,
        chunk_events: List[Any],
        newly: Dict[int, Request],
        events: List[TokenEvent],
        finished_rids: List[str],
        finished_slots: List[int],
        closed: List[Tuple[str, str]],
        piggyback: bool = False,
    ) -> int:
        """First-token metrics, spans, ledger and journal entries and
        TokenEvents of the prefills that completed this step (separate
        chunks, or piggybacked ones read after the fold), the store
        write-through and the prefill role's ships; returns how many."""
        #: (slot, task, Request): completed prefills whose blocks ship to
        #: a decode replica instead of decoding here (shipped below, so
        #: the fold never decodes a shipped slot).
        to_ship: List[Any] = []
        for slot, task, tok, done in chunk_events:
            now = time.monotonic()
            req = newly.get(slot) or self._slot_req.get(slot)
            if req is not None:
                self.metrics.record_first_token(
                    now - req.submitted_at,
                    now - (req.admitted_at or now),
                    task.chunks, task.matched_tokens, len(task.tokens),
                )
                self._trace(
                    task.request_id, _trace.SPAN_FIRST_TOKEN, t=now,
                    ttft_s=round(now - req.submitted_at, 6),
                    chunks=task.chunks,
                    prefix_hit_tokens=task.matched_tokens,
                    # Piggybacked chunks rode inside decode folds; solo
                    # chunks had dispatches of their own.
                    mode="piggyback" if piggyback else "solo",
                )
            acct = self._acct.get(task.request_id)
            if acct is not None:
                acct["prefill_chunks"] = task.chunks
                acct["prefix_hit_tokens"] = task.matched_tokens
                acct["emitted_tokens"] += 1
                if req is not None:
                    acct.setdefault("_ttft_s", now - req.submitted_at)
            if self.journal is not None and tok is not None:
                self._jr_tokens.setdefault(task.request_id, []).append(
                    int(tok)
                )
                if req is not None:
                    self._jr_ttft.setdefault(
                        task.request_id, now - req.submitted_at
                    )
            events.append(
                TokenEvent(
                    task.request_id, tok, done,
                    "finished" if done else "token",
                )
            )
            if done:
                self.metrics.record_finish(queue_depth=self.queue_depth())
                self._trace(task.request_id, _trace.SPAN_FINISH)
                finished_rids.append(task.request_id)
                finished_slots.append(slot)
                closed.append((task.request_id, "finished"))
                newly.pop(slot, None)
            elif (
                self.kvfleet is not None
                and req is not None
                and req.ship_to is not None
            ):
                # Disaggregated prefill: the first token streamed above
                # (the client's cursor drops it when the decode replica
                # emits the same stream); the blocks ship below.
                to_ship.append((slot, task, req))
                newly.pop(slot, None)
                finished_slots.append(slot)
                finished_rids.append(task.request_id)
        if (
            self.kvstore_writethrough
            and self.kvstore is not None
            and self.engine.prefix_blocks
        ):
            # Write-through: every completed prefill's chain goes to the
            # store, so its pages outlive this replica. Shipped slots reuse
            # the export below; a failed put counts, never raises.
            shipped = {slot for slot, _, _ in to_ship}
            for slot, task, _tok, _done in chunk_events:
                if slot in shipped:
                    continue
                blocks = self.engine.export_prefix_blocks(task.tokens)
                if blocks:
                    self.kvstore.put_blocks(blocks)
        for slot, task, req in to_ship:
            # Release first (the fold must not decode a shipped slot; the
            # prompt's blocks entered the pool at prefill completion and
            # outlive the release as cache blocks), then export and ship.
            # A failed ship costs the decode replica a cold prefill only:
            # the client's resubmission carries a fetch hint back here.
            self.engine.release(slot)
            blocks = (
                self.engine.export_prefix_blocks(task.tokens)
                if self.engine.prefix_blocks else []
            )
            if self.kvstore_writethrough and self.kvstore is not None and blocks:
                self.kvstore.put_blocks(blocks)
            # A split gang ships the whole prompt, as the JAX package's
            # mesh-sharded payloads do (the receiver takes its heads).
            layerwise = (bool(self.kvfleet.layerwise_ship)
                         and not getattr(self.engine, "heads_split", False))
            self.kvfleet.ship(req.ship_to, req.request_id, blocks,
                              layerwise=layerwise)
            if self.journal is not None:
                # To a replay of this journal a ship is a cancel after the
                # recorded first token; the decode replica's journal holds
                # the decode.
                self.journal.record_cancel(req.request_id, True)
            self.metrics.record_cancel(queue_depth=self.queue_depth())
            self._trace(
                req.request_id, _trace.SPAN_SHIPPED, target=req.ship_to,
                blocks=len(blocks), layerwise=layerwise,
            )
            self._event(
                "kv_ship", request_id=req.request_id, target=req.ship_to,
                blocks=len(blocks), layerwise=layerwise,
            )
            closed.append((req.request_id, "shipped"))
            events.append(TokenEvent(
                req.request_id, None, True, "shipped", ship_to=req.ship_to,
                ship_digests=[b[0] for b in blocks],
            ))
        return len(chunk_events)

    def run_until_idle(self, max_steps: int = 100_000) -> List[TokenEvent]:
        """Drive step() until queue and slots drain (tests, smoke runs)."""
        out: List[TokenEvent] = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            out.extend(self.step())
        return out
