"""Continuous-batching scheduler: iteration-level admission over a
DecodeEngine (PyTorch port, core).

Port of the core of ``ray_lightning_tpu/serve/scheduler.py``. At every
step boundary the scheduler (1) drops cancelled and expired work, (2)
admits queued requests into free engine slots, bounded by
``max_prefills_per_step`` so a burst of prompt prefills cannot starve
in-flight decode, (3) on a chunked engine advances up to
``max_prefill_chunks_per_step`` prefill chunks (the chunk-vs-fold
interleave), and (4) runs one decode fold for everything resident. With
the engine's ``piggyback_chunks`` on, step (3) is skipped: the chunks
ride the fold's dispatch, and their completions are read after it. On a
paged engine a request is admitted only when the engine's allocatable
pages cover its whole life; otherwise the queue head waits in place
(backpressure), and an admission never runs out of pages in the engine.
Requests carry per-request sampling params, a priority (lower value is
served first; FIFO within a priority, with optional aging toward priority
0 via ``priority_age_s``) and an optional deadline.

Not ported yet (ROADMAP queue 1 item 9): the cost ledger, the request
tracer, the workload journal and its events (``kv_pages_backpressure``
among them: ``kv_backpressure_steps`` counts those steps instead),
preemption drain and session parking, the fleet KV plane and KV store,
and fault injection.

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
from typing import TYPE_CHECKING, Any, Dict, List, Optional, Sequence

from ray_lightning_tpu_torch.serve.metrics import ServeMetrics

if TYPE_CHECKING:
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
    #: Relative deadline in seconds from submission; queued requests past
    #: it are expired, in-flight ones are cancelled at the next boundary.
    deadline_s: Optional[float] = None
    submitted_at: float = 0.0
    admitted_at: float = 0.0

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
    #: "token" | "finished" | "cancelled" | "expired"
    reason: str = "token"


class Scheduler:
    def __init__(
        self,
        engine: "DecodeEngine",
        metrics: Optional[ServeMetrics] = None,
        max_prefills_per_step: int = 1,
        max_prefill_chunks_per_step: int = 1,
        priority_age_s: Optional[float] = None,
    ) -> None:
        self.engine = engine
        self.metrics = metrics or ServeMetrics(engine.num_slots)
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
        self._slot_req: Dict[int, Request] = {}
        #: Requests popped for admission but not yet in _slot_req (admit
        #: runs outside the lock); cancel() must still find them.
        self._admitting: set = set()
        #: The engine's cumulative prefix-tier, page and spec counters at
        #: the last diff.
        self._prefix_seen: Dict[str, Dict[str, int]] = {}
        self._kv_seen: Dict[str, int] = {}
        self._spec_seen = (0, 0, 0)
        #: Steps whose queue head waited for KV pages (paged engines).
        self.kv_backpressure_steps = 0

    # -- intake (thread-safe) --------------------------------------------
    def submit(
        self,
        prompt: Sequence[int],
        sampling: Optional[SamplingParams] = None,
        *,
        request_id: Optional[str] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
    ) -> str:
        """Queue a request; returns its id. Rejects (ValueError) requests
        that can never fit the engine, instead of queueing them to fail."""
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
        )
        with self._lock:
            heapq.heappush(
                self._pending, (req.priority, next(self._seq), req)
            )
            self.metrics.record_submit(len(self._pending))
        return req.request_id

    def cancel(self, request_id: str) -> bool:
        """Mark a request cancelled; queued ones are dropped and in-flight
        ones evicted at the next step boundary. Returns whether the id was
        known (queued or in flight)."""
        with self._lock:
            known = (
                request_id in self._admitting
                or any(r.request_id == request_id for _, _, r in self._pending)
                or any(
                    r.request_id == request_id
                    for r in self._slot_req.values()
                )
            )
            if known:
                self._cancelled.add(request_id)
        return known

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._pending) or self.engine.num_active > 0

    # -- the loop ---------------------------------------------------------
    def step(self) -> List[TokenEvent]:
        """One iteration: evict cancelled/expired, admit (bounded), advance
        prefill chunks (chunked engines, bounded), run one engine fold.
        Queue decisions happen under the lock; every engine
        call runs outside it."""
        events: List[TokenEvent] = []
        t0 = time.monotonic()
        to_evict: List[Any] = []
        admits: List[Request] = []
        with self._lock:
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
                    to_evict.append(
                        (slot, req, "cancelled" if cancelled else "expired")
                    )
            budget = min(
                self.max_prefills_per_step,
                len(self.engine.free_slots()) + len(to_evict),
            )
            # A paged engine adds a page budget: the head is admitted only
            # while the allocatable pages cover its whole life, else it
            # waits in place (priority order kept) for residents to finish.
            paged = self.engine.paged
            pages_left = self.engine.pages_available() if paged else 0
            parked = False
            while len(admits) < budget and self._pending:
                req = self._pending[0][2]
                rid = req.request_id
                if rid in self._cancelled:
                    heapq.heappop(self._pending)
                    self._cancelled.discard(rid)
                    self.metrics.record_cancel(queue_depth=len(self._pending))
                    events.append(TokenEvent(rid, None, True, "cancelled"))
                    continue
                if req.expired(t0):
                    heapq.heappop(self._pending)
                    self.metrics.record_expire(queue_depth=len(self._pending))
                    events.append(TokenEvent(rid, None, True, "expired"))
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
            self.kv_backpressure_steps += int(parked)
        # -- engine work, lock NOT held --------------------------------
        for slot, req, kind in to_evict:
            self.engine.release(slot)
            (
                self.metrics.record_expire
                if kind == "expired"
                else self.metrics.record_cancel
            )(queue_depth=self.queue_depth())
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
            now = time.monotonic()
            for req, (slot, first_tok, done) in zip(admits, results):
                req.admitted_at = t_admit
                self.metrics.record_admit(
                    t_admit - req.submitted_at, self.queue_depth()
                )
                if first_tok is None:
                    newly[slot] = req  # chunked prefill in progress
                    continue
                admit_tokens += 1
                self.metrics.record_first_token(
                    now - req.submitted_at, now - t_admit, 1, 0,
                    len(req.prompt),
                )
                events.append(
                    TokenEvent(
                        req.request_id, first_tok, done,
                        "finished" if done else "token",
                    )
                )
                if done:
                    self.metrics.record_finish(queue_depth=self.queue_depth())
                    finished_rids.append(req.request_id)
                else:
                    newly[slot] = req
        # Chunked prefills advance between the admissions and the fold, or,
        # piggybacked, inside the fold's dispatch: their completions are
        # read after it and finish the same way.
        piggyback = self.engine.piggyback_chunks > 0
        prefilled = 0
        if not piggyback:
            prefilled = self._finish_prefills(
                self.engine.prefill_step(self.max_prefill_chunks_per_step),
                newly, events, finished_rids, finished_slots,
            )
        active = self.engine.num_active
        fold_results = self.engine.step()
        if piggyback:
            prefilled = self._finish_prefills(
                self.engine.pop_chunk_events(), newly, events, finished_rids,
                finished_slots,
            )
        for slot, rid, tok, done in fold_results:
            events.append(
                TokenEvent(rid, tok, done, "finished" if done else "token")
            )
            if done:
                self.metrics.record_finish(queue_depth=self.queue_depth())
                finished_slots.append(slot)
                finished_rids.append(rid)
        self._diff_counters()
        with self._lock:
            self._slot_req.update(newly)
            for req in admits:
                self._admitting.discard(req.request_id)
            for slot in finished_slots:
                self._slot_req.pop(slot, None)
            # A cancel that raced a same-fold finish would otherwise pin
            # the id in _cancelled and evict a later request reusing it.
            self._cancelled.difference_update(finished_rids)
        self.metrics.record_step(
            time.monotonic() - t0, active,
            len(fold_results) + prefilled + admit_tokens, self.queue_depth(),
        )
        return events

    def _diff_counters(self) -> None:
        """Diff the engine's cumulative counters (spec accepts, prefix
        tiers, KV pages) into this step's metrics records."""
        eng = self.engine
        if eng.spec != "off":
            seen = (eng.spec_verifies, eng.spec_drafted_tokens,
                    eng.spec_accepted_tokens)
            if seen[0] != self._spec_seen[0]:
                self.metrics.record_spec(
                    *(n - m for n, m in zip(seen, self._spec_seen))
                )
            self._spec_seen = seen
        if eng.prefix_blocks:
            # One record per step that saw tier traffic (admissions walk
            # the tiers; steady decode never does).
            tiers = eng.prefix_tier_counters()
            if tiers != self._prefix_seen:
                seen = self._prefix_seen
                self.metrics.record_prefix_tiers({
                    t: {k: n - seen.get(t, {}).get(k, 0) for k, n in kv.items()}
                    for t, kv in tiers.items()
                })
                self._prefix_seen = tiers
        if eng.paged:
            kv = eng.kv_page_counters()
            if kv != self._kv_seen:
                self.metrics.record_kv_pages(eng.kv_page_stats())
                self._kv_seen = kv

    def _finish_prefills(
        self,
        chunk_events: List[Any],
        newly: Dict[int, Request],
        events: List[TokenEvent],
        finished_rids: List[str],
        finished_slots: List[int],
    ) -> int:
        """First-token metrics and TokenEvents of the prefills that
        completed this step; returns how many."""
        for slot, task, tok, done in chunk_events:
            now = time.monotonic()
            req = newly.get(slot) or self._slot_req.get(slot)
            if req is not None:
                self.metrics.record_first_token(
                    now - req.submitted_at, now - req.admitted_at,
                    task.chunks, task.matched_tokens, len(task.tokens),
                )
            events.append(
                TokenEvent(
                    task.request_id, tok, done,
                    "finished" if done else "token",
                )
            )
            if done:
                self.metrics.record_finish(queue_depth=self.queue_depth())
                finished_rids.append(task.request_id)
                finished_slots.append(slot)
                newly.pop(slot, None)
        return len(chunk_events)

    def run_until_idle(self, max_steps: int = 100_000) -> List[TokenEvent]:
        """Drive step() until queue and slots drain (tests, smoke runs)."""
        out: List[TokenEvent] = []
        for _ in range(max_steps):
            if not self.has_work():
                break
            out.extend(self.step())
        return out
