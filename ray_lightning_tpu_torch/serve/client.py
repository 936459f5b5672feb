"""Serving client: blocking + streaming request API over replica actors
(PyTorch port of ``ray_lightning_tpu/serve/client.py``, the front door).

``start_replicas`` spawns a fleet of ServeReplica actors on the fabric
(placement-group reserved for multi-replica fleets) and hands back a
ServeClient. The client routes each submission (round-robin, or through
an attached :class:`serve.router.Router`) and streams tokens by polling
each replica's ``result`` endpoint (the poll blocks briefly replica-side,
so streaming costs ~one RPC per emitted token burst, not per token).

The client is also the fleet's trace anchor: it mints each request id
before the submit RPC departs and records a ``client_submit`` span in
its own ring, so ``export_stitched_trace()`` can merge the client and
every replica into ONE wall-clock-aligned Chrome trace.

Fault tolerance: every RPC takes an optional per-call timeout with capped
exponential backoff + jitter on transient failures; replicas that die
(``ActorDiedError``) or exhaust the retry budget land on an EXCLUSION
list and their incomplete requests FAIL OVER — the client keeps a
driver-side workload journal (obs.journal schema: one normalized
``submit`` record per request, one ``outcome`` at terminal), so a lost
replica's outcome-less submits are replayed verbatim (prompt + full
SamplingParams incl. seed + priority/deadline/tenant) onto survivors.
Because per-request sampling draws come from the request's seed and
greedy decode is deterministic, the resubmitted request emits the
IDENTICAL token stream; ``stream_handle`` keeps its cursor across the
failover, so callers see one uninterrupted stream.

Routing: with a Router attached (``router=`` or ``client.router = ...``),
``submit`` consults it — health/state-aware weighting, prefix affinity
and admission control (a shed submit raises the typed
:class:`serve.router.RequestRejectedError`). Per-call RPC retries share
one :class:`serve.router.RetryBudget`, and ``hedge_after_s`` arms hedged
streaming reads.

The fleet KV plane (``serve/kvfleet.py``): ``start_replicas`` gives every
replica an inbox queue and every peer's (on by default for a
multi-replica fleet with a prefix cache), so a request the router steers
off its chain's holder fetches the chain instead of prefilling cold.
``roles`` splits the fleet into prefill and decode replicas: a prefill
replica ships each finished prefill's blocks to the decode replica the
router chose and ends the stream there as ``shipped``; the client
resubmits it on that replica under the same id and seed, and the stream
goes on with the delivered first token dropped. With ``kvstore_dir`` the
client keeps a handle on the KV object store (``serve/kvstore.py``):
:meth:`ServeClient.seed_store_directory` seeds the router's directory
from its manifest after a fleet restart, and
:meth:`ServeClient.park_session` parks a conversation there.

The recovery plane: ``start_replicas`` keeps each index's spawn recipe as
the client's ``respawn_fn``, so :class:`serve.supervisor.FleetSupervisor`
restarts a dead replica from the same resolved config
(``respawn_replica``), pre-spawns a preempted replica's replacement on
fresh capacity (``prespawn_replacement``) while ``preempt_drain`` moves
its unfinishable requests with their prefix KV onto survivors, and
:class:`serve.router.RouterAutoscaler` grows and shrinks the fleet
(``add_replica``, ``retire_replica``).

A tensor-parallel replica is a gang (``start_replicas(hosts_per_replica=N,
mesh="MODELxDATA")``): a leader ``ServeReplica`` that takes the traffic and
N - 1 ``ServeShardFollower`` ranks that replay its engine's op stream, one
process per card (or per share of one). The client keeps the followers
beside their leader's index (``followers_of``): they are respawned,
pre-spawned, added, retired and torn down with it, a dead follower makes
its gang dead (``replica_is_alive``), and a follower's preemption notice,
read from its heartbeat (``gang_preempt_state``), dooms the gang.

Not ported yet, and refused naming their ROADMAP queue 1 item: several
cards per worker process (a gang's ranks other than model x data, item
11b) and the profiler RPC (item 14).
"""
from __future__ import annotations

import random
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.obs import trace as _trace
from ray_lightning_tpu_torch.serve.router import RequestRejectedError
from ray_lightning_tpu_torch.serve.server import (
    ENGINE_KEYS,
    STORE_KEYS,
    ServeReplica,
    ServeShardFollower,
)
from ray_lightning_tpu_torch.utils.ports import find_free_port


def _ready(actor: Any) -> Any:
    """The future a spawn waits on: a lazily constructed actor's
    construction (which raises its constructor's error), else a ping."""
    ref = getattr(actor, "init_ref", None)
    return ref() if ref is not None and actor.actor_options.get(
        "lazy_init") else actor.ping.remote()


class ReplicaLostError(RuntimeError):
    """A replica stopped answering (died, or exhausted the RPC retry
    budget); carries the replica index so callers can fail over."""

    def __init__(self, replica: int, reason: str) -> None:
        super().__init__(f"replica {replica} lost: {reason}")
        self.replica = int(replica)
        self.reason = reason


class NoReplicasError(RuntimeError):
    """Every replica is excluded/lost — nothing can take traffic."""


@dataclass(frozen=True)
class RequestHandle:
    #: The replica the request was FIRST routed to; after a failover the
    #: client's route table (not this field) is authoritative.
    replica: int
    request_id: str


#: ServeReplica.submit's full kwarg surface with its defaults — the
#: normalization target for the client-side journal: a submit record
#: always carries EVERY field explicitly, so a failover resubmission is
#: byte-for-byte the original request regardless of which defaults the
#: caller leaned on.
_SUBMIT_DEFAULTS: Dict[str, Any] = {
    "max_new_tokens": 32,
    "temperature": 0.0,
    "top_k": None,
    "top_p": None,
    "seed": 0,
    "eos_token": None,
    "priority": 0,
    "deadline_s": None,
    "tenant": None,
}

#: Exceptions that mean "this actor is gone" (fail over now) vs
#: "this call failed" (retry with backoff first).
_FATAL_RPC_ERRORS = (fabric.ActorDiedError,)
_TRANSIENT_RPC_ERRORS = (TimeoutError, ConnectionError, EOFError, OSError)


class ServeClient:
    """Driver-side handle to one or more serving replicas.

    ``rpc_timeout_s`` bounds every RPC (None = block); ``rpc_retries``
    transient failures are retried with capped exponential backoff +
    jitter before the replica is declared lost. ``roles`` is the
    per-index replica role table, ``kv_queues`` the fleet KV inboxes and
    ``kvstore`` the driver's handle on the KV object store.
    ``respawn_fn(i, fresh_capacity=False, role=None) -> (leader,
    followers)`` re-runs replica ``i``'s original spawn (same resolved
    config, same placement-group bundle, fresh processes): the
    supervisor's restart path and the autoscaler's. ``followers`` are
    the rank > 0 members of tensor-parallel gangs (they take no requests)
    and ``follower_replica`` the replica index each belongs to (a
    parallel list; replica 0 by default): they go down, and come back,
    with their leader.
    """

    def __init__(
        self,
        replicas: List[Any],
        pg: Any = None,
        followers: Optional[List[Any]] = None,
        tracer: Optional[Any] = None,
        respawn_fn: Optional[Callable[[int], Tuple[Any, List[Any]]]] = None,
        follower_replica: Optional[List[int]] = None,
        rpc_timeout_s: Optional[float] = None,
        rpc_retries: int = 3,
        backoff_base_s: float = 0.05,
        backoff_cap_s: float = 2.0,
        journal_capacity: int = 8192,
        init_timeout: float = 300.0,
        registry: Optional[Any] = None,
        events: Optional[Any] = None,
        router: Optional[Any] = None,
        retry_budget_ratio: Optional[float] = 0.5,
        retry_budget_window_s: float = 30.0,
        retry_budget_floor: int = 8,
        hedge_after_s: Optional[float] = None,
        roles: Optional[Sequence[str]] = None,
        kv_queues: Optional[Dict[int, Any]] = None,
        kvstore: Optional[Any] = None,
        submit_batch_ms: float = 0.0,
    ) -> None:
        from ray_lightning_tpu_torch.obs.events import get_event_log
        from ray_lightning_tpu_torch.obs.journal import WorkloadJournal
        from ray_lightning_tpu_torch.obs.registry import get_registry
        from ray_lightning_tpu_torch.serve.router import RetryBudget

        if not replicas:
            raise ValueError("need at least one replica")
        self._replicas = list(replicas)
        self._followers = list(followers or [])
        self._follower_replica = list(
            follower_replica
            if follower_replica is not None
            else [0] * len(self._followers)
        )
        self._pg = pg
        self._respawn_fn = respawn_fn
        self._init_timeout = float(init_timeout)
        self.rpc_timeout_s = (
            None if rpc_timeout_s is None else float(rpc_timeout_s)
        )
        self.rpc_retries = max(0, int(rpc_retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._lock = threading.RLock()
        self._rr = 0
        #: Replica indices receiving no NEW traffic: draining (supervisor
        #: verdict) or lost (failed RPCs). ``_lost`` additionally means
        #: "its incomplete requests were failed over".
        self._excluded: set = set()
        self._lost: set = set()
        #: Indices retired by the autoscaler: permanent tombstones (the
        #: index table never shifts, so every id->replica mapping in the
        #: fleet stays stable). Retired implies excluded; restore() is a
        #: no-op on them.
        self._retired: set = set()
        #: request_id -> current replica index (None once declared lost).
        self._route: Dict[str, Optional[int]] = {}
        #: request_id -> its normalized journal ``submit`` record — the
        #: OPEN half of the driver-side journal (popped at terminal).
        #: This is the failover set: submit without outcome == incomplete.
        self._open: Dict[str, Dict[str, Any]] = {}
        #: Driver-side trace ring: the client records a ``client_submit``
        #: span per request (under the SAME id the replica traces carry
        #: — the client mints it), so the stitched export shows the
        #: client-observed queue time that no replica ring can see.
        self.tracer = tracer or _trace.RequestTracer(capacity=4096)
        #: Driver-side workload journal (obs.journal schema): every
        #: submit this client issued + every terminal outcome it
        #: observed. Survives any replica's death by construction —
        #: the substrate request failover replays from.
        self.journal = WorkloadJournal(capacity=int(journal_capacity))
        self._events = events if events is not None else get_event_log()
        reg = registry if registry is not None else get_registry()
        self._m_failover = reg.counter(
            "rlt_serve_failover_requests_total",
            "Requests moved off a lost replica (outcome label: "
            "resubmitted onto a survivor, or lost with no survivor)",
        )
        self._m_rpc_retries = reg.counter(
            "rlt_serve_failover_rpc_retries_total",
            "Client RPCs retried after a transient failure/timeout",
        )
        self._m_replicas_lost = reg.counter(
            "rlt_serve_failover_replicas_lost_total",
            "Replicas declared lost by the serve client",
        )
        # Preemption drain: graceful-drain outcomes (scheduled kills,
        # consumed instead of crashed through) next to the failover
        # (crash) counters above.
        self._m_preempt_drains = reg.counter(
            "rlt_serve_preempt_drains_total",
            "Graceful drains run against preempting replicas",
        )
        self._m_preempt_requests = reg.counter(
            "rlt_serve_preempt_requests_total",
            "Requests handled by a preemption drain (outcome label: "
            "finished in the grace window, migrated to a survivor, or "
            "lost with no survivor)",
        )
        self._m_preempt_kv_blocks = reg.counter(
            "rlt_serve_preempt_kv_blocks_total",
            "Prefix KV blocks handed off replica-to-replica during "
            "preemption drains",
        )
        #: Replacement actors spawned DURING a grace window (capacity
        #: never dips below N): idx -> actor, consumed by respawn_replica.
        self._prespawned: Dict[int, Any] = {}
        #: Routing policy (serve.router.Router): submit consults it
        #: instead of round-robin when set. Assignable after
        #: construction (the CLI builds the router once the supervisor
        #: exists, since its state feed comes from there).
        self.router = router
        #: Shared transient-retry budget: per-call retry caps bound ONE
        #: RPC; this bounds the aggregate across every call — None
        #: disables the budget (the pre-router unbounded behavior).
        self._retry_budget = (
            None if retry_budget_ratio is None
            else RetryBudget(
                ratio=float(retry_budget_ratio),
                window_s=float(retry_budget_window_s),
                floor=int(retry_budget_floor),
            )
        )
        #: Hedged streaming reads: a stream with no new token for this
        #: many seconds (while its replica still answers polls) is
        #: re-driven on a peer — the gray-failure cover. None = off.
        self.hedge_after_s = (
            None if hedge_after_s is None else float(hedge_after_s)
        )
        self._m_retry_budget_exhausted = reg.counter(
            "rlt_serve_retry_budget_exhausted_total",
            "Transient-RPC retries refused by the shared retry budget "
            "(the call fails over instead of retrying)",
        )
        self._m_hedges = reg.counter(
            "rlt_router_hedges_total",
            "Stalled streams re-driven on a peer replica, by reason",
        )
        self._m_submit_batches = reg.counter(
            "rlt_serve_submit_batches_total",
            "Batched submit flushes (submit_many calls and "
            "micro-batching-window flushes; one increment per batch, "
            "however many requests it carried)",
        )
        #: Opt-in micro-batching window: submit() calls arriving within
        #: ``submit_batch_ms`` of each other coalesce into ONE vectorized
        #: Router.plan_many + ONE submit_many RPC per target replica.
        #: 0 = off (the default serial path). Per-request semantics,
        #: outcomes, and journal records are identical either way.
        self.submit_batch_ms = max(0.0, float(submit_batch_ms))
        self._batcher = (
            _SubmitBatcher(self, self.submit_batch_ms / 1000.0)
            if self.submit_batch_ms > 0.0
            else None
        )
        #: Per-index replica roles (mixed | prefill | decode) — the
        #: disaggregated-placement table the router and the autoscaler
        #: read; index-aligned with the replica list (tombstones keep
        #: their last role).
        self._roles: List[str] = [
            str(r) for r in (roles or [])
        ] or ["mixed"] * len(self._replicas)
        while len(self._roles) < len(self._replicas):
            self._roles.append("mixed")
        #: Fleet KV transfer queues (index -> inbox), shared with the
        #: spawn recipe: add_replica broadcasts a new member's inbox to
        #: the live fleet through register_kv_peer.
        self._kv_queues: Dict[int, Any] = (
            kv_queues if kv_queues is not None else {}
        )
        #: The driver's handle on the KV object store (the directory the
        #: replicas share): preemption drains write migrating chains
        #: through it, and seed_store_directory reads its manifest. None
        #: without a store.
        self.kvstore = kvstore

    # -- internals --------------------------------------------------------
    def _event(self, name: str, level: str = "info", **kv: Any) -> None:
        try:
            self._events.record("serve", name, level=level, **kv)
        except Exception:  # noqa: BLE001 - forensics must never block I/O
            pass

    def _backoff(self, attempt: int) -> float:
        """Capped exponential backoff with jitter (0.5x-1x of the
        deterministic value, so a thundering herd of retries decorrelates)."""
        base = min(
            self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt)
        )
        return base * (0.5 + 0.5 * random.random())

    def _actor(self, idx: int) -> Any:
        with self._lock:
            return self._replicas[idx]

    def followers_of(self, idx: int) -> List[Any]:
        """Replica ``idx``'s gang followers, in rank order ([] for a
        one-process replica)."""
        with self._lock:
            return [f for f, owner in zip(self._followers,
                                          self._follower_replica)
                    if owner == int(idx)]

    def _set_gang(self, idx: int, leader: Any, followers: List[Any]) -> None:
        """Make ``leader`` and ``followers`` replica ``idx``'s processes."""
        with self._lock:
            self._replicas[idx] = leader
            kept = [(f, o) for f, o in zip(self._followers,
                                           self._follower_replica)
                    if o != idx]
            kept += [(f, idx) for f in followers]
            self._followers = [f for f, _ in kept]
            self._follower_replica = [o for _, o in kept]

    @staticmethod
    def _kill_all(actors: Sequence[Any]) -> None:
        for a in actors:
            try:
                fabric.kill(a)
            except Exception:  # noqa: BLE001 - usually already dead
                pass

    def _rpc(
        self,
        idx: int,
        method: str,
        *args: Any,
        timeout: Optional[float] = None,
        retries: Optional[int] = None,
        **kwargs: Any,
    ) -> Any:
        """One replica RPC with the client's fault policy: per-call
        timeout, transient errors retried with capped backoff + jitter,
        actor death (or retry exhaustion) raised as ReplicaLostError."""
        timeout = self.rpc_timeout_s if timeout is None else timeout
        retries = self.rpc_retries if retries is None else max(0, retries)
        attempt = 0
        while True:
            actor = self._actor(idx)
            try:
                return fabric.get(
                    getattr(actor, method).remote(*args, **kwargs),
                    timeout=timeout,
                )
            except _FATAL_RPC_ERRORS as exc:
                raise ReplicaLostError(
                    idx, f"{type(exc).__name__}: {exc}"
                ) from exc
            except _TRANSIENT_RPC_ERRORS as exc:
                if attempt >= retries:
                    raise ReplicaLostError(
                        idx,
                        f"rpc {method!r} failed {attempt + 1}x "
                        f"({type(exc).__name__}: {exc})",
                    ) from exc
                if (
                    self._retry_budget is not None
                    and not self._retry_budget.try_spend()
                ):
                    # Aggregate cap: per-call retries are bounded above,
                    # but N concurrent streams each retrying within
                    # budget is still a storm against a sick fleet —
                    # once the SHARED window is spent, fail over now.
                    self._m_retry_budget_exhausted.inc(1)
                    self._event(
                        "rpc_retry_budget_exhausted", level="warn",
                        replica=idx, method=method,
                        error=f"{type(exc).__name__}: {exc}"[:200],
                    )
                    raise ReplicaLostError(
                        idx,
                        f"rpc {method!r} retry budget exhausted "
                        f"({type(exc).__name__}: {exc})",
                    ) from exc
                self._m_rpc_retries.inc(1)
                time.sleep(self._backoff(attempt))
                attempt += 1

    def _fanout(self, fns: Sequence[Callable[[], Any]]) -> List[Any]:
        """Run RPC thunks concurrently (driver-side pipelining for
        per-replica fan-outs: submit_many sends, stats/health pulls,
        failover resubmits). Results come back in input order; each
        thunk keeps the full per-call fault policy — ``_rpc`` is
        thread-safe and the RetryBudget/timeout semantics apply to
        every pipelined call exactly as they would serially. A thunk's
        exception propagates from its slot, so thunks that must be
        error-isolated catch internally."""
        if len(fns) <= 1:
            return [fn() for fn in fns]
        with ThreadPoolExecutor(
            max_workers=min(8, len(fns)),
            thread_name_prefix="rlt-client-fanout",
        ) as pool:
            return [f.result() for f in [pool.submit(fn) for fn in fns]]

    def _alive(self, exclude: Optional[int] = None) -> List[int]:
        with self._lock:
            return [
                i for i in range(len(self._replicas))
                if i not in self._excluded
                and i not in self._retired
                and i != exclude
            ]

    def alive_replicas(self) -> List[int]:
        """Replica indices currently taking new traffic (the router's
        and autoscaler's candidate set)."""
        return self._alive()

    def role_of(self, idx: int) -> str:
        """Replica ``idx``'s role (mixed | prefill | decode)."""
        with self._lock:
            idx = int(idx)
            if 0 <= idx < len(self._roles):
                return self._roles[idx]
        return "mixed"

    def replicas_with_role(self, role: str) -> List[int]:
        """Live replicas of one role (the autoscaler's pool view)."""
        return [i for i in self._alive() if self.role_of(i) == str(role)]

    def _pick(self, exclude: Optional[int] = None) -> int:
        """Round-robin over the non-excluded replicas."""
        with self._lock:
            alive = self._alive(exclude)
            if not alive:
                raise NoReplicasError(
                    "no live replicas to route to (all excluded/lost)"
                )
            idx = alive[self._rr % len(alive)]
            self._rr += 1
            return idx

    # -- exclusion surface (the supervisor's levers) -----------------------
    def exclude(self, idx: int) -> None:
        """Stop routing NEW submissions to replica ``idx`` (draining:
        in-flight requests keep streaming). Idempotent."""
        with self._lock:
            self._excluded.add(int(idx))

    def restore(self, idx: int) -> None:
        """Resume routing to a drained replica. Idempotent; a RETIRED
        replica stays retired (its process is gone — re-adding capacity
        is ``add_replica``'s job)."""
        with self._lock:
            if int(idx) in self._retired:
                return
            self._excluded.discard(int(idx))
            self._lost.discard(int(idx))

    def is_retired(self, idx: int) -> bool:
        with self._lock:
            return int(idx) in self._retired

    def excluded(self) -> List[int]:
        with self._lock:
            return sorted(self._excluded)

    # -- request API -------------------------------------------------------
    def _record_submit(
        self, rid: str, prompt: List[int], record: Dict[str, Any]
    ) -> None:
        self.journal.record_submit(
            request_id=rid,
            prompt=prompt,
            sampling={
                k: record[k]
                for k in (
                    "max_new_tokens", "temperature", "top_k", "top_p",
                    "seed", "eos_token",
                )
            },
            priority=record["priority"],
            deadline_s=record["deadline_s"],
            tenant=record["tenant"],
        )

    def _submit_rpc(
        self,
        idx: int,
        rid: str,
        prompt: List[int],
        record: Dict[str, Any],
        extra: Optional[Dict[str, Any]] = None,
    ) -> None:
        """``extra`` carries the fleet-KV placement hints (kv_hint /
        ship_to) of the INITIAL placement only — failover/hedge
        resubmissions deliberately omit them (decoding locally on the
        survivor is always correct), so they never enter the journal
        record this call normalizes from."""
        kwargs = {k: record[k] for k in _SUBMIT_DEFAULTS}
        if extra:
            kwargs.update(
                {k: v for k, v in extra.items() if v is not None}
            )
        self._rpc(idx, "submit", prompt, request_id=rid, **kwargs)

    def _normalize_submit(
        self, prompt: Sequence[int], sampling: Dict[str, Any]
    ) -> Dict[str, Any]:
        """Mint the id and normalize one submit's kwargs into the full
        journal record (every `_SUBMIT_DEFAULTS` field explicit) — the
        shared head of ``submit`` and ``submit_many``. MUTATES
        ``sampling`` (pops the routed-extras/request_id keys)."""
        rid = sampling.pop("request_id", None) or uuid.uuid4().hex[:12]
        explicit_extra = {
            k: sampling.pop(k)
            for k in ("kv_hint", "ship_to")
            if k in sampling
        } or None
        unknown = set(sampling) - set(_SUBMIT_DEFAULTS)
        if unknown:
            raise TypeError(
                f"unknown submit option(s) {sorted(unknown)}; valid: "
                f"{sorted(_SUBMIT_DEFAULTS)}"
            )
        record = dict(_SUBMIT_DEFAULTS)
        record.update(sampling)
        prompt = [int(t) for t in prompt]
        record["prompt"] = prompt
        # The anatomy ledger's clock starts HERE: recv → plan is the
        # batch_window phase (the micro-batcher's coalescing wait; ~0 on
        # the serial path), plan → client_submit is route_plan.
        self.tracer.event(
            rid, _trace.SPAN_CLIENT_RECV,
            attrs={"prompt_tokens": len(prompt)},
        )
        return {
            "rid": rid,
            "prompt": prompt,
            "record": record,
            "extra": explicit_extra,
        }

    def submit(
        self,
        prompt: Sequence[int],
        *,
        replica: Optional[int] = None,
        **sampling: Any,
    ) -> RequestHandle:
        """Queue a request (round-robin across live replicas unless
        pinned); sampling kwargs mirror ServeReplica.submit (including
        ``tenant`` for cost-ledger attribution). A replica dying under
        the submit re-routes to a survivor (pinned submits raise
        instead — the pin was the point). ``kv_hint``/``ship_to``
        (fleet KV plane) are normally the router plan's job; passing
        them explicitly overrides it (pinned submits included)."""
        entry = self._normalize_submit(prompt, sampling)
        if self._batcher is not None and replica is None:
            # Micro-batching window: coalesce with concurrent submits
            # into ONE plan_many + ONE submit_many RPC per target
            # replica. The flush hands back this entry's own handle or
            # raises its own typed rejection — serial semantics, batched
            # wire traffic.
            out = self._batcher.submit(entry)
            if isinstance(out, BaseException):
                raise out
            return out
        rid = entry["rid"]
        prompt = entry["prompt"]
        record = entry["record"]
        explicit_extra = entry["extra"]
        # Journal BEFORE the RPC departs: a replica dying mid-submit must
        # still leave the record failover resubmits from.
        with self._lock:
            self._open[rid] = record
        self._record_submit(rid, prompt, record)
        if self._retry_budget is not None:
            self._retry_budget.note_submit()
        self.tracer.event(rid, _trace.SPAN_CLIENT_PLAN)
        while True:
            extra: Optional[Dict[str, Any]] = explicit_extra
            digests: Optional[List[bytes]] = None
            if replica is not None:
                idx = int(replica)
            else:
                try:
                    idx, planned, digests = self._route_plan(
                        prompt, record
                    )
                    if explicit_extra is None:
                        extra = planned
                except RequestRejectedError as exc:
                    # Admission control: the typed ``rejected`` outcome —
                    # journaled and evented; the request never left the
                    # driver, and the caller holds a retry-after hint.
                    with self._lock:
                        self._open.pop(rid, None)
                    self.journal.record_outcome(rid, "rejected")
                    self._event(
                        "request_rejected", level="warn",
                        request_id=rid, reason=exc.reason,
                        retry_after_s=exc.retry_after_s,
                    )
                    raise
            self.tracer.event(
                rid, _trace.SPAN_CLIENT_SUBMIT,
                attrs={"replica": idx, "prompt_tokens": len(prompt)},
            )
            try:
                self._submit_rpc(idx, rid, prompt, record, extra=extra)
            except ReplicaLostError as exc:
                self.on_replica_lost(idx, reason=str(exc))
                if replica is not None:
                    with self._lock:
                        self._open.pop(rid, None)
                    raise
                continue
            with self._lock:
                self._route[rid] = idx
            if self.router is not None:
                try:
                    # The prefix chain is warm on idx now — feed the
                    # affinity map (pinned submits included: the pin
                    # seeded the cache all the same). The plan's digest
                    # chain rides along so the router never re-hashes
                    # the prompt it just planned.
                    if digests is not None:
                        self.router.observe_route(
                            prompt, idx, digests=digests
                        )
                    else:
                        self.router.observe_route(prompt, idx)
                except Exception:  # noqa: BLE001 - routing hints must
                    pass  # never fail a placed submit
            return RequestHandle(replica=idx, request_id=rid)

    def _route_plan(
        self, prompt: Sequence[int], record: Dict[str, Any]
    ) -> Tuple[int, Optional[Dict[str, Any]], Optional[List[bytes]]]:
        """One routing decision: ``(replica, extra submit kwargs,
        digest chain)`` — the attached router's plan (replica + the
        fleet-KV placement hints kv_hint/ship_to + the prompt's
        computed block-digest chain for observe_route to reuse), or the
        round-robin fallback. May raise RequestRejectedError (router
        admission control) or NoReplicasError."""
        router = self.router
        if router is None:
            return self._pick(), None, None
        kwargs = dict(
            max_new_tokens=record["max_new_tokens"],
            priority=record["priority"],
            deadline_s=record["deadline_s"],
            alive=self._alive(),
        )
        plan_fn = getattr(router, "plan", None)
        if plan_fn is None:
            # A pick-only router (tests, custom policies): no hints.
            return int(router.pick(prompt, **kwargs)), None, None
        plan = plan_fn(prompt, **kwargs)
        return (
            int(plan.replica),
            self._plan_extra(plan),
            getattr(plan, "digests", None),
        )

    @staticmethod
    def _plan_extra(plan: Any) -> Optional[Dict[str, Any]]:
        """A route plan's submit-RPC extras (fleet-KV placement hints)."""
        extra: Dict[str, Any] = {}
        if getattr(plan, "kv_hint", None):
            extra["kv_hint"] = plan.kv_hint
        if getattr(plan, "ship_to", None) is not None:
            extra["ship_to"] = int(plan.ship_to)
        return extra or None

    def submit_many(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        sampling: Optional[Sequence[Dict[str, Any]]] = None,
        **shared: Any,
    ) -> List[Any]:
        """Batched submit: admit ``prompts`` through ONE vectorized
        router ``plan_many`` call and ONE ``submit_many`` RPC per
        target replica (per-target sends pipelined), amortizing the
        per-request Python/RPC overhead the serial path pays N times.

        ``shared`` kwargs apply to every request (same surface as
        :meth:`submit`); ``sampling`` optionally carries one per-request
        override dict (index-aligned with ``prompts``). Per-request
        semantics are IDENTICAL to N serial submits: one journal
        ``submit`` record per request (written before any RPC departs),
        same client-minted ids/seeds, router admission applied per
        request. The return list is index-aligned with ``prompts``:
        a :class:`RequestHandle` per placed request, or that request's
        own :class:`RequestRejectedError` / :class:`ReplicaLostError`
        instance — one shed request never fails its batchmates."""
        if sampling is not None and len(sampling) != len(prompts):
            raise ValueError(
                f"sampling has {len(sampling)} entries for "
                f"{len(prompts)} prompts"
            )
        entries = []
        for k, prompt in enumerate(prompts):
            kw = dict(shared)
            if sampling is not None:
                kw.update(sampling[k])
            entries.append(self._normalize_submit(prompt, kw))
        return self._submit_entries(entries)

    def _plan_entries(self, entries: List[Dict[str, Any]]) -> List[Any]:
        """One vectorized routing pass over a submit batch: a plan (or
        bare index) per entry, with per-entry RequestRejectedError
        instances IN the list (admission is per request — a shed entry
        must not fail its batchmates). NoReplicasError still raises."""
        router = self.router
        if router is None:
            return [self._pick() for _ in entries]
        plan_many = getattr(router, "plan_many", None)
        if plan_many is not None:
            return plan_many(
                [e["prompt"] for e in entries],
                max_new_tokens=[
                    e["record"]["max_new_tokens"] for e in entries
                ],
                priority=[e["record"]["priority"] for e in entries],
                deadline_s=[e["record"]["deadline_s"] for e in entries],
                alive=self._alive(),
            )
        # A plan()/pick()-only router: per-entry decisions, same
        # per-entry rejection isolation.
        out: List[Any] = []
        for e in entries:
            try:
                idx, extra, digests = self._route_plan(
                    e["prompt"], e["record"]
                )
                out.append(
                    {"replica": idx, "extra": extra, "digests": digests}
                )
            except RequestRejectedError as exc:
                out.append(exc)
        return out

    def _submit_entries(self, entries: List[Dict[str, Any]]) -> List[Any]:
        """The batched submit spine (``submit_many`` and the
        micro-batching window both land here): journal everything
        first, plan the whole batch in one vectorized call, then issue
        ONE submit_many RPC per target replica with the per-target
        sends pipelined. Returns handles/exceptions index-aligned with
        ``entries``."""
        if not entries:
            return []
        # Journal BEFORE any RPC departs — same invariant as submit().
        with self._lock:
            for e in entries:
                self._open[e["rid"]] = e["record"]
        for e in entries:
            self._record_submit(e["rid"], e["prompt"], e["record"])
            if self._retry_budget is not None:
                self._retry_budget.note_submit()
        self._m_submit_batches.inc(1)
        for e in entries:
            self.tracer.event(
                e["rid"], _trace.SPAN_CLIENT_PLAN,
                attrs={"batched": True},
            )
        try:
            plans = self._plan_entries(entries)
        except Exception:
            # A failed batch plan (NoReplicasError and kin) closes
            # every journaled record — nothing was placed.
            with self._lock:
                for e in entries:
                    self._open.pop(e["rid"], None)
            raise
        results: List[Any] = [None] * len(entries)
        by_target: Dict[int, List[int]] = {}
        extras: Dict[int, Optional[Dict[str, Any]]] = {}
        digests_of: Dict[int, Optional[List[bytes]]] = {}
        for pos, plan in enumerate(plans):
            e = entries[pos]
            if isinstance(plan, RequestRejectedError):
                # Admission control: the typed ``rejected`` outcome —
                # identical journal/event trail to a serial rejection.
                with self._lock:
                    self._open.pop(e["rid"], None)
                self.journal.record_outcome(e["rid"], "rejected")
                self._event(
                    "request_rejected", level="warn",
                    request_id=e["rid"], reason=plan.reason,
                    retry_after_s=plan.retry_after_s,
                )
                results[pos] = plan
                continue
            if isinstance(plan, int):
                idx, planned, digests = plan, None, None
            elif isinstance(plan, dict):
                idx = int(plan["replica"])
                planned = plan["extra"]
                digests = plan["digests"]
            else:
                idx = int(plan.replica)
                planned = self._plan_extra(plan)
                digests = getattr(plan, "digests", None)
            extras[pos] = (
                e["extra"] if e["extra"] is not None else planned
            )
            digests_of[pos] = digests
            by_target.setdefault(idx, []).append(pos)

        def _send(idx: int, positions: List[int]) -> None:
            for pos in positions:
                e = entries[pos]
                self.tracer.event(
                    e["rid"], _trace.SPAN_CLIENT_SUBMIT,
                    attrs={
                        "replica": idx,
                        "prompt_tokens": len(e["prompt"]),
                        "batched": True,
                    },
                )
            reqs = []
            for pos in positions:
                e = entries[pos]
                req = {k: e["record"][k] for k in _SUBMIT_DEFAULTS}
                req["prompt"] = e["prompt"]
                req["request_id"] = e["rid"]
                ex = extras.get(pos)
                if ex:
                    req.update(
                        {k: v for k, v in ex.items() if v is not None}
                    )
                reqs.append(req)
            try:
                self._rpc(idx, "submit_many", reqs)
            except ReplicaLostError as exc:
                # The whole target died under the batch: fail its slice
                # over through the journal (same id/seed — bit-exact on
                # the survivor), slot-isolating any truly lost request.
                self.on_replica_lost(idx, reason=str(exc))
                for pos in positions:
                    rid = entries[pos]["rid"]
                    if self._resubmit_from_journal(rid, exclude=idx):
                        with self._lock:
                            moved = self._route.get(rid)
                        results[pos] = RequestHandle(
                            replica=int(moved if moved is not None
                                        else idx),
                            request_id=rid,
                        )
                    else:
                        results[pos] = exc
                return
            for pos in positions:
                e = entries[pos]
                with self._lock:
                    self._route[e["rid"]] = idx
                if self.router is not None:
                    try:
                        d = digests_of.get(pos)
                        if d is not None:
                            self.router.observe_route(
                                e["prompt"], idx, digests=d
                            )
                        else:
                            self.router.observe_route(e["prompt"], idx)
                    except Exception:  # noqa: BLE001 - hints must
                        pass  # never fail a placed submit
                results[pos] = RequestHandle(
                    replica=idx, request_id=e["rid"]
                )

        self._fanout([
            (lambda i=i, p=p: _send(i, p))
            for i, p in sorted(by_target.items())
        ])
        return results

    def _finish(self, rid: str, status: str) -> None:
        """A request reached terminal state from this client's point of
        view: close the driver-side journal record (it leaves the
        failover set) and drop its route."""
        with self._lock:
            known = self._open.pop(rid, None)
            self._route.pop(rid, None)
        if known is not None:
            self.journal.record_outcome(rid, status)

    def _route_of(self, handle: RequestHandle) -> Optional[int]:
        with self._lock:
            return self._route.get(handle.request_id, handle.replica)

    def stream(
        self,
        prompt: Sequence[int],
        *,
        poll_s: float = 0.05,
        timeout_s: float = 300.0,
        **sampling: Any,
    ) -> Iterator[int]:
        """Submit and yield generated tokens as they arrive."""
        handle = self.submit(prompt, **sampling)
        yield from self.stream_handle(
            handle, poll_s=poll_s, timeout_s=timeout_s
        )

    def stream_handle(
        self,
        handle: RequestHandle,
        *,
        poll_s: float = 0.05,
        timeout_s: float = 300.0,
    ) -> Iterator[int]:
        """Stream a request's tokens, transparently surviving replica
        loss: the poll follows the route table, and because a failed-over
        request re-emits its full (bit-identical) stream on the
        survivor, the retained ``cursor`` deduplicates the prefix the
        caller already received — the stream just continues."""
        rid = handle.request_id
        cursor = 0
        deadline = time.monotonic() + timeout_s
        last_progress = time.monotonic()
        hedged = False
        while True:
            idx = self._route_of(handle)
            if idx is None:
                raise ReplicaLostError(
                    handle.replica,
                    f"request {rid} could not be failed over "
                    "(no surviving replicas)",
                )
            try:
                res = self._rpc(
                    idx, "result", rid, cursor, wait_s=poll_s,
                    timeout=(
                        None if self.rpc_timeout_s is None
                        else self.rpc_timeout_s + poll_s
                    ),
                )
            except ReplicaLostError as exc:
                self.on_replica_lost(idx, reason=str(exc))
                continue  # the route table now points at a survivor
            except KeyError:
                # The routed replica does not know the id — it was
                # restarted under us (fresh process, empty buffers).
                # Fail the stale route over from the journal record.
                if not self._resubmit_from_journal(rid, exclude=idx):
                    raise
                continue
            for tok in res["tokens"]:
                yield int(tok)
            cursor += len(res["tokens"])
            if res["tokens"]:
                last_progress = time.monotonic()
            elif (
                self.hedge_after_s is not None
                and not hedged
                and not res["done"]
                and time.monotonic() - last_progress > self.hedge_after_s
            ):
                # Gray failure: the replica answers polls but the stream
                # has stalled past the hedge threshold — re-drive it on
                # a peer (bit-exact by the seed-chain contract; the
                # cursor dedups the delivered prefix). One hedge per
                # stream: a fleet-wide slowdown must not cascade.
                hedged = self.hedge(handle)
                if hedged:
                    last_progress = time.monotonic()
            if res["done"]:
                if res["status"] == "shipped":
                    # Disaggregated prefill: this replica prefilled and
                    # shipped the blocks to ``ship_to``. Resubmit there
                    # (same id and seed; the decode replica emits the same
                    # stream and the cursor drops the delivered first
                    # token). A dead target or a lost ship falls back to
                    # the journal failover or a cold prefill.
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"request {rid} was shipped but never "
                            f"re-driven within {timeout_s}s"
                        )
                    if self._route_of(handle) == idx:
                        if not self._follow_ship(
                            rid, res.get("ship_to"), from_replica=idx,
                            digests=res.get("ship_digests"),
                        ):
                            raise ReplicaLostError(
                                idx,
                                f"request {rid} was shipped but could "
                                "not be re-driven (no surviving "
                                "replicas)",
                            )
                    continue
                if res["status"] == "migrated":
                    # Terminal on THAT replica only: a preemption drain
                    # evicted the request for resubmission elsewhere.
                    # Follow the route table — once the drain re-routes
                    # it, the survivor re-emits the full (bit-identical)
                    # stream and the cursor dedups; until then, wait.
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"request {rid} was migrated but never "
                            f"re-routed within {timeout_s}s"
                        )
                    if self._route_of(handle) == idx:
                        time.sleep(poll_s)
                    continue
                self._finish(rid, res["status"])
                if res["status"] in ("cancelled", "expired"):
                    raise RuntimeError(
                        f"request {rid} {res['status']}"
                    )
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"request {rid} streamed no completion "
                    f"within {timeout_s}s"
                )

    def generate(
        self, prompt: Sequence[int], timeout_s: float = 300.0, **sampling: Any
    ) -> List[int]:
        """Blocking decode: returns the generated token ids."""
        return list(self.stream(prompt, timeout_s=timeout_s, **sampling))

    def result(self, handle: RequestHandle, cursor: int = 0) -> Dict[str, Any]:
        idx = self._route_of(handle)
        if idx is None:
            raise ReplicaLostError(
                handle.replica, f"request {handle.request_id} was lost"
            )
        res = self._rpc(idx, "result", handle.request_id, cursor)
        if res.get("done") and res.get("status") not in (
            "migrated", "shipped"
        ):
            # "migrated" and "shipped" are terminal on that replica, not
            # for the request: its resubmission keeps it open.
            self._finish(handle.request_id, res["status"])
        return res

    def cancel(self, handle: RequestHandle) -> bool:
        idx = self._route_of(handle)
        if idx is None:
            return False
        ok = bool(self._rpc(idx, "cancel", handle.request_id))
        self._finish(handle.request_id, "cancelled")
        return ok

    # -- session parking (the KV object store) ----------------------------
    def park_session(
        self,
        handle: RequestHandle,
        tokens: Optional[Sequence[int]] = None,
        wait_s: float = 15.0,
    ) -> Dict[str, Any]:
        """Park a finished conversation: write its cached chain to the KV
        object store and free the replica's pages. ``tokens`` is the
        conversation's whole token sequence (prompt and generated); left
        out, it is rebuilt from this client's journal (the submit's
        prompt) and the replica's result buffer. The next submit sharing
        the prefix restores it through a store fetch, on any replica."""
        rid = handle.request_id
        idx = self._route_of(handle)
        if idx is None:
            raise ReplicaLostError(handle.replica, f"request {rid} was lost")
        if tokens is None:
            prompt: Optional[List[int]] = None
            for entry in self.journal.dump().get("entries", []):
                if (
                    entry.get("kind") == "submit"
                    and entry.get("request_id") == rid
                ):
                    prompt = list(entry.get("prompt") or [])
            if prompt is None:
                raise KeyError(
                    f"request {rid} has no journal submit record; pass "
                    "tokens= explicitly"
                )
            res = self._rpc(idx, "result", rid, 0)
            tokens = prompt + [int(t) for t in res.get("tokens") or []]
        out = self._rpc(
            idx, "park_session", [int(t) for t in tokens], request_id=rid,
            wait_s=wait_s,
        )
        digests = out.get("digests") or []
        if digests and self.router is not None:
            try:
                # Open the store-held route now; the stats rings would
                # only catch up at the next refresh.
                self.router.directory.observe_store(
                    [bytes.fromhex(h) for h in digests]
                )
            except Exception:  # noqa: BLE001 - routing hints only
                pass
        self._event(
            "session_parked", request_id=rid, replica=idx,
            blocks=int(out.get("blocks") or 0),
            stored=int(out.get("stored") or 0),
            freed=int(out.get("freed") or 0),
        )
        return out

    def seed_store_directory(self, router: Optional[Any] = None) -> int:
        """Warm start: seed the router directory's store-held half from
        the KV object store's manifest, so a fresh fleet routes
        yesterday's prefixes to a store fetch from the first request.
        Returns the digests seeded; 0 without a store or a router."""
        router = router if router is not None else self.router
        if self.kvstore is None or router is None:
            return 0
        try:
            hexes = self.kvstore.manifest()
            router.directory.observe_store([bytes.fromhex(h) for h in hexes])
        except Exception:  # noqa: BLE001 - a warm start is advisory
            return 0
        if hexes:
            self._event("kvstore_warm_seed", digests=len(hexes))
        return len(hexes)

    # -- failover ----------------------------------------------------------
    def _follow_ship(
        self,
        rid: str,
        target: Optional[int],
        from_replica: int,
        digests: Optional[Sequence[str]] = None,
    ) -> bool:
        """Re-drive a shipped request on its decode target (preferred: the
        blocks went to its inbox) or any survivor. The resubmission
        carries a ``kv_hint`` of the shipped chain naming the prefill
        replica, so a lost or late ship is fetched back instead of
        prefilled cold. No exclusion: with every decode replica gone the
        prefill replica can decode it (its pool is still warm)."""
        extra = None
        if digests:
            extra = {"kv_hint": {
                "peer": int(from_replica),
                "digests": [str(d) for d in digests],
                "blocks": len(digests),
            }}
        return self._resubmit_from_journal(rid, target=target, extra=extra)

    def _resubmit_from_journal(
        self,
        rid: str,
        exclude: Optional[int] = None,
        blocks: Optional[list] = None,
        target: Optional[int] = None,
        extra: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """Replay one OPEN request's journal submit record onto a live
        replica (same id, same prompt, same full SamplingParams — the
        survivor's seeded draws reproduce the stream bit-exactly).
        ``blocks`` (preemption drain) is the dying replica's exported
        prefix KV, pushed to the chosen survivor BEFORE the resubmit so
        its admission walk hits warm. ``target`` (a ship's decode
        replica) takes the first attempt when it is alive, and ``extra``
        (the fetch hint back to the shipper) rides that submit. Returns
        False when the id has no open record or no replica can take it
        (the request is then marked lost)."""
        with self._lock:
            record = self._open.get(rid)
        if record is None:
            return False
        while True:
            idx = None
            if target is not None:
                if int(target) in self._alive(exclude=exclude):
                    idx = int(target)
                target = None  # one pinned attempt, then the pick
            try:
                idx = self._pick(exclude=exclude) if idx is None else idx
            except NoReplicasError:
                with self._lock:
                    self._route[rid] = None
                self._m_failover.inc(1, outcome="lost")
                self._event(
                    "failover", level="error", request_id=rid,
                    outcome="lost",
                )
                self.journal.record_outcome(rid, "lost")
                with self._lock:
                    self._open.pop(rid, None)
                return False
            if blocks:
                # Best-effort warmth: a failed handoff only costs the
                # survivor a cold re-prefill, never the request.
                try:
                    n = self._rpc(
                        idx, "import_prefix_blocks", blocks, retries=0
                    )
                    self._m_preempt_kv_blocks.inc(int(n))
                except Exception:  # noqa: BLE001 - see above
                    pass
                blocks = None  # one survivor gets them; don't re-ship
            try:
                self._submit_rpc(idx, rid, record["prompt"], record,
                                 extra=extra)
            except ReplicaLostError as exc:
                self.on_replica_lost(idx, reason=str(exc))
                continue
            with self._lock:
                self._route[rid] = idx
            if self.router is not None:
                try:
                    # The chain is (or is about to be) warm on the
                    # survivor — keep the shared directory truthful.
                    self.router.observe_route(record["prompt"], idx)
                except Exception:  # noqa: BLE001 - hints only
                    pass
            self._m_failover.inc(1, outcome="resubmitted")
            self._event(
                "failover", request_id=rid, outcome="resubmitted",
                to_replica=idx,
            )
            return True

    def hedge(self, handle: RequestHandle) -> bool:
        """Hedged streaming read: re-drive an OPEN request on a peer
        replica under the same id (journal record — same prompt, same
        full SamplingParams incl. seed, so the peer emits the identical
        stream and the caller's cursor dedups), then cancel the slow
        copy best-effort. The slow replica is NOT excluded — it is
        healthy by every probe; only this stream was slow. Returns False
        when there is nothing to hedge (request closed, no peer, or the
        hedge submit itself failed)."""
        rid = handle.request_id
        with self._lock:
            cur = self._route.get(rid)
            record = self._open.get(rid)
        if record is None or cur is None:
            return False
        alts = self._alive(exclude=cur)
        if not alts:
            return False
        with self._lock:
            idx = alts[self._rr % len(alts)]
            self._rr += 1
        try:
            self._submit_rpc(idx, rid, record["prompt"], record)
        except ReplicaLostError as exc:
            self.on_replica_lost(idx, reason=str(exc))
            return False
        with self._lock:
            self._route[rid] = idx
        # Best-effort cancel of the slow copy (wasted decode otherwise);
        # a failure costs nothing — the route already moved.
        try:
            self._rpc(cur, "cancel", rid, retries=0)
        except Exception:  # noqa: BLE001
            pass
        self._m_hedges.inc(1, reason="slow_stream")
        self._event(
            "request_hedged", level="warn", request_id=rid,
            from_replica=cur, to_replica=idx,
        )
        return True

    def on_replica_lost(
        self, idx: int, reason: str = ""
    ) -> Dict[str, List[str]]:
        """Declare replica ``idx`` lost: exclude it from routing and fail
        its incomplete requests (driver-journal submits without
        outcomes) over onto survivors. Idempotent — the streaming path,
        the submit path, and the supervisor may all detect the same
        death; only the first caller moves the requests."""
        idx = int(idx)
        with self._lock:
            if idx in self._lost:
                return {"resubmitted": [], "lost": []}
            self._lost.add(idx)
            self._excluded.add(idx)
            victims = sorted(
                rid for rid, r in self._route.items() if r == idx
            )
        self._m_replicas_lost.inc(1)
        self._event(
            "replica_lost", level="error", replica=idx,
            reason=str(reason)[:300], incomplete=len(victims),
        )
        if self.router is not None:
            try:
                # Its warm pages died with it: shared-prefix traffic
                # must re-learn instead of chasing a ghost.
                self.router.forget_replica(idx)
            except Exception:  # noqa: BLE001 - hints only
                pass
        # Pipelined failover: victims resubmit concurrently (each
        # _resubmit_from_journal call is self-contained and thread-safe;
        # RetryBudget/timeout semantics apply per pipelined RPC). The
        # moved/lost split stays in sorted-victim order.
        oks = self._fanout([
            (lambda r=rid: self._resubmit_from_journal(r, exclude=idx))
            for rid in victims
        ])
        moved = [rid for rid, ok in zip(victims, oks) if ok]
        lost = [rid for rid, ok in zip(victims, oks) if not ok]
        return {"resubmitted": moved, "lost": lost}

    # -- restart (the supervisor's recover arm) ----------------------------
    def can_respawn(self) -> bool:
        return self._respawn_fn is not None

    def _spawn(self, idx: int, **kw: Any) -> Tuple[Any, List[Any]]:
        """Run the retained recipe for ``idx`` and wait until the new
        leader and every follower of its gang answer a ping (the whole
        gang is killed if one does not). ``kw`` are the recipe's knobs
        (``fresh_capacity``, ``role``); a recipe without them (tests,
        custom wiring) is called with fewer. Returns ``(leader,
        followers)``."""
        leader, followers = None, []
        try:
            while True:
                try:
                    leader, followers = self._respawn_fn(idx, **kw)
                    break
                except TypeError:
                    if not kw:
                        raise
                    kw.pop("role" if "role" in kw else "fresh_capacity")
            fabric.get([_ready(a) for a in [leader] + list(followers)],
                       timeout=self._init_timeout)
        except BaseException:
            self._kill_all(([leader] if leader is not None else [])
                           + list(followers))
            raise
        return leader, list(followers)

    def respawn_replica(self, idx: int) -> Any:
        """Re-run replica ``idx``'s original spawn (same resolved
        config/bundle — ``build_engine`` reconstructs an engine that
        captures the same graphs from the same checkpoint) and swap the
        fresh actor into the routing table; a replacement held by
        :meth:`prespawn_replacement` is swapped in instead of spawning.
        The old processes (a gang's leader and followers, as a unit) are
        torn down best-effort first (they are typically already dead)."""
        idx = int(idx)
        if self._respawn_fn is None:
            raise RuntimeError(
                "this client has no respawn path (constructed without "
                "respawn_fn — use serve.start_replicas)"
            )
        self._kill_all([self._actor(idx)] + self.followers_of(idx))
        with self._lock:
            # A replacement spawned during the grace window (already
            # pinged healthy) is swapped in — zero spawn latency here.
            gang = self._prespawned.pop(idx, None)
        leader, followers = gang if gang is not None else self._spawn(idx)
        self._set_gang(idx, leader, followers)
        with self._lock:
            self._excluded.discard(idx)
            self._lost.discard(idx)
        self._event("replica_respawned", replica=idx)
        return leader

    # -- autoscaling (the router's capacity arm) ---------------------------
    def add_replica(self, role: Optional[str] = None) -> int:
        """Scale UP: spawn a brand-new replica at the next index through
        the retained spawn recipe (fresh capacity — the original
        placement group reserved exactly N bundles) and add it to the
        routing table once it pings healthy. ``role`` dedicates the new
        capacity to one disagg pool (prefill | decode; None = mixed) —
        how the autoscaler grows the two pools independently. Returns
        the new index."""
        if self._respawn_fn is None:
            raise RuntimeError(
                "this client has no spawn path (constructed without "
                "respawn_fn — use serve.start_replicas)"
            )
        with self._lock:
            idx = len(self._replicas)
            # Reserve the slot so a concurrent add picks the next index;
            # the placeholder is invisible to routing (excluded) until
            # the spawn pings healthy.
            self._replicas.append(None)
            self._excluded.add(idx)
            while len(self._roles) <= idx:
                self._roles.append("mixed")
            self._roles[idx] = str(role or "mixed")
        try:
            leader, followers = self._spawn(idx, fresh_capacity=True,
                                            role=role)
        except BaseException:
            with self._lock:
                # The slot stays a tombstone: indices never shift.
                self._retired.add(idx)
            raise
        self._set_gang(idx, leader, followers)
        with self._lock:
            self._excluded.discard(idx)
        # Fleet KV plane: the live fleet adopts the new member's inbox
        # (the spawn recipe created it; the new replica got the full
        # peer map at spawn). Best-effort — a replica that misses the
        # registration only loses fetch/ship shortcuts to the newcomer.
        q = self._kv_queues.get(idx)
        if q is not None:
            for j in self._alive(exclude=idx):
                try:
                    self._rpc(j, "register_kv_peer", idx, q, retries=0)
                except Exception:  # noqa: BLE001 - shortcuts only
                    pass
        self._event("replica_added", replica=idx)
        return idx

    def retire_replica(
        self,
        idx: int,
        drain_timeout_s: float = 30.0,
        poll_s: float = 0.05,
    ) -> Dict[str, Any]:
        """Scale DOWN gracefully: exclude ``idx`` from new traffic,
        wait (bounded) for its routed requests to finish streaming,
        LIVE-MIGRATE any leftovers onto survivors (journal resubmission
        under the same id/seed — bit-exact, cursor-deduplicated), then
        stop the actor. The index remains in the table as a RETIRED
        tombstone so every id->index mapping stays stable. No request
        is lost at retire time unless no survivor exists."""
        idx = int(idx)
        with self._lock:
            if idx in self._retired:
                return {"migrated": [], "lost": [], "already": True}
        self.exclude(idx)
        deadline = time.monotonic() + max(0.0, float(drain_timeout_s))
        while self.requests_on(idx) > 0 and time.monotonic() < deadline:
            time.sleep(poll_s)
        with self._lock:
            victims = sorted(
                rid for rid, r in self._route.items() if r == idx
            )
        oks = self._fanout([
            (lambda r=rid: self._resubmit_from_journal(r, exclude=idx))
            for rid in victims
        ])
        moved = [rid for rid, ok in zip(victims, oks) if ok]
        lost = [rid for rid, ok in zip(victims, oks) if not ok]
        with self._lock:
            self._retired.add(idx)
            actor = self._replicas[idx]
        if actor is not None:
            try:
                fabric.get(actor.stop.remote(), timeout=10.0)
            except Exception:  # noqa: BLE001 - retiring anyway
                pass
            # The gang goes as a unit: the leader's stop sent its
            # followers the drain sentinel.
            self._kill_all([actor] + self.followers_of(idx))
        if self.router is not None:
            try:
                self.router.forget_replica(idx)
            except Exception:  # noqa: BLE001
                pass
        self._event(
            "replica_retired", replica=idx,
            migrated=len(moved), lost=len(lost),
        )
        return {"migrated": moved, "lost": lost}

    # -- preemption drain (the supervisor's graceful-kill arm) -------------
    def prespawn_replacement(self, idx: int) -> bool:
        """Spawn replica ``idx``'s replacement NOW (same recipe as
        respawn) without touching the live one — the grace-window move
        that keeps fleet capacity at N through a preemption. The
        replacement is held (pinged healthy) until ``respawn_replica``
        swaps it in. Returns False when this client has no respawn path;
        True when a replacement is (already) held."""
        idx = int(idx)
        if self._respawn_fn is None:
            return False
        with self._lock:
            if idx in self._prespawned:
                return True
        # Fresh capacity, NOT the replica's placement-group bundle: the
        # dying replica still occupies that until the swap —
        # capacity-at-N through the grace window needs headroom outside
        # the reservation. A gang's replacement is a whole gang.
        gang = self._spawn(idx, fresh_capacity=True)
        with self._lock:
            self._prespawned[idx] = gang
        self._event("replica_prespawned", replica=idx)
        return True

    def preempt_drain(
        self, idx: int, budget_s: Optional[float] = None
    ) -> Dict[str, Any]:
        """Drive a preempting replica's graceful drain: exclude it from
        new traffic, ask it for the drain plan (finish-in-grace vs
        migrate, with exported prefix KV per migrating request), then
        live-migrate the migrate set — each request's blocks imported
        into a survivor and its journal submit replayed there under the
        SAME id/seed, so the stream continues bit-exactly with the
        delivered prefix deduplicated client-side. Requests in the
        finish set keep streaming from the dying replica until done."""
        idx = int(idx)
        self.exclude(idx)
        wait_s = 15.0
        timeout = (
            None if self.rpc_timeout_s is None
            else max(self.rpc_timeout_s, wait_s + 5.0)
        )
        plan = self._rpc(
            idx, "begin_drain", budget_s, wait_s=wait_s, timeout=timeout,
        )
        moved: List[str] = []
        lost: List[str] = []
        already_done = 0
        kv_blocks = 0
        for item in plan.get("migrate", []):
            rid = item["request_id"]
            with self._lock:
                known = rid in self._open
            if not known:
                # Terminal before the drain reached it (the client saw
                # the finish): nothing to migrate.
                already_done += 1
                continue
            blocks = item.get("blocks") or []
            kv_blocks += len(blocks)
            if blocks and self.kvstore is not None:
                # Fleet persistence: the migrating chain outlives BOTH
                # replicas once it is in the store. A failed put counts
                # in kvstore_write_errors_total and the drain proceeds
                # — lost loudly, never silently, never blocking.
                try:
                    self.kvstore.put_blocks(blocks)
                except Exception:  # noqa: BLE001 - best-effort tier
                    pass
            if self._resubmit_from_journal(rid, exclude=idx, blocks=blocks):
                moved.append(rid)
            else:
                lost.append(rid)
        self._m_preempt_drains.inc(1)
        finish = list(plan.get("finish", []))
        if finish:
            self._m_preempt_requests.inc(
                len(finish), outcome="finished_in_grace"
            )
        if moved:
            self._m_preempt_requests.inc(len(moved), outcome="migrated")
        if lost:
            self._m_preempt_requests.inc(len(lost), outcome="lost")
        self._event(
            "preempt_drain", level="warn", replica=idx,
            finish=len(finish), migrated=len(moved), lost=len(lost),
            kv_blocks=kv_blocks, already_done=already_done,
        )
        return {
            "finish": finish,
            "migrated": moved,
            "lost": lost,
            "kv_blocks": kv_blocks,
        }

    def requests_on(self, idx: int) -> int:
        """Open requests currently routed to replica ``idx`` (the
        supervisor's drained-yet signal)."""
        idx = int(idx)
        with self._lock:
            return sum(1 for r in self._route.values() if r == idx)

    def gang_preempt_state(self, idx: int) -> Optional[Dict[str, Any]]:
        """A pending preemption on any of replica ``idx``'s gang
        followers, read from their fabric heartbeats (a follower has no
        client-facing RPC surface: the heartbeat is its signal path);
        None when no follower reports one."""
        try:
            beats = fabric.heartbeats()
        except Exception:  # noqa: BLE001 - heartbeats are best-effort
            return None
        for f in self.followers_of(idx):
            actor_id = getattr(f, "actor_id", None)
            if actor_id is None:
                continue
            p = (beats.get(actor_id) or {}).get("preempt")
            if isinstance(p, dict) and p.get("pending"):
                return p
        return None

    # -- fault injection (chaos tests) -----------------------------------
    def inject_fault(self, replica: int, plan: Any,
                     follower: Optional[int] = None) -> list:
        """Arm a deterministic fault plan (serve.faults) on ONE live
        replica, or with ``follower`` on that member of its gang
        (:meth:`inject_follower_fault`); returns the armed rules."""
        if follower is not None:
            return self.inject_follower_fault(replica, follower, plan)
        return self._rpc(int(replica), "inject_fault", plan)

    def inject_follower_fault(self, idx: int, follower: int,
                              plan: Any) -> list:
        """Arm a fault plan on the ``follower``-th gang member of replica
        ``idx`` (a test targets ONE member of a live gang; the env gate
        would arm every process alike)."""
        return fabric.get(
            self.followers_of(idx)[int(follower)].inject_fault.remote(plan),
            timeout=30.0,
        )

    # -- ops ---------------------------------------------------------------
    @property
    def num_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def replica_is_alive(self, idx: int) -> bool:
        """Process-level liveness of replica ``idx``'s actors (no RPC):
        False once the fabric observed a process exit. A gang lives only
        while its leader and every follower do: a dead follower leaves
        the leader's collectives unanswered."""
        try:
            return all(bool(a.is_alive()) for a in
                       [self._actor(int(idx))] + self.followers_of(idx))
        except Exception:  # noqa: BLE001 - a broken handle is not alive
            return False

    def replica_heartbeat_age(self, idx: int) -> Optional[float]:
        """Age (s) of replica ``idx``'s newest fabric heartbeat push, or
        None when unavailable (client mode, heartbeats disabled, or no
        push yet) — a supervisor liveness signal that needs no RPC."""
        try:
            actor_id = getattr(self._actor(int(idx)), "actor_id", None)
            if actor_id is None:
                return None
            entry = fabric.heartbeats().get(actor_id)
            return None if entry is None else float(entry.get("age_s"))
        except Exception:  # noqa: BLE001 - heartbeats are best-effort
            return None

    def stats(self) -> List[Dict[str, Any]]:
        """Per-replica stats-endpoint snapshots, per-replica
        error-isolated: a dead replica yields an ``unreachable`` row
        instead of failing the whole pull (the fleet poller and /fleet
        must keep reporting THROUGH a replica's death). Pulls are
        pipelined across replicas — the refresh costs one slow RPC, not
        the fleet's sum."""
        def _pull(i: int) -> Dict[str, Any]:
            if self.is_retired(i):
                # A scale-down tombstone, not a failure: the row says so
                # instead of masquerading as an unreachable replica.
                return {"retired": True, "health": "retired"}
            try:
                return self._rpc(i, "stats", retries=0)
            except Exception as exc:  # noqa: BLE001 - isolate per replica
                return {
                    "unreachable": True,
                    "health": "unreachable",
                    "error": f"{type(exc).__name__}: {exc}"[:200],
                }

        return self._fanout([
            (lambda i=i: _pull(i)) for i in range(self.num_replicas)
        ])

    def trace(self, handle: RequestHandle) -> List[Dict[str, Any]]:
        """A request's recorded spans from its replica's ring buffer."""
        idx = self._route_of(handle)
        return self._rpc(
            handle.replica if idx is None else idx, "trace",
            handle.request_id,
        )

    def export_trace(
        self, handle: Optional[RequestHandle] = None, n: int = 8
    ) -> Dict[str, Any]:
        """Chrome trace-event JSON for one request (or replica 0's ``n``
        most recent when no handle is given). Single-process view; see
        :meth:`export_stitched_trace` for the cross-process merge."""
        if handle is not None:
            idx = self._route_of(handle)
            return self._rpc(
                handle.replica if idx is None else idx, "export_trace",
                handle.request_id,
            )
        return self._rpc(0, "export_trace", None, n)

    def trace_dumps(self, n: int = 16) -> List[Dict[str, Any]]:
        """Every process's trace ring in the stitching wire form: the
        client's own, each replica's and each gang follower's, tagged
        with display names (``client`` / ``replica{i}`` /
        ``follower{j}``). Pulls are best-effort — a dead replica or a
        wedged follower must not block the trace of the fleet that
        outlived it."""
        dumps = [{"name": "client", **self.tracer.dump(n)}]
        for i in range(self.num_replicas):
            try:
                d = self._rpc(i, "trace_dump", n, retries=0)
            except Exception:  # noqa: BLE001 - best-effort forensics
                continue
            dumps.append({"name": f"replica{i}", **d})
        with self._lock:
            followers = list(self._followers)
        for j, f in enumerate(followers):
            try:
                d = fabric.get(f.trace_dump.remote(n), timeout=30.0)
            except Exception:  # noqa: BLE001 - best-effort forensics
                continue
            dumps.append({"name": f"follower{j}", **d})
        return dumps

    def export_stitched_trace(self, n: int = 16) -> Dict[str, Any]:
        """ONE Chrome trace across every process a request touched:
        client submit spans, each replica's scheduler/engine spans and
        each gang follower's engine spans, on distinct process tracks
        aligned on the wall clock."""
        from ray_lightning_tpu_torch.obs.trace import merge_chrome_trace

        return merge_chrome_trace(self.trace_dumps(n))

    def recent_events(self, n: int = 256) -> List[Dict[str, Any]]:
        """The fleet's structured event rings merged on wall-clock ts,
        each event tagged with its source replica (dead replicas are
        skipped — their last events live in the driver's own ring as
        replica_lost/failover records)."""
        rows: List[Dict[str, Any]] = []
        for i in range(self.num_replicas):
            try:
                evs = self._rpc(i, "recent_events", n, retries=0)
            except Exception:  # noqa: BLE001 - isolate per replica
                continue
            rows.extend({**ev, "replica": i} for ev in evs)
        rows.sort(key=lambda e: e.get("ts", 0))
        return rows[-int(n):]

    def events_jsonl(self, n: int = 256) -> str:
        """The merged event tail as JSONL (the ``/events`` route body)."""
        import json

        rows = self.recent_events(n)
        return "\n".join(
            json.dumps(r, default=str) for r in rows
        ) + ("\n" if rows else "")

    def journal_dumps(
        self, n: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        """Every replica's workload journal in the wire form (header +
        entries), index-aligned with the replica list — the replay
        substrate (obs.journal). A dead replica contributes an empty
        journal (its in-process ring died with it; the client-side
        journal in ``self.journal`` still has the driver's view)."""
        out: List[Dict[str, Any]] = []
        for i in range(self.num_replicas):
            try:
                out.append(self._rpc(i, "journal_dump", n, retries=0))
            except Exception:  # noqa: BLE001 - isolate per replica
                out.append({"header": None, "entries": []})
        return out

    def journal_jsonl(self, n: Optional[int] = None) -> str:
        """The fleet's journals as JSONL (the ``/journal`` route body).
        A single replica's journal comes back verbatim (directly
        replayable); multi-replica output tags every line with its
        replica index — ``obs.journal.load_journal(path, replica=i)``
        filters one
        replica's stream back out."""
        from ray_lightning_tpu_torch.obs.journal import dump_to_jsonl

        dumps = self.journal_dumps(n)
        if len(dumps) == 1:
            return dump_to_jsonl(dumps[0])
        return "".join(
            dump_to_jsonl(d, replica=i) for i, d in enumerate(dumps)
        )

    def health(self) -> List[Dict[str, Any]]:
        """Per-replica health reports (obs.health), index-aligned with
        the replica list and per-replica error-isolated: a replica that
        cannot answer gets an ``unreachable`` verdict row — the driver's
        /healthz must aggregate a PARTIALLY dead fleet, not 500 on it.
        Probes are pipelined across replicas."""
        def _probe(i: int) -> Dict[str, Any]:
            if self.is_retired(i):
                return {
                    "verdict": "retired",
                    "healthy": False,
                    "retired": True,
                    "reasons": ["retired by scale-down"],
                    "components": {},
                    "watchdog": False,
                }
            try:
                return self._rpc(i, "health", retries=0)
            except Exception as exc:  # noqa: BLE001 - isolate per replica
                return {
                    "verdict": "unreachable",
                    "healthy": False,
                    "reasons": [
                        f"health RPC failed: "
                        f"{type(exc).__name__}: {exc}"[:200]
                    ],
                    "components": {},
                    "watchdog": False,
                }

        return self._fanout([
            (lambda i=i: _probe(i)) for i in range(self.num_replicas)
        ])

    def health_one(
        self, idx: int, timeout: Optional[float] = None
    ) -> Dict[str, Any]:
        """One replica's health report, raising ReplicaLostError when it
        cannot answer — the supervisor's probe primitive."""
        return self._rpc(
            int(idx), "health", timeout=timeout, retries=0
        )

    def debug_dump(
        self, reason: str = "rpc", replica: int = 0, pull: bool = True
    ) -> Dict[str, Any]:
        """Flight-recorder bundle from one replica: the manifest plus
        (``pull``) the bundle files inline, so the driver/doctor can
        save them without a shared filesystem."""
        return self._rpc(
            int(replica), "debug_dump", reason, pull, timeout=120.0,
        )

    def metrics_text(self) -> str:
        """All replicas' registries as ONE Prometheus exposition: each
        replica's series gets a ``replica="<i>"`` label so identical
        metric names across replicas stay distinct for the scraper.
        Dead replicas simply drop out of the scrape."""
        from ray_lightning_tpu_torch.obs.registry import relabel_text

        texts: List[Tuple[int, str]] = []
        for i in range(self.num_replicas):
            try:
                t = self._rpc(i, "metrics_text", retries=0)
            except Exception:  # noqa: BLE001 - isolate per replica
                continue
            if t:
                texts.append((i, t))
        if len(texts) == 1 and self.num_replicas == 1:
            return texts[0][1]
        parts = [
            relabel_text(t, replica=i).rstrip("\n") for i, t in texts
        ]
        return "\n".join(parts) + ("\n" if parts else "")

    def profile(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        raise NotImplementedError(
            "ServeClient.profile (a torch.profiler capture) is not ported "
            "yet (ROADMAP queue 1 item 14)"
        )

    def shutdown(self) -> None:
        # Teardown failures are CLASSIFIED, not swallowed: an already-dead
        # actor
        # is expected churn (info), anything else is a silent-teardown
        # bug surfaced as a warn-level drain_failed event.
        def _drain(kind: str, replica_idx: int, actor: Any) -> None:
            try:
                fabric.get(actor.stop.remote(), timeout=10.0)
            except Exception as exc:  # noqa: BLE001 - classified below
                already_dead = isinstance(exc, fabric.ActorDiedError)
                self._event(
                    "drain_failed",
                    level="info" if already_dead else "warn",
                    kind=kind, replica=replica_idx, stage="stop",
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )
            try:
                fabric.kill(actor)
            except Exception as exc:  # noqa: BLE001
                self._event(
                    "drain_failed", level="warn",
                    kind=kind, replica=replica_idx, stage="kill",
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )

        with self._lock:
            replicas = list(self._replicas)
            retired = set(self._retired)
            prespawned = list(self._prespawned.items())
            self._prespawned = {}
            followers = list(zip(self._followers, self._follower_replica))
        for i, r in enumerate(replicas):
            if r is None or i in retired:
                continue  # scale-down tombstones are already gone
            _drain("replica", i, r)
        # After their leaders, whose stop sent them the drain sentinel.
        for f, i in followers:
            if i not in retired:
                _drain("follower", i, f)
        # Unconsumed grace-window replacements die with the fleet.
        for i, (leader, gang) in prespawned:
            _drain("replica", i, leader)
            for f in gang:
                _drain("follower", i, f)
        if self._pg is not None:
            try:
                fabric.remove_placement_group(self._pg)
            except Exception as exc:  # noqa: BLE001
                self._event(
                    "drain_failed", level="warn",
                    kind="placement_group", replica=-1, stage="remove",
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )
            self._pg = None


class _SubmitBatcher:
    """Opt-in micro-batching window for :meth:`ServeClient.submit`
    (``submit_batch_ms > 0``): the FIRST submit arriving on an empty
    window becomes the flush leader — it waits the window out, then
    drives the whole accumulated batch through the client's batched
    spine (one vectorized plan_many, one submit_many RPC per target)
    and hands every waiter its own handle or typed exception. No
    background thread: an idle client costs nothing, and a crashing
    flush wakes every waiter with the error instead of hanging them.

    Serial semantics are preserved per request — same journal records,
    ids, seeds, outcomes; only the wire traffic batches. The window
    adds up to ``window_s`` of submit latency by design: leave it off
    (the default) unless the driver is submit-bound."""

    def __init__(self, client: "ServeClient", window_s: float) -> None:
        self.client = client
        self.window_s = max(0.0, float(window_s))
        self._lock = threading.Lock()
        self._pending: List[Dict[str, Any]] = []

    def submit(self, entry: Dict[str, Any]) -> Any:
        cell: Dict[str, Any] = {
            "entry": entry, "done": threading.Event(), "result": None,
        }
        with self._lock:
            leader = not self._pending
            self._pending.append(cell)
        if leader:
            if self.window_s > 0.0:
                time.sleep(self.window_s)
            with self._lock:
                batch, self._pending = self._pending, []
            try:
                results = self.client._submit_entries(
                    [c["entry"] for c in batch]
                )
            except BaseException as exc:  # noqa: BLE001 - fan the
                results = [exc] * len(batch)  # error out, never hang
            for c, r in zip(batch, results):
                c["result"] = r
                c["done"].set()
        cell["done"].wait()
        return cell["result"]


def start_replicas(
    num_replicas: int = 1,
    *,
    num_cpus_per_replica: float = 1,
    num_gpus_per_replica: float = 0,
    placement_strategy: str = "PACK",
    env: Optional[Dict[str, Any]] = None,
    init_timeout: float = 300.0,
    hosts_per_replica: int = 1,
    coordinator_host: str = "127.0.0.1",
    rpc_timeout_s: Optional[float] = None,
    retry_budget_ratio: Optional[float] = 0.5,
    hedge_after_s: Optional[float] = None,
    submit_batch_ms: float = 0.0,
    roles: Any = None,
    kvfleet: Optional[bool] = None,
    kvfleet_timeout_s: float = 5.0,
    kvfleet_inflight_mb: float = 64.0,
    kvfleet_bandwidth_mbps: float = 0.0,
    device: Any = "cuda",
    **replica_kwargs: Any,
) -> ServeClient:
    """Spawn a replica fleet on the fabric and return a connected client.

    Multi-replica fleets reserve their bundles atomically through a
    placement group (so a partially-placeable fleet fails fast instead
    of deadlocking half-started); ``replica_kwargs`` go to ServeReplica
    (ckpt_path/model_config/int8/num_slots/...), and ``device`` to every
    replica's engine: the card unless the caller passes ``"cpu"``.
    ``num_gpus_per_replica`` is each replica's share of a card: whole
    cards are each replica's own (``CUDA_VISIBLE_DEVICES``), fractions
    pack replicas onto one card. A replica whose engine fails to build
    (no CUDA context, a kernel that does not load) fails the spawn here.
    ``rpc_timeout_s`` bounds every client RPC (see :class:`ServeClient`).

    Fleet KV plane: ``roles`` dedicates replicas to disaggregated
    prefill and decode (one role for the whole fleet, or one per index,
    ``["prefill", "decode"]``); ``kvfleet`` turns the cross-replica
    transfers on (None: on for a multi-replica fleet with a prefix cache
    or paged KV). With the plane on every replica gets an inbox queue and
    every peer's; ``kvfleet_timeout_s`` / ``kvfleet_inflight_mb`` /
    ``kvfleet_bandwidth_mbps`` bound the transfers (a timeout falls back
    to a cold prefill). With ``kvstore_dir`` in ``replica_kwargs`` the
    client gets its own handle on the same KV object store, in the
    replicas' namespace (``ServeClient.seed_store_directory``).

    The spawn recipe for each replica index is retained on the returned
    client as its ``respawn_fn``: ``FleetSupervisor`` restarts a dead
    replica by re-running exactly this spawn (same resolved config, same
    placement-group bundle, same role, and with the plane on the same
    inbox and peer wiring), and ``fresh_capacity=True`` spawns outside
    the reservation (a preemption's pre-spawn, an autoscaled replica).

    ``hosts_per_replica > 1`` with ``mesh="MODELxDATA"`` spawns each
    replica as a tensor-parallel gang: the leader (rank 0, the RPC
    surface) and ``hosts_per_replica - 1`` ``ServeShardFollower`` ranks,
    each a fabric actor with its own ``num_gpus_per_replica`` share of a
    card, joined into one ``torch.distributed`` world at a free port of
    ``coordinator_host`` (NCCL where each rank owns a whole card, gloo
    where ranks share one or run on the CPU); the leader streams its
    engine ops to the followers over one fabric queue each. The whole gang
    is placed before any constructor returns (every member blocks in the
    rendezvous until all have joined), and a half-spawned gang is torn
    down. The port runs one process per card, so ``hosts_per_replica``
    must equal model x data: anything else is several cards per worker
    process (ROADMAP queue 1 item 11b) and raises.
    """
    from ray_lightning_tpu_torch.parallel.mesh import parse_mesh_spec
    from ray_lightning_tpu_torch.serve.kvfleet import ROLES

    if num_replicas < 1:
        raise ValueError("num_replicas must be >= 1")
    hosts = int(hosts_per_replica)
    if hosts < 1:
        raise ValueError("hosts_per_replica must be >= 1")
    model, data = parse_mesh_spec(replica_kwargs.get("mesh"))
    if model * data != hosts:
        raise NotImplementedError(
            f"hosts_per_replica={hosts} with mesh "
            f"{replica_kwargs.get('mesh')!r} ({model}x{data} = "
            f"{model * data} ranks): the port runs one process per card, so "
            "a gang has exactly model x data ranks; several cards per "
            "worker process are not ported yet (ROADMAP queue 1 item 11b)"
        )
    #: The gang's backend: NCCL where each rank owns a whole card (the
    #: rule of strategies/base.py), gloo on shares of one or the CPU.
    backend = ("nccl" if str(device).startswith("cuda")
               and float(num_gpus_per_replica) >= 1.0 else "gloo")
    if roles is None:
        roles_list = ["mixed"] * num_replicas
    elif isinstance(roles, str):
        roles_list = [roles] * num_replicas
    else:
        roles_list = [str(r) for r in roles]
    if len(roles_list) != num_replicas:
        raise ValueError(
            f"roles has {len(roles_list)} entries for {num_replicas} "
            "replicas (pass one role per replica, or one string)"
        )
    bad_roles = sorted(set(roles_list) - set(ROLES))
    if bad_roles:
        raise ValueError(f"unknown role(s) {bad_roles}; valid roles: {ROLES}")
    has_cache = bool(
        replica_kwargs.get("prefix_blocks")
        or replica_kwargs.get("kv_pages")
    )
    if "prefill" in roles_list:
        if "decode" not in roles_list and "mixed" not in roles_list:
            raise ValueError(
                "a fleet of only prefill replicas can never decode: add "
                "decode (or mixed) replicas"
            )
        if not has_cache:
            raise ValueError(
                "disaggregated prefill (role='prefill') ships KV blocks "
                "through the prefix pool: set prefix_blocks (dense) or "
                "kv_pages (paged)"
            )
    kvfleet_on = (
        bool(kvfleet) if kvfleet is not None
        else (num_replicas > 1 and has_cache)
    )
    if "prefill" in roles_list and not kvfleet_on:
        raise ValueError(
            "disaggregated prefill needs the fleet KV plane (kvfleet=False "
            "turned it off)"
        )
    bundle: Dict[str, float] = {"CPU": float(num_cpus_per_replica)}
    if num_gpus_per_replica:
        bundle["GPU"] = float(num_gpus_per_replica)
    pg = None
    if num_replicas * hosts > 1:
        pg = fabric.placement_group(
            [dict(bundle) for _ in range(num_replicas * hosts)],
            strategy=placement_strategy,
        )
    actor_cls = fabric.remote(ServeReplica)
    follower_cls = fabric.remote(ServeShardFollower)

    def opts_for(
        bundle_index: int, fresh_capacity: bool = False
    ) -> Dict[str, Any]:
        o: Dict[str, Any] = {
            "num_cpus": num_cpus_per_replica,
            "env": dict(env or {}),
            "init_timeout": init_timeout,
        }
        if num_gpus_per_replica:
            o["num_gpus"] = num_gpus_per_replica
        if pg is not None and not fresh_capacity:
            o["placement_group"] = pg
            o["placement_group_bundle_index"] = bundle_index
        return o

    # One inbox per replica, made before any spawn (every replica's peer
    # map must hold the whole fleet), and lazily for an autoscaled index
    # (add_replica broadcasts the newcomer's inbox to the live fleet).
    kv_queues: Dict[int, Any] = {}
    if kvfleet_on:
        kv_queues = {i: fabric.Queue() for i in range(num_replicas)}
    #: index -> resolved role; spawn and respawn both read it, so a
    #: restarted prefill replica comes back a prefill replica, and an
    #: autoscaled index keeps its role across restarts.
    role_by_index: Dict[int, str] = dict(enumerate(roles_list))
    #: index -> its gang's op queues (one per follower).
    op_queues: Dict[int, List[Any]] = {}

    def spawn_replica(
        i: int, fresh_capacity: bool = False, role: Optional[str] = None
    ) -> Tuple[Any, List[Any]]:
        """Spawn replica ``i``'s process from the SAME resolved kwargs and
        bundle every time: the initial launch and every restart run
        exactly this (``role`` overrides only for a brand-new autoscaled
        index; respawns reuse the recorded role). ``fresh_capacity``
        draws free capacity instead of the replica's placement-group
        bundles: a preemption's pre-spawn runs while the dying replica
        still holds them (no headroom fails fast). Returns ``(leader,
        followers)``: a gang gets a fresh coordinator port and fresh op
        queues each time, and its members are spawned without waiting for
        their constructors (each blocks in the rendezvous until all have
        joined); the caller's ping is the readiness barrier."""
        resolved_role = str(role or role_by_index.get(i, "mixed"))
        role_by_index[i] = resolved_role
        kw = dict(replica_kwargs, device=device, role=resolved_role)
        if kvfleet_on:
            if i not in kv_queues:
                kv_queues[i] = fabric.Queue()
            kw.update(
                kv_self=i,
                kv_inbox=kv_queues[i],
                kv_peers=dict(kv_queues),
                kvfleet_timeout_s=float(kvfleet_timeout_s),
                kvfleet_inflight_mb=float(kvfleet_inflight_mb),
                kvfleet_bandwidth_mbps=float(kvfleet_bandwidth_mbps),
            )
        if hosts == 1:
            return actor_cls.options(**opts_for(i, fresh_capacity)).remote(
                **kw), []
        coordinator = f"{coordinator_host}:{find_free_port(coordinator_host)}"
        # Held here for the gang's life: a manager queue whose last driver
        # proxy is collected is gone before a member unpickles its copy.
        queues = op_queues[i] = [fabric.Queue() for _ in range(hosts - 1)]

        def dist(rank: int) -> Dict[str, Any]:
            return {"num_hosts": hosts, "host_rank": rank,
                    "coordinator_address": coordinator, "backend": backend}

        engine_kwargs = {k: v for k, v in kw.items()
                         if k in ENGINE_KEYS or k in STORE_KEYS}
        gang: List[Any] = []
        try:
            for rank in range(1, hosts):
                gang.append(follower_cls.options(
                    lazy_init=True,
                    **opts_for(i * hosts + rank, fresh_capacity),
                ).remote(op_queue=queues[rank - 1], dist=dist(rank),
                         device=device, **engine_kwargs))
            leader = actor_cls.options(
                lazy_init=True, **opts_for(i * hosts, fresh_capacity),
            ).remote(dist=dist(0), gang_queues=queues, **kw)
        except BaseException:
            # Followers blocked in a rendezvous their leader will never
            # join would hold their shares until the store times out.
            for f in gang:
                try:
                    fabric.kill(f)
                except Exception:  # noqa: BLE001
                    pass
            raise
        return leader, gang

    replicas: List[Any] = []
    followers: List[Any] = []
    follower_replica: List[int] = []
    try:
        for i in range(num_replicas):
            leader, gang = spawn_replica(i)
            replicas.append(leader)
            followers.extend(gang)
            follower_replica.extend([i] * len(gang))
        fabric.get([_ready(r) for r in replicas + followers],
                   timeout=init_timeout)
    except BaseException:
        for r in replicas + followers:
            try:
                fabric.kill(r)
            except Exception:  # noqa: BLE001
                pass
        if pg is not None:
            try:
                fabric.remove_placement_group(pg)
            except Exception:  # noqa: BLE001
                pass
        raise
    # The driver's handle on the KV object store the replicas share, in
    # the namespace every replica derives from the same raw kwargs.
    kvstore = None
    if replica_kwargs.get("kvstore_dir"):
        from ray_lightning_tpu_torch.serve.kvstore import (
            FleetKVStore,
            kvstore_namespace,
        )

        ns = replica_kwargs.get("kvstore_namespace") or kvstore_namespace(
            replica_kwargs.get("ckpt_path"),
            replica_kwargs.get("model_config"),
        )
        kvstore = FleetKVStore(
            str(replica_kwargs["kvstore_dir"]),
            budget_mb=float(replica_kwargs.get("kvstore_mb", 0.0)),
            namespace=ns,
        )
    return ServeClient(
        replicas,
        pg=pg,
        followers=followers,
        follower_replica=follower_replica,
        respawn_fn=spawn_replica,
        rpc_timeout_s=rpc_timeout_s,
        init_timeout=init_timeout,
        retry_budget_ratio=retry_budget_ratio,
        hedge_after_s=hedge_after_s,
        submit_batch_ms=submit_batch_ms,
        roles=roles_list,
        kv_queues=kv_queues,
        kvstore=kvstore,
    )
