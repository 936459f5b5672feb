"""Front-door router: the driver-side routing policy layer (PyTorch port
of ``ray_lightning_tpu/serve/router.py``).

:class:`Router` is the policy ``ServeClient.submit`` consults instead of
round-robin, composing three mechanisms:

1. **Health/state-aware weighting** — supervisor replica states
   (DRAINING / DEAD / PREEMPTING / FAILED / RETIRED) and ``health()``
   verdicts demote or exclude replicas. A ``degraded`` replica keeps
   serving at reduced weight; an ``unhealthy`` or state-excluded one
   receives no new traffic at all.
2. **Prefix-affinity routing** — the router hashes the prompt's token
   blocks with the SAME chained blake2 digests ``serve/engine.py``
   computes for its prefix pool, and remembers which replica served each
   chain in the shared :class:`serve.kvfleet.FleetKVDirectory` (invalidated
   on replica loss and on the engines' reported block evictions).
   Shared-prefix traffic lands on the replica holding the warm pages,
   weighted by each replica's effective cache size. A plan that steers a
   request away from its chain's holder carries a ``kv_hint`` naming the
   holder (or, with no live holder, the KV object store), which the
   target's fleet KV plane fetches from instead of prefilling cold.
3. **Admission control + graceful shedding** — per-replica load estimates
   (queue depth, slot occupancy, paged-KV occupancy, windowed decode rate)
   gate routing. A submit whose ``deadline_s`` cannot be met even at the
   target's windowed decode rate is REJECTED up front (typed, with a
   retry-after hint) instead of queueing to expire server-side; when the
   whole fleet is saturated, deadline-infeasible and lowest-priority work
   is shed at the front door.

The shed contract: a rejected submit raises :class:`RequestRejectedError`
carrying ``reason`` and ``retry_after_s``. Paired with the client-side
:class:`RetryBudget` a sick fleet gets backpressure, not a retry storm;
the client's optional hedged streaming reads (``hedge_after_s``) re-drive
a slow-but-healthy replica's stream on a peer bit-exactly.

Not ported yet: the queue-driven ``RouterAutoscaler`` (ROADMAP queue 1
item 10b) and the ``FleetPoller`` feed (``poller=``, item 14).
"""
from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

from ray_lightning_tpu_torch.serve.kvfleet import FleetKVDirectory

#: Supervisor states that must receive no NEW traffic (the recovery
#: plane's exclusions, consumed here instead of trusted to be manual).
NO_TRAFFIC_STATES = frozenset(
    ("draining", "dead", "restarting", "failed", "preempting", "retired")
)

#: Health-verdict base weights: degraded keeps serving at half weight,
#: unknown (no verdict yet — e.g. a freshly added replica) near full.
_VERDICT_WEIGHT = {
    "healthy": 1.0,
    "degraded": 0.5,
    "unknown": 0.9,
    "retired": 0.0,
    "unhealthy": 0.0,
    "unreachable": 0.0,
}


class RequestRejectedError(RuntimeError):
    """The router refused the submit at the front door (admission
    control): the typed ``rejected`` outcome. Carries why
    (``deadline_infeasible`` | ``saturated``) and a ``retry_after_s``
    hint, so callers back off instead of treating overload or an
    impossible deadline like a crash."""

    def __init__(
        self, reason: str, retry_after_s: float, detail: str = ""
    ) -> None:
        msg = f"request rejected ({reason}); retry after {retry_after_s:g}s"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)
        self.reason = reason
        self.retry_after_s = float(retry_after_s)


def prompt_block_digests(
    tokens: Sequence[int], block: int
) -> List[bytes]:
    """Chained blake2 digests of the prompt's FULL token blocks —
    digest i commits to tokens[0:(i+1)*block], the exact chaining
    ``DecodeEngine._block_digests`` uses, so the router's affinity map
    and the engines' prefix pools agree on what a shared prefix is."""
    import numpy as np

    out: List[bytes] = []
    d = b""
    arr = np.asarray(list(tokens), np.int32)
    for i in range(len(arr) // block):
        d = hashlib.blake2b(
            d + arr[i * block : (i + 1) * block].tobytes(),
            digest_size=16,
        ).digest()
        out.append(d)
    return out


class DigestChainCache:
    """Incremental chained-digest cache: computing a prompt's chain
    walks block by block, and each step is a pure function of
    ``(previous digest, block bytes)`` — so a bounded LRU keyed on
    exactly that pair lets a shared-prefix re-visit REUSE every
    already-hashed step and blake2 only the novel tail. The emitted
    chain is bit-identical to :func:`prompt_block_digests` (cache
    hits return the same digests the hash would), so the directory,
    the engines' prefix pools, and the affinity policy keep agreeing
    on what a shared prefix is.

    Memory bound: ``capacity`` entries, each holding one
    ``(16-byte head, block*4-byte block, 16-byte digest)`` triple —
    ~6 MB at the default 65536 entries with 16-token blocks.

    Counter-instrumented (``chains`` computed, ``blocks_hashed``,
    ``blocks_reused``) so the one-chain-per-submit contract and the
    tail-only-hashing behavior are directly testable."""

    def __init__(self, block: int, capacity: int = 65536) -> None:
        self.block = max(1, int(block))
        self.capacity = max(16, int(capacity))
        self._lock = threading.Lock()
        #: (prev_digest, block_bytes) -> digest (bounded LRU).
        self._map: "OrderedDict[Any, bytes]" = OrderedDict()
        self.chains = 0
        self.blocks_hashed = 0
        self.blocks_reused = 0

    def digests(self, tokens: Sequence[int]) -> List[bytes]:
        """The prompt's chained block digests (bit-identical to
        :func:`prompt_block_digests`), hashing only the steps the LRU
        has not seen."""
        import numpy as np

        out: List[bytes] = []
        d = b""
        arr = np.asarray(list(tokens), np.int32)
        n = len(arr) // self.block
        with self._lock:
            self.chains += 1
            for i in range(n):
                blk = arr[i * self.block : (i + 1) * self.block].tobytes()
                key = (d, blk)
                nxt = self._map.get(key)
                if nxt is None:
                    nxt = hashlib.blake2b(
                        d + blk, digest_size=16
                    ).digest()
                    self.blocks_hashed += 1
                else:
                    self.blocks_reused += 1
                self._map[key] = nxt
                self._map.move_to_end(key)
                out.append(nxt)
                d = nxt
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "chains": self.chains,
                "blocks_hashed": self.blocks_hashed,
                "blocks_reused": self.blocks_reused,
                "entries": len(self._map),
            }


class RetryBudget:
    """Shared client-side retry budget: transient-failure retries are
    allowed only up to ``ratio`` of the submits seen in the sliding
    ``window_s``, plus a ``floor`` so a quiet client can still ride out
    a blip. Per-call retry caps bound one RPC; this bounds the
    AGGREGATE — a sick fleet gets backpressure, not a retry storm."""

    def __init__(
        self,
        ratio: float = 0.5,
        window_s: float = 30.0,
        floor: int = 8,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.ratio = float(ratio)
        self.window_s = float(window_s)
        self.floor = max(0, int(floor))
        self._clock = clock
        self._lock = threading.Lock()
        self._submits: deque = deque()
        self._retries: deque = deque()

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        while self._submits and self._submits[0] < cutoff:
            self._submits.popleft()
        while self._retries and self._retries[0] < cutoff:
            self._retries.popleft()

    def note_submit(self) -> None:
        now = self._clock()
        with self._lock:
            self._prune(now)
            self._submits.append(now)

    def allowed(self) -> int:
        """Retries the current window permits in total."""
        with self._lock:
            self._prune(self._clock())
            return self.floor + int(self.ratio * len(self._submits))

    def try_spend(self) -> bool:
        """Take one retry from the budget; False when exhausted (the
        caller should fail over / surface the error instead of
        retrying)."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            if len(self._retries) >= (
                self.floor + int(self.ratio * len(self._submits))
            ):
                return False
            self._retries.append(now)
            return True


def _hex_digests(items: Any) -> List[bytes]:
    """Decode a replica-reported ring of hex digest strings, dropping
    malformed entries individually.  The rings are advisory: one bad
    entry must not veto the valid digests around it (the directory's
    striped batch paths consume the whole list before acting)."""
    out: List[bytes] = []
    try:
        it = iter(items)
    except TypeError:
        return out
    for h in it:
        try:
            out.append(bytes.fromhex(h))
        except (TypeError, ValueError):
            continue
    return out


def _default_view(idx: int) -> Dict[str, Any]:
    """A neutral view for a replica the fleet plane has not reported on
    yet (e.g. freshly added by the autoscaler): routable, unloaded."""
    return {
        "replica": int(idx),
        "health": "unknown",
        "state": "healthy",
        "role": "mixed",
        "queue_depth": 0,
        "active_slots": 0,
        "num_slots": 1,
        "decode_tokens_per_sec": 0.0,
        "prefix_bytes": 0,
        "kv_occupancy": None,
        "goodput": 0.0,
        "slo_breaches": 0,
        "slo_breach_delta": 0,
    }


@dataclass(frozen=True)
class RoutePlan:
    """One routing decision: where the request goes (``replica``), and
    — fleet KV plane — where its finished-prefill pages ship
    (``ship_to``, disaggregated placement only) plus a warm-peer fetch
    hint (``kv_hint = {"peer", "digests", "blocks"}``) when a DIFFERENT
    replica holds the prompt's digest chain."""

    replica: int
    ship_to: Optional[int] = None
    kv_hint: Optional[Dict[str, Any]] = None
    policy: str = "weighted"
    #: The prompt's chained block digests, computed ONCE for this plan
    #: — the caller threads them back into ``observe_route`` so one
    #: submit hashes its chain exactly one time (plan → hint →
    #: directory observe all share this list). Routing metadata, never
    #: serialized onto the RPC.
    digests: Optional[List[bytes]] = None


class Router:
    """The front-door routing policy (see module docstring).

    ``client`` supplies the live signals (``stats()`` / ``health()``
    fleet pulls and ``requests_on``); ``poller`` (obs.fleet.FleetPoller,
    ROADMAP queue 1 item 14) is accepted as None only; ``state_fn``
    feeds per-replica recovery states into the exclusion logic.
    Views refresh lazily at ``refresh_s`` cadence — routing itself is
    pure host-side math on the cached rows.

    Knobs: ``affinity`` toggles prefix-affinity (``prefix_block`` must
    match the engines' block/page size for the digests to line up;
    ``affinity_bias`` scales how strongly a matched prefix outranks
    load); ``shed`` arms admission control (``shed_queue_factor`` — the
    fleet is saturated when every routable replica's queue reaches this
    many times its slot count); ``retry_after_s`` floors the hint a
    rejection carries.
    """

    def __init__(
        self,
        client: Any = None,
        poller: Any = None,
        state_fn: Optional[Callable[[], List[Dict[str, Any]]]] = None,
        refresh_s: float = 1.0,
        affinity: bool = True,
        prefix_block: int = 16,
        affinity_bias: float = 2.0,
        affinity_map_size: int = 65536,
        shed: bool = True,
        shed_queue_factor: float = 4.0,
        retry_after_s: float = 0.25,
        directory_shards: int = 1,
        registry: Optional[Any] = None,
        events: Optional[Any] = None,
        directory: Optional[FleetKVDirectory] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        from ray_lightning_tpu_torch.obs.events import get_event_log
        from ray_lightning_tpu_torch.obs.registry import get_registry

        if poller is not None:
            raise NotImplementedError(
                "Router(poller=...) needs obs.fleet.FleetPoller, not ported "
                "yet (ROADMAP queue 1 item 14); the router pulls the "
                "client's stats and health itself"
            )
        self.client = client
        self.poller = poller
        self.state_fn = state_fn
        self.refresh_s = float(refresh_s)
        self.affinity = bool(affinity)
        self.prefix_block = max(1, int(prefix_block))
        self.affinity_bias = float(affinity_bias)
        self.affinity_map_size = max(16, int(affinity_map_size))
        self.shed = bool(shed)
        self.shed_queue_factor = float(shed_queue_factor)
        self.retry_after_s = float(retry_after_s)
        self._clock = clock
        self._events = events if events is not None else get_event_log()
        reg = registry if registry is not None else get_registry()
        self._m_routed = reg.counter(
            "rlt_router_routed_total",
            "Submits the router placed, by deciding policy "
            "(affinity / weighted / fallback)",
        )
        self._m_shed = reg.counter(
            "rlt_router_shed_total",
            "Submits rejected at the front door, by reason "
            "(deadline_infeasible / saturated)",
        )
        self._m_rebalances = reg.counter(
            "rlt_router_rebalances_total",
            "Route-table reweights: replicas excluded from or restored "
            "to the routable set, by reason",
        )
        self._m_weight = reg.gauge(
            "rlt_router_replica_weight",
            "Router base weight per replica (0 = excluded; health x "
            "load, before per-request affinity)",
        )
        self._m_plan_batch = reg.counter(
            "rlt_router_plan_batch_size",
            "Vectorized plan calls by batch-size bucket "
            "(1 / 2-7 / 8-31 / 32-127 / 128+) — histogram-style",
        )
        self._lock = threading.RLock()
        #: The fleet KV directory (serve.kvfleet): digest -> replica,
        #: ONE source of truth shared by this router's prefix-affinity
        #: policy and the fleet KV plane's fetch hints. One
        #: invalidation path covers replica loss/retire
        #: (forget_replica) AND block eviction (the engines'
        #: dropped-digest stats rows, fed back in refresh()).
        self.directory = (
            directory
            if directory is not None
            else FleetKVDirectory(
                capacity=self.affinity_map_size,
                shards=max(1, int(directory_shards)),
            )
        )
        #: One chain computation per submit: plan computes the digests
        #: through this cache, the RoutePlan carries them, and
        #: observe_route / _fetch_hint consume the SAME list.
        self.digest_cache = DigestChainCache(
            self.prefix_block, capacity=self.affinity_map_size
        )
        #: idx -> merged view row (fleet row + supervisor state).
        self._views: Dict[int, Dict[str, Any]] = {}
        self._views_t = float("-inf")
        #: idx -> routable? from the previous refresh (rebalance diffs).
        self._routable_prev: Dict[int, bool] = {}
        #: idx -> last-seen cumulative SLO-breach count (refresh diffs
        #: it into the view's slo_breach_delta — the actively-breaching
        #: demotion signal).
        self._breaches_prev: Dict[int, int] = {}
        self._rr = 0
        # Cumulative decision counters (the /fleet router totals; the
        # registry counters carry the labelled split).
        self.routed = 0
        self.shed_count = 0
        # Plan-throughput accounting (batches / requests planned /
        # wall spent planning — the `plan b/µs` column).
        self.plan_batches = 0
        self.plan_requests = 0
        self.plan_wall_s = 0.0

    # -- views -------------------------------------------------------------
    def _event(self, name: str, level: str = "info", **kv: Any) -> None:
        try:
            self._events.record("router", name, level=level, **kv)
        except Exception:  # noqa: BLE001 - observability must not route
            pass

    def _pull_rows(self) -> Optional[List[Dict[str, Any]]]:
        """Fleet rows (obs.fleet.summarize_replica schema): the poller's
        latest snapshot when wired (one pull for the whole control
        plane), else a direct client stats+health pull."""
        if self.poller is not None:
            try:
                snap = self.poller.latest()
            except Exception:  # noqa: BLE001 - fall through to the pull
                snap = None
            if snap and snap.get("replicas"):
                return list(snap["replicas"])
        if self.client is None:
            return None
        from ray_lightning_tpu_torch.obs.fleet import summarize_replica

        try:
            stats = self.client.stats()
            health = self.client.health()
        except Exception:  # noqa: BLE001 - a broken pull routes neutral
            return None
        return [
            summarize_replica(
                s, health[i] if i < len(health) else None, index=i
            )
            for i, s in enumerate(stats)
        ]

    def refresh(self, force: bool = False) -> None:
        """Rebuild the cached views when stale (or ``force``): merge the
        fleet rows with the supervisor's per-replica states, recompute
        base weights, publish the weight gauge, and count reweights."""
        now = self._clock()
        with self._lock:
            if not force and now - self._views_t < self.refresh_s:
                return
            self._views_t = now
        rows = self._pull_rows() or []
        states: Dict[int, str] = {}
        if self.state_fn is not None:
            try:
                for s in self.state_fn():
                    states[int(s["replica"])] = str(s.get("state", ""))
            except Exception:  # noqa: BLE001 - states are advisory
                pass
        views: Dict[int, Dict[str, Any]] = {}
        for row in rows:
            idx = int(row.get("replica", len(views)))
            tiers = row.get("prefix_tier_hit_rate")  # presence signal
            kv = row.get("kv_pages") or {}
            breaches = int(row.get("slo_breaches") or 0)
            prev_b = self._breaches_prev.get(idx, breaches)
            self._breaches_prev[idx] = breaches
            views[idx] = {
                "replica": idx,
                "health": str(row.get("health", "unknown")),
                "state": states.get(idx, "healthy"),
                "role": str(row.get("role") or "mixed"),
                "queue_depth": int(row.get("queue_depth", 0)),
                "active_slots": int(row.get("active_slots", 0)),
                "num_slots": max(1, int(row.get("num_slots", 1))),
                "decode_tokens_per_sec": float(
                    row.get("decode_tokens_per_sec", 0.0)
                ),
                # Effective cache: resident prefix bytes across ALL
                # tiers (device + host + disk) — a replica's capacity to
                # hold warm prefixes, the affinity tiebreaker.
                "prefix_bytes": int(row.get("prefix_bytes") or 0),
                "has_tiers": bool(tiers),
                "kv_occupancy": (
                    float(kv["occupancy"]) if "occupancy" in kv else None
                ),
                # The quality ledger: goodput
                # (emitted tokens per device-second) and the SLO-breach
                # rate demote replicas that are busy but not DELIVERING
                # — signals raw queue depth cannot see.
                "goodput": float(
                    row.get("goodput_tokens_per_device_s") or 0.0
                ),
                "slo_breaches": breaches,
                "slo_breach_delta": max(0, breaches - prev_b),
            }
            # Eviction invalidation: digests this replica dropped from
            # every tier leave the shared directory (idempotent — the
            # report is a ring re-seen across refreshes; only entries
            # pointing at THIS replica are touched).
            dropped = _hex_digests(
                (row.get("kv_dropped") or {}).get("recent") or []
            )
            if dropped:
                self.directory.forget_digests(dropped, replica=idx)
            # Persistent-store feeds: recent write-throughs open
            # store-held routes (a chain that died locally is still
            # fetchable from the store), recent GC drops close them.
            # Both rings are idempotent to re-read, like kv_dropped.
            kvs = row.get("kvstore") or {}
            if isinstance(kvs, dict):
                written = _hex_digests(kvs.get("recent_writes") or [])
                if written:
                    self.directory.observe_store(written)
                gone = _hex_digests(kvs.get("recent_dropped") or [])
                if gone:
                    self.directory.forget_store_digests(gone)
        with self._lock:
            self._views = views
            prev = self._routable_prev
            cur = {
                idx: self._base_weight(v) > 0.0
                for idx, v in views.items()
            }
            for idx, ok in cur.items():
                was = prev.get(idx)
                if was is not None and was != ok:
                    self._m_rebalances.inc(
                        1, reason="restored" if ok else "excluded"
                    )
                    self._event(
                        "router_reweight", replica=idx,
                        routable=ok, state=views[idx]["state"],
                        health=views[idx]["health"],
                    )
                self._m_weight.set(
                    round(self._base_weight(views[idx]), 4), replica=idx
                )
            self._routable_prev = cur

    @staticmethod
    def _base_weight(view: Dict[str, Any]) -> float:
        """Health x load weight, before per-request affinity. 0 means
        excluded (state or verdict says no new traffic)."""
        if view.get("state") in NO_TRAFFIC_STATES:
            return 0.0
        w = _VERDICT_WEIGHT.get(view.get("health", "unknown"), 0.9)
        if w <= 0.0:
            return 0.0
        load = (
            view.get("queue_depth", 0) + view.get("active_slots", 0)
        ) / max(1, view.get("num_slots", 1))
        w /= 1.0 + load
        occ = view.get("kv_occupancy")
        if occ is not None and occ > 0.9:
            # Nearly out of KV pages: admission there would park behind
            # page backpressure — steer elsewhere while any headroom
            # exists.
            w *= 0.25
        if view.get("slo_breach_delta", 0) > 0:
            # Actively breaching its SLOs since the last refresh: the
            # goodput ledger's quality signal — the replica still
            # serves, but new work goes to peers first.
            w *= 0.5
        return w

    def views(self) -> Dict[int, Dict[str, Any]]:
        self.refresh()
        with self._lock:
            return {i: dict(v) for i, v in self._views.items()}

    # -- affinity (backed by the shared fleet KV directory) ----------------
    def _digests(self, prompt: Sequence[int]) -> List[bytes]:
        """The prompt's chained block digests through the incremental
        cache (affinity off -> empty: nothing consumes them)."""
        if not self.affinity:
            return []
        return self.digest_cache.digests(prompt)

    def observe_route(
        self,
        prompt: Sequence[int],
        idx: int,
        digests: Optional[List[bytes]] = None,
    ) -> None:
        """A request landed on ``idx``: its prefix chain is warm there
        now — remember it in the shared directory (bounded LRU).
        ``digests`` threads the chain the plan already computed; absent
        (a caller without a plan), it is computed here once."""
        if not self.affinity:
            return
        if digests is None:
            digests = self._digests(prompt)
        if digests:
            self.directory.observe(digests, int(idx))

    def forget_replica(self, idx: int) -> None:
        """A replica died/retired: its warm pages are gone — drop its
        directory entries so shared-prefix traffic (and fetch hints)
        re-learn instead of chasing a ghost."""
        self.directory.forget_replica(int(idx))

    def _affinity_blocks(
        self, prompt: Sequence[int]
    ) -> Dict[int, int]:
        """Matched WHOLE-CHAIN prefix blocks per replica: the directory
        walk stops at the first block whose digest is unknown or lands
        elsewhere — only an unbroken chain is a warm prefix."""
        if not self.affinity:
            return {}
        run_idx, run = self.directory.chain(self._digests(prompt))
        return {run_idx: run} if run_idx is not None and run else {}

    def affinity_entries(self) -> int:
        return len(self.directory)

    # -- the decision ------------------------------------------------------
    def _retry_after(
        self, views: List[Dict[str, Any]], max_new_tokens: int
    ) -> float:
        """Retry-after hint: the least-loaded replica's estimated time
        to drain one queue slot at its windowed decode rate, floored by
        the configured minimum and capped at 30s."""
        best = None
        for v in views:
            rate = v.get("decode_tokens_per_sec") or 0.0
            if rate <= 0:
                continue
            est = (
                max(1, v.get("queue_depth", 0))
                * max(1, max_new_tokens) / rate
            )
            best = est if best is None else min(best, est)
        if best is None:
            best = self.retry_after_s
        return round(min(30.0, max(self.retry_after_s, best)), 3)

    def _score(
        self,
        prompt: Sequence[int],
        views: Dict[int, Dict[str, Any]],
        cand: Sequence[int],
        aff: Dict[int, int],
    ) -> List[Any]:
        """Score candidates (health x load x affinity): ``(weight, idx,
        view, by_affinity)`` rows, unsorted; excluded replicas absent."""
        scored: List[Any] = []
        max_bytes = max(
            (views.get(i, {}).get("prefix_bytes", 0) for i in cand),
            default=0,
        )
        n_tok = max(1, len(prompt))
        for i in cand:
            view = views.get(i) or _default_view(i)
            w = self._base_weight(view)
            if w <= 0.0:
                continue
            frac = aff.get(i, 0) * self.prefix_block / n_tok
            if frac:
                # Affinity bonus, scaled by the replica's effective
                # cache (a replica with tiers holding 10x the bytes is
                # likelier to still hold an old chain).
                cache_scale = 1.0
                if max_bytes > 0:
                    cache_scale = 0.5 + 0.5 * (
                        view.get("prefix_bytes", 0) / max_bytes
                    )
                w *= 1.0 + self.affinity_bias * frac * cache_scale
            scored.append((w, i, view, frac > 0))
        return scored

    @staticmethod
    def _top(scored: List[Any], rr: int) -> Any:
        """Best-scored row with round-robin tie spread (equal-score
        candidates — fresh fleet, no load, no affinity — rotate instead
        of hammering the lowest index)."""
        scored.sort(key=lambda s: (-s[0], s[1]))
        top_w = scored[0][0]
        ties = [s for s in scored if s[0] >= top_w * 0.999]
        return ties[rr % len(ties)]

    def _admission_check(
        self,
        view: Dict[str, Any],
        pool_views: List[Dict[str, Any]],
        max_new_tokens: int,
        priority: int,
        deadline_s: Optional[float],
    ) -> None:
        """Front-door admission control against the DECODING target's
        view (raises RequestRejectedError): an infeasible deadline
        rejects regardless of load; a saturated pool sheds
        lowest-priority / queue-infeasible work."""
        rate = view.get("decode_tokens_per_sec") or 0.0
        if deadline_s is not None and rate > 0:
            own_s = max_new_tokens / rate
            if own_s > deadline_s:
                # Infeasible even with an empty queue: the decode alone
                # cannot finish by the deadline at this fleet's measured
                # rate — reject NOW instead of queueing it to expire.
                hint = self._retry_after(pool_views, max_new_tokens)
                self.shed_count += 1
                self._m_shed.inc(1, reason="deadline_infeasible")
                self._event(
                    "router_shed", level="warn",
                    reason="deadline_infeasible",
                    deadline_s=deadline_s,
                    est_decode_s=round(own_s, 4),
                    retry_after_s=hint,
                )
                raise RequestRejectedError(
                    "deadline_infeasible", hint,
                    f"max_new_tokens={max_new_tokens} needs ~{own_s:.3f}s "
                    f"at the windowed decode rate; deadline_s="
                    f"{deadline_s:g}",
                )
        if self.shed:
            saturated = bool(pool_views) and all(
                v.get("queue_depth", 0)
                >= self.shed_queue_factor * v.get("num_slots", 1)
                for v in pool_views
            )
            if saturated:
                infeasible = False
                if deadline_s is not None and rate > 0:
                    # Queue-aware feasibility: everything already queued
                    # ahead (estimated at this request's own length)
                    # plus its own decode must fit the deadline.
                    wait_s = (
                        view.get("queue_depth", 0) * max_new_tokens / rate
                    )
                    infeasible = (
                        wait_s + max_new_tokens / rate > deadline_s
                    )
                if priority > 0 or infeasible:
                    hint = self._retry_after(pool_views, max_new_tokens)
                    self.shed_count += 1
                    self._m_shed.inc(1, reason="saturated")
                    self._event(
                        "router_shed", level="warn", reason="saturated",
                        priority=priority,
                        queue_depth=view.get("queue_depth", 0),
                        retry_after_s=hint,
                    )
                    raise RequestRejectedError(
                        "saturated", hint,
                        "every routable replica's queue is at "
                        f">= {self.shed_queue_factor:g}x its slots",
                    )

    #: A fetch hint must not point at a CORPSE: these states/verdicts
    #: mean the holder's process (and its pages) are gone — the fetch
    #: would only burn the timeout. A draining/preempting/merely-loaded
    #: holder still serves fetches: that is the exact case the fleet
    #: cache exists for (the router steered traffic away from the warm
    #: replica, the pages are alive there).
    _HOLDER_GONE_STATES = frozenset(("dead", "failed", "retired"))

    def _fetch_hint(
        self,
        digests: List[bytes],
        idx: int,
        cand: Sequence[int],
        views: Dict[int, Dict[str, Any]],
        chain: Optional[Any] = None,
    ) -> Optional[Dict[str, Any]]:
        """A warm-peer fetch hint for a request routed to ``idx``: when
        a DIFFERENT live replica holds the prompt's digest chain, the
        target can fetch the pages instead of re-prefilling cold — the
        cross-replica sharing that fires exactly when load/health/role
        steered the request AWAY from its warm replica. With no usable
        live holder, the directory's store-held half gets the last
        word: a ``store: True`` hint sends the target to the
        persistent object store (warm-start after a fleet bounce,
        parked-session restore). ``chain`` threads a ``(holder, run)``
        the plan already walked so the hint never re-walks the
        directory."""
        if not digests:
            return None
        holder, run = (
            chain if chain is not None else self.directory.chain(digests)
        )
        if holder == idx and run:
            return None  # routed to the warm replica: local hit
        usable = holder is not None and run
        if usable:
            view = views.get(holder)
            if view is None:
                if holder not in set(cand):
                    usable = False  # unknown AND unroutable: gone
            elif (
                view.get("state") in self._HOLDER_GONE_STATES
                or view.get("health") in ("unreachable", "retired")
            ):
                usable = False  # its pages died with it
        if usable:
            return {
                "peer": int(holder),
                "digests": [d.hex() for d in digests[:run]],
                "blocks": int(run),
            }
        srun = self.directory.store_chain(digests)
        if srun:
            return {
                "peer": None,
                "store": True,
                "digests": [d.hex() for d in digests[:srun]],
                "blocks": int(srun),
            }
        return None

    def _useful_blocks(self, prompt: Sequence[int]) -> int:
        """Full prompt blocks a warm admission can actually consume —
        the engines cap their walk so the final chunk always runs, so
        an exact-multiple prompt's last block never counts."""
        n = len(prompt) // self.prefix_block
        if n and n * self.prefix_block >= len(prompt):
            n -= 1
        return n

    def plan(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: int = 32,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        alive: Optional[Sequence[int]] = None,
        digests: Optional[List[bytes]] = None,
    ) -> RoutePlan:
        """Route one submit: returns a :class:`RoutePlan` (replica +
        fleet-KV placement hints), or raises
        :class:`RequestRejectedError` (admission control). ``alive`` is
        the client's own exclusion-filtered candidate list — the router
        only ever narrows it, never resurrects an excluded replica.
        ``digests`` threads an already-computed chain (a resubmit, a
        batch); absent, it is computed once through the incremental
        cache and rides out on the plan.

        With role-split replicas in the candidate set (disaggregated
        prefill/decode), the request lands on a PREFILL replica with a
        ``ship_to`` decode target — unless the prompt's chain is
        already warm on a decode-side replica, which then takes it
        directly (no prefill hop for a prefix hit).
        """
        t0 = self._clock()
        self.refresh()
        with self._lock:
            views = dict(self._views)
            rr = self._rr
            self._rr += 1
        try:
            return self._plan_one(
                prompt, views, rr, alive, max_new_tokens, priority,
                deadline_s, digests,
            )
        finally:
            self._note_plans(1, self._clock() - t0)

    def plan_many(
        self,
        prompts: Sequence[Sequence[int]],
        *,
        max_new_tokens: Any = 32,
        priority: Any = 0,
        deadline_s: Any = None,
        alive: Optional[Sequence[int]] = None,
    ) -> List[Any]:
        """Vectorized :meth:`plan`: ONE refresh, ONE view snapshot, and
        ONE lock round-trip cover the whole batch — the per-request
        work left is pure scoring math. Returns a list aligned with
        ``prompts`` where each element is a :class:`RoutePlan` or the
        :class:`RequestRejectedError` admission control raised for that
        request (a shed request never fails its batchmates).
        ``max_new_tokens`` / ``priority`` / ``deadline_s`` may each be
        a scalar (applied to all) or a per-request sequence. Raises
        ``NoReplicasError`` only when there is nothing to route to at
        all."""
        prompts = list(prompts)
        n = len(prompts)
        if not n:
            return []
        t0 = self._clock()
        self.refresh()
        with self._lock:
            views = dict(self._views)
            rr = self._rr
            self._rr += n
        mnt = self._per_request(max_new_tokens, n)
        pri = self._per_request(priority, n)
        dls = self._per_request(deadline_s, n)
        out: List[Any] = []
        for k, prompt in enumerate(prompts):
            try:
                out.append(
                    self._plan_one(
                        prompt, views, rr + k, alive, mnt[k], pri[k],
                        dls[k], None,
                    )
                )
            except RequestRejectedError as exc:
                out.append(exc)
        self._note_plans(n, self._clock() - t0)
        return out

    @staticmethod
    def _per_request(value: Any, n: int) -> List[Any]:
        """Scalar-or-sequence batch knob -> one value per request."""
        if isinstance(value, (list, tuple)):
            if len(value) != n:
                raise ValueError(
                    f"per-request knob has {len(value)} entries for "
                    f"{n} prompts"
                )
            return list(value)
        return [value] * n

    def _note_plans(self, n: int, wall_s: float) -> None:
        """Plan-throughput accounting: one batch of ``n`` decisions
        took ``wall_s`` (the `plan b/µs` signal + the batch-size
        histogram counter)."""
        with self._lock:
            self.plan_batches += 1
            self.plan_requests += n
            self.plan_wall_s += max(0.0, float(wall_s))
        bucket = (
            "1" if n == 1
            else "2-7" if n < 8
            else "8-31" if n < 32
            else "32-127" if n < 128
            else "128+"
        )
        self._m_plan_batch.inc(1, bucket=bucket)

    def _plan_one(
        self,
        prompt: Sequence[int],
        views: Dict[int, Dict[str, Any]],
        rr: int,
        alive: Optional[Sequence[int]],
        max_new_tokens: int,
        priority: int,
        deadline_s: Optional[float],
        digests: Optional[List[bytes]],
    ) -> RoutePlan:
        """One routing decision against an already-snapshotted view set
        — the shared body of :meth:`plan` and :meth:`plan_many`."""
        cand = list(alive) if alive is not None else sorted(views)
        if digests is None:
            digests = self._digests(prompt)
        holder0, run0 = (
            self.directory.chain(digests) if digests else (None, 0)
        )
        aff = {holder0: run0} if holder0 is not None and run0 else {}
        roles = {
            i: str((views.get(i) or {}).get("role") or "mixed")
            for i in cand
        }
        prefill_c = [i for i in cand if roles[i] == "prefill"]
        decode_c = [i for i in cand if roles[i] != "prefill"]
        if prefill_c and decode_c:
            plan = self._plan_disagg(
                prompt, digests, views, rr, cand, prefill_c, decode_c,
                aff, max_new_tokens, priority, deadline_s,
                holder0, run0,
            )
            if plan is not None:
                return plan
        scored = self._score(prompt, views, cand, aff)
        if not scored:
            # Nothing routable by policy: fall back to the client's
            # alive list round-robin — the router must never be LESS
            # available than the dumb picker it replaced (its views can
            # be stale through a recovery; the client's exclusions are
            # the hard filter).
            if not cand:
                from ray_lightning_tpu_torch.serve.client import NoReplicasError

                raise NoReplicasError(
                    "no live replicas to route to (all excluded/lost)"
                )
            idx = cand[rr % len(cand)]
            self._m_routed.inc(1, reason="fallback")
            with self._lock:
                self.routed += 1
            return RoutePlan(
                idx, policy="fallback", digests=digests or None
            )
        weight, idx, view, by_affinity = self._top(scored, rr)
        self._admission_check(
            view, [v for _, _, v, _ in scored],
            max_new_tokens, priority, deadline_s,
        )
        self._m_routed.inc(
            1, reason="affinity" if by_affinity else "weighted"
        )
        with self._lock:
            self.routed += 1
        return RoutePlan(
            idx,
            kv_hint=self._fetch_hint(
                digests, idx, cand, views, (holder0, run0)
            ),
            policy="affinity" if by_affinity else "weighted",
            digests=digests or None,
        )

    def _plan_disagg(
        self,
        prompt: Sequence[int],
        digests: List[bytes],
        views: Dict[int, Dict[str, Any]],
        rr: int,
        cand: Sequence[int],
        prefill_c: Sequence[int],
        decode_c: Sequence[int],
        aff: Dict[int, int],
        max_new_tokens: int,
        priority: int,
        deadline_s: Optional[float],
        holder: Optional[int],
        run: int,
    ) -> Optional[RoutePlan]:
        """The disaggregated decision: prefill lands on the prefill
        pool, the finished pages ship to a decode-pool replica chosen
        here, and admission control judges the DECODE side (that is
        where the tokens come from). A prompt already warm on a
        decode-pool replica skips the prefill hop entirely. Returns
        None to fall back to the single-pool path (e.g. neither pool
        has a routable member — availability beats disaggregation).
        ``(holder, run)`` is the chain walk the caller already did."""
        decode_scored = self._score(prompt, views, decode_c, aff)
        prefill_scored = self._score(prompt, views, prefill_c, {})
        if not decode_scored or not prefill_scored:
            return None
        pool_views = [v for _, _, v, _ in decode_scored]
        # Warm shortcut: the chain's holder is on the decode side and
        # covers every usable block — admission there is a pure alias,
        # no prefill worth offloading.
        useful = self._useful_blocks(prompt)
        if (
            holder is not None
            and useful
            and run >= useful
            and any(i == holder for _, i, _, _ in decode_scored)
        ):
            view = next(
                v for _, i, v, _ in decode_scored if i == holder
            )
            self._admission_check(
                view, pool_views, max_new_tokens, priority, deadline_s,
            )
            self._m_routed.inc(1, reason="warm_direct")
            with self._lock:
                self.routed += 1
            return RoutePlan(
                holder, policy="warm_direct", digests=digests or None
            )
        _, d_idx, d_view, _ = self._top(decode_scored, rr)
        self._admission_check(
            d_view, pool_views, max_new_tokens, priority, deadline_s,
        )
        _, p_idx, _, _ = self._top(prefill_scored, rr)
        self._m_routed.inc(1, reason="disagg")
        with self._lock:
            self.routed += 1
        return RoutePlan(
            p_idx,
            ship_to=d_idx,
            kv_hint=self._fetch_hint(
                digests, p_idx, cand, views, (holder, run)
            ),
            policy="disagg",
            digests=digests or None,
        )

    def pick(
        self,
        prompt: Sequence[int],
        *,
        max_new_tokens: int = 32,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        alive: Optional[Sequence[int]] = None,
    ) -> int:
        """Route one submit to a replica index (the pre-fleet-KV
        surface; :meth:`plan` carries the placement hints)."""
        return self.plan(
            prompt,
            max_new_tokens=max_new_tokens,
            priority=priority,
            deadline_s=deadline_s,
            alive=alive,
        ).replica

    # -- read side ---------------------------------------------------------
    def rows(self) -> Dict[str, Any]:
        """The router block of a fleet dashboard:
        one row per known replica (weight, routable, state/health) plus
        the decision totals and the policy knobs."""
        with self._lock:
            views = dict(self._views)
            routed, shed = self.routed, self.shed_count
            batches = self.plan_batches
            requests = self.plan_requests
            wall_s = self.plan_wall_s
        entries = len(self.directory)
        wall_us = wall_s * 1e6
        shard_sizes = self.directory.shard_sizes()
        return {
            "replicas": [
                {
                    "replica": idx,
                    "weight": round(self._base_weight(v), 4),
                    "routable": self._base_weight(v) > 0.0,
                    "state": v.get("state"),
                    "health": v.get("health"),
                    "role": v.get("role", "mixed"),
                    "queue_depth": v.get("queue_depth", 0),
                }
                for idx, v in sorted(views.items())
            ],
            "routed": routed,
            "shed": shed,
            "affinity_entries": entries,
            # Plan throughput: decisions per µs of planning wall (the
            # `plan b/µs` column) + how batched the calls were.
            "plan": {
                "batches": batches,
                "requests": requests,
                "wall_us": round(wall_us, 1),
                "per_us": round(requests / wall_us, 6) if wall_us else 0.0,
                "mean_batch": (
                    round(requests / batches, 2) if batches else 0.0
                ),
            },
            "digest_cache": self.digest_cache.stats(),
            # The lock-striped directory's per-shard occupancy
            # (replica-held, store-held) — a skewed stripe means a
            # skewed digest population, not a router bug.
            "directory": {
                "shards": self.directory.shards,
                "entries": entries,
                "store_entries": self.directory.store_entries(),
                "per_shard": [list(t) for t in shard_sizes],
            },
            "config": self.describe(),
        }

    def describe(self) -> Dict[str, Any]:
        """The policy knobs (the journal header's ``router`` section —
        provenance a replayed capture carries)."""
        return {
            "refresh_s": self.refresh_s,
            "affinity": self.affinity,
            "prefix_block": self.prefix_block,
            "affinity_bias": self.affinity_bias,
            "shed": self.shed,
            "shed_queue_factor": self.shed_queue_factor,
            "retry_after_s": self.retry_after_s,
            "directory_shards": self.directory.shards,
        }


ROUTER_HEADER_KEYS = frozenset((
    "refresh_s", "affinity", "prefix_block", "affinity_bias",
    "shed", "shed_queue_factor", "retry_after_s",
    "hedge_after_s", "retry_budget_ratio",
    "autoscale_min", "autoscale_max", "autoscale_interval_s",
    "submit_batch_ms", "directory_shards",
))


def router_config_from_header(
    header: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    """The recorded router/autoscaler knobs from a journal header
    (empty when the capture predates the router or ran without one)."""
    if not header:
        return {}
    section = header.get("router") or {}
    return {k: v for k, v in section.items() if k in ROUTER_HEADER_KEYS}
