"""Fleet KV plane (PyTorch port of ``ray_lightning_tpu/serve/kvfleet.py``).

:class:`FleetKVDirectory` is the driver-side digest -> replica map that
the router's prefix affinity reads: which replica holds which chained
block digests (the engine's ``_block_digests``), with one invalidation
path for a lost replica and for evicted blocks, plus a store-held half
that only the object store's own reports prune.

:class:`KVFleetPlane` is the replica side: one inbox this replica drains
on its scheduler loop thread, and every peer's inbox. Through it a
replica fetches a prefix chain from the peer that holds it (a router's
``kv_hint``) or from the KV object store (``serve/kvstore.py``) instead
of prefilling cold, and a prefill-role replica ships each finished
prefill's blocks to its decode replica, whole or one layer per message.
Every failure (a dead peer, a stale directory entry, a refused budget, a
vanished store) degrades to a cold prefill with the same tokens.

Wire messages (``(kind, body)`` tuples on the inboxes): ``fetch``
``{"src", "req", "digests"}``; ``blocks`` ``{"req", "blocks",
"missing"}``, the reply; ``ship`` ``{"src", "request_id", "blocks"}``;
``ship_layer`` ``{..., "layer", "n_layers"}``. Blocks cross in the wire
form of :func:`to_wire`: raw bytes, dtype names and shapes, never a
tensor, since the fabric's queue pickles each message through a
``multiprocessing.Manager`` proxy.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import (
    Any,
    Callable,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

from ray_lightning_tpu_torch.obs import trace as _trace

#: Replica roles. ``mixed`` (default) prefills and decodes; ``prefill``
#: ships every finished prefill's pages to a decode replica; ``decode``
#: only means the router doesn't hand it raw long-prompt placements —
#: the engine itself is identical (it still chunk-prefills the suffix
#: past the shipped blocks).
ROLES = ("mixed", "prefill", "decode")


def blocks_nbytes(blocks: Sequence[Tuple[str, Any, Any]]) -> int:
    """Payload bytes of one export wire form (``[(digest_hex, kp, vp),
    ...]``): whole np blocks single-device, per-shard dicts under a
    mesh — the unit the in-flight/bandwidth budgets meter."""
    total = 0
    for _, kp, vp in blocks:
        for payload in (kp, vp):
            if isinstance(payload, dict):
                total += sum(int(a.nbytes) for a in payload.values())
            elif payload is not None:
                total += int(payload.nbytes)
    return total


def to_wire(blocks: Sequence[Tuple[str, Any, Any]]) -> List[Any]:
    """An export wire form (``[(digest_hex, k, v), ...]``, CPU tensors)
    as the builtin-only form a fabric queue carries: each payload becomes
    ``("array", dtype, shape, raw bytes)`` (``serve/kvstore.py``'s
    entry payload). A message never carries a tensor: no CUDA tensor can
    cross, and torch's shared-memory reductions (file descriptors a
    Manager proxy does not carry) never run."""
    from ray_lightning_tpu_torch.serve.kvstore import pack_payload

    return [(str(h), pack_payload(k), pack_payload(v)) for h, k, v in blocks]


def from_wire(blocks: Sequence[Any]) -> List[Tuple[str, Any, Any]]:
    """:func:`to_wire`'s form back to CPU tensors."""
    from ray_lightning_tpu_torch.serve.kvstore import unpack_payload

    return [
        (str(h), unpack_payload(k), unpack_payload(v)) for h, k, v in blocks
    ]


class _DirectoryShard:
    """One lock stripe of the directory: its own lock, its own
    replica-held LRU, its own store-held LRU. Digests hash to a shard,
    so two threads touching different shards never contend."""

    __slots__ = ("lock", "map", "store")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        #: digest -> replica index (bounded LRU, newest at the end).
        self.map: "OrderedDict[bytes, int]" = OrderedDict()
        #: store-held digests (bounded LRU set, newest at the end) —
        #: deliberately a SEPARATE structure so replica invalidation
        #: can never touch it.
        self.store: "OrderedDict[bytes, None]" = OrderedDict()


class FleetKVDirectory:
    """Driver-side digest→replica directory: which replica holds which
    chained block digests — ONE store serving both the router's
    prefix-affinity policy and the fleet KV plane's fetch hints (they
    were two copies of the same state before this PR, with two
    invalidation gaps between them).

    Bounded LRU over digests. ``observe`` records a placement (a routed
    submit, a ship, an import); ``chain`` walks a prompt's digests to
    the longest UNBROKEN run on one replica (a later block without its
    ancestors can never be matched engine-side, so a broken chain is
    worthless). Invalidation is one path for every cause: replica
    loss/retire (:meth:`forget_replica`) and block eviction
    (:meth:`forget_digests` — fed from the engines' dropped-digest
    stats rows by the router's refresh, and from explicit fetch-miss
    responses). Thread-safe; pure host-side dict work.

    Entries split in two by what holds the pages: REPLICA-HELD (digest
    -> replica index — dies with the replica, pruned by
    :meth:`forget_replica` / :meth:`forget_digests`) and STORE-HELD
    (digest present in the persistent object store — outlives every
    replica, so a full fleet bounce keeps the route; pruned only by the
    store's own eviction/corruption reports through
    :meth:`forget_store_digests`). A single map would conflate the
    two, so retiring the last holder also erased chains the store still
    served.

    LOCK STRIPING: one global lock serialized every ``observe`` /
    ``chain`` / ``forget_*`` under concurrent router refresh + submit
    traffic — at batched-submit rates the directory became the
    control plane's hottest lock. The maps now split across ``shards``
    stripes (digest bytes pick the stripe; chained blake2 digests are
    uniformly random, so the split is even), each with its own lock
    and its own per-shard LRU bound of ``ceil(capacity / shards)``.
    Both halves of one digest's state live on the SAME stripe, so the
    replica-half vs store-half separation is per-shard and every
    single-digest operation stays atomic. ``shards=1`` (the default)
    is bit-for-bit the old single-lock behavior.
    """

    def __init__(self, capacity: int = 65536, shards: int = 1) -> None:
        self.capacity = max(16, int(capacity))
        self.shards = max(1, int(shards))
        #: Per-shard LRU bound: ceil so shards * bound >= capacity (the
        #: directory never remembers LESS for being striped) — but only
        #: the ceil rounding, so ``capacity`` still bounds the total.
        self.shard_capacity = max(
            1, -(-self.capacity // self.shards)
        )
        self._stripes = [_DirectoryShard() for _ in range(self.shards)]

    def _stripe(self, digest: bytes) -> _DirectoryShard:
        if self.shards == 1:
            return self._stripes[0]
        # Chained blake2 digests are uniformly random bytes: two bytes
        # of the digest spread evenly over any practical shard count.
        return self._stripes[
            int.from_bytes(digest[:2], "little") % self.shards
        ]

    def _group(
        self, digests: Sequence[bytes]
    ) -> Dict[_DirectoryShard, List[bytes]]:
        """Digests grouped by owning stripe, order preserved within
        each group — one lock acquisition per touched stripe."""
        groups: Dict[_DirectoryShard, List[bytes]] = {}
        for d in digests:
            groups.setdefault(self._stripe(d), []).append(d)
        return groups

    def __len__(self) -> int:
        total = 0
        for s in self._stripes:
            with s.lock:
                total += len(s.map)
        return total

    def observe(self, digests: Sequence[bytes], replica: int) -> None:
        """The chain is warm on ``replica`` now (routed there, shipped
        there, or imported there) — remember it."""
        if not digests:
            return
        idx = int(replica)
        for shard, ds in self._group(digests).items():
            with shard.lock:
                for d in ds:
                    shard.map[d] = idx
                    shard.map.move_to_end(d)
                while len(shard.map) > self.shard_capacity:
                    shard.map.popitem(last=False)

    def holder(self, digest: bytes) -> Optional[int]:
        shard = self._stripe(digest)
        with shard.lock:
            return shard.map.get(digest)

    def chain(
        self, digests: Sequence[bytes]
    ) -> Tuple[Optional[int], int]:
        """Longest unbroken leading run on ONE replica: ``(replica,
        blocks)``; ``(None, 0)`` when even the first block is unknown.
        The walk stops at the first unknown digest or the first digest
        living elsewhere — only an unbroken chain is a warm prefix."""
        run_idx: Optional[int] = None
        run = 0
        for d in digests:
            shard = self._stripe(d)
            with shard.lock:
                i = shard.map.get(d)
            if i is None or (run_idx is not None and i != run_idx):
                break
            run_idx = i
            run += 1
        return run_idx, run

    def forget_replica(self, idx: int) -> int:
        """A replica died/retired: its warm pages are gone — drop every
        entry pointing at it so traffic re-learns instead of chasing a
        ghost. Returns entries dropped. Touches ONLY the replica half
        of every stripe — never the store half."""
        idx = int(idx)
        n = 0
        for shard in self._stripes:
            with shard.lock:
                stale = [d for d, i in shard.map.items() if i == idx]
                for d in stale:
                    del shard.map[d]
            n += len(stale)
        return n

    def forget_digests(
        self, digests: Iterable[bytes], replica: Optional[int] = None
    ) -> int:
        """Blocks were EVICTED (engine dropped-digest reports, or an
        explicit fetch-miss): drop their entries — only the ones
        pointing at ``replica`` when given, so replica 2 dropping a
        digest cannot erase replica 0's live copy. Idempotent (the
        reports are rings, re-seen across refreshes). Returns entries
        dropped."""
        n = 0
        rep = None if replica is None else int(replica)
        for shard, ds in self._group(list(digests)).items():
            with shard.lock:
                for d in ds:
                    i = shard.map.get(d)
                    if i is None:
                        continue
                    if rep is not None and i != rep:
                        continue
                    del shard.map[d]
                    n += 1
        return n

    # -- the store-held half ----------------------------------------------
    def observe_store(self, digests: Sequence[bytes]) -> None:
        """The chain is in the persistent store now (a write-through, a
        park, or the warm-start manifest seed) — remember a route that
        survives every replica."""
        if not digests:
            return
        for shard, ds in self._group(digests).items():
            with shard.lock:
                for d in ds:
                    shard.store[d] = None
                    shard.store.move_to_end(d)
                while len(shard.store) > self.shard_capacity:
                    shard.store.popitem(last=False)

    def store_holds(self, digest: bytes) -> bool:
        shard = self._stripe(digest)
        with shard.lock:
            return digest in shard.store

    def store_chain(self, digests: Sequence[bytes]) -> int:
        """Longest unbroken LEADING run the store holds — the fetch
        hint of last resort when :meth:`chain` finds no live replica."""
        run = 0
        for d in digests:
            shard = self._stripe(d)
            with shard.lock:
                held = d in shard.store
            if not held:
                break
            run += 1
        return run

    def forget_store_digests(self, digests: Iterable[bytes]) -> int:
        """The store EVICTED these (budget GC or corruption, reported
        through its dropped ring): the persistent route is gone.
        Idempotent, like :meth:`forget_digests`. The ONLY path that
        prunes store-held entries — ``forget_replica`` never does."""
        n = 0
        for shard, ds in self._group(list(digests)).items():
            with shard.lock:
                for d in ds:
                    if d in shard.store:
                        del shard.store[d]
                        n += 1
        return n

    def store_entries(self) -> int:
        total = 0
        for s in self._stripes:
            with s.lock:
                total += len(s.store)
        return total

    def shard_sizes(self) -> List[Tuple[int, int]]:
        """Per-shard ``(replica_entries, store_entries)`` — the
        lock-striping read side the router's rows/stats surface."""
        out: List[Tuple[int, int]] = []
        for s in self._stripes:
            with s.lock:
                out.append((len(s.map), len(s.store)))
        return out


class KVFleetPlane:
    """Replica-side half of the fleet KV plane: one inbox queue this
    replica drains on its scheduler loop thread, plus every peer's
    inbox handle for sends.

    The scheduler drives everything through :meth:`service` (applies
    inbound ships/fetch-responses, answers inbound fetch requests,
    expires timed-out fetches) and :meth:`request_fetch` /
    :meth:`ship`. Budgets: ``max_inflight_mb`` bounds the bytes of
    fetches in flight (estimated at ``block_bytes`` per requested
    digest — refused fetches fall back to cold prefill, never queue);
    ``bandwidth_mbps`` caps transfer payload throughput over a sliding
    window (0 = uncapped); ``timeout_s`` bounds how long a parked
    request waits before re-queueing cold. Queues are duck-typed
    (``put``/``get_nowait``/``empty``): fabric queues in production,
    plain ``queue.Queue`` in the in-process exactness tests.
    """

    def __init__(
        self,
        index: int,
        inbox: Any,
        peers: Optional[Dict[int, Any]] = None,
        role: str = "mixed",
        block_bytes: int = 0,
        timeout_s: float = 5.0,
        max_inflight_mb: float = 64.0,
        bandwidth_mbps: float = 0.0,
        bandwidth_window_s: float = 5.0,
        min_poll_s: float = 0.005,
        registry: Optional[Any] = None,
        events: Optional[Any] = None,
        store: Optional[Any] = None,
        layerwise_ship: bool = False,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if role not in ROLES:
            raise ValueError(
                f"unknown kvfleet role {role!r}; valid roles: {ROLES}"
            )
        self.index = int(index)
        self.role = str(role)
        self.inbox = inbox
        #: Optional :class:`~ray_lightning_tpu_torch.serve.kvstore.
        #: FleetKVStore` — the tier of last resort a store-kind fetch
        #: reads on the loop thread when no live peer holds the chain.
        self.store = store
        self.peers: Dict[int, Any] = dict(peers or {})
        self.block_bytes = max(0, int(block_bytes))
        self.timeout_s = float(timeout_s)
        self.max_inflight_bytes = int(max_inflight_mb * (1 << 20))
        self.bandwidth_bytes_per_s = int(bandwidth_mbps * (1 << 20))
        self.bandwidth_window_s = float(bandwidth_window_s)
        #: Inbox poll throttle: the fabric inbox is a cross-process
        #: queue, so probing it EVERY scheduler step would tax the hot
        #: loop; with no fetch of our own pending, the drain runs at
        #: most once per ``min_poll_s`` (a few ms of added transfer
        #: latency against per-step costs that matter).
        self.min_poll_s = float(min_poll_s)
        self._last_drain = float("-inf")
        self._clock = clock
        self._events = events
        #: Request tracer (obs.trace): the plane records the phase-
        #: boundary marks only IT can see — a shipped KV payload landing
        #: on the decode side before the stream's resubmit arrives.
        #: The owning scheduler shares its tracer in at construction.
        self.tracer: Optional[Any] = None
        #: Fault injector (serve.faults): the ``kvfleet_fetch`` point
        #: fires as a fetched KV payload is about to import — a delay
        #: rule here inflates exactly the ledger's kv_fetch phase (the
        #: bench's attribution demo).
        self.faults: Optional[Any] = None
        self._lock = threading.Lock()
        #: Layer-pipelined disagg shipping: a finished prefill's pages
        #: stream to the decode target one LAYER at a time instead of
        #: as one blob, so the receiver's imports (and its resident
        #: decode compute) overlap the remaining transfer. Falls back
        #: to whole-prompt shipping per call when the payload is mesh-
        #: sharded (shard dicts ship whole-block only).
        self.layerwise_ship = bool(layerwise_ship)
        #: request_id -> {"peer", "digests", "deadline", "est_bytes"}.
        self._pending: Dict[str, Dict[str, Any]] = {}
        #: (src, request_id) -> partial layerwise-ship state on the
        #: RECEIVER: digests staged so far, next expected layer, and a
        #: deadline after which the half-staged blocks are aborted
        #: (sender died mid-stream -> cold prefill, zero lost pages).
        self._ship_parts: Dict[Tuple[int, str], Dict[str, Any]] = {}
        #: (t, bytes) of transfer payloads inside the bandwidth window.
        self._window: deque = deque()
        # Cumulative accounting (the stats block / fleet row face).
        self.fetches = 0
        self.fetch_blocks = 0
        self.fetch_bytes = 0
        self.fetch_timeouts = 0
        self.fetch_stale = 0
        self.fetch_refused = 0
        self.ships = 0
        self.ship_blocks = 0
        self.ship_bytes = 0
        self.layer_ships = 0
        self.layer_ship_messages = 0
        self.ship_partial_drops = 0
        self.served_fetches = 0
        self.imports = 0
        # Persistent-store fetch accounting (store hits/misses/bytes
        # live on the FleetKVStore itself; these count the PLANE's use
        # of it as a fetch source).
        self.store_fetches = 0
        self.store_fetch_blocks = 0
        self.store_fetch_bytes = 0
        self.store_fetch_misses = 0
        self._m = None
        if registry is not None:
            self._m = {
                "fetches": registry.counter(
                    "rlt_serve_kvfleet_fetches_total",
                    "Cross-replica KV fetches issued, by replica role",
                ),
                "fetch_bytes": registry.counter(
                    "rlt_serve_kvfleet_fetch_bytes_total",
                    "Payload bytes of completed cross-replica KV "
                    "fetches, by replica role",
                ),
                "fetch_timeouts": registry.counter(
                    "rlt_serve_kvfleet_fetch_timeouts_total",
                    "KV fetches that timed out or came back stale "
                    "(the request re-queued for cold prefill), by "
                    "replica role",
                ),
                "ships": registry.counter(
                    "rlt_serve_kvfleet_ships_total",
                    "Finished-prefill KV page sets shipped to decode "
                    "replicas, by replica role",
                ),
                "layer_ships": registry.counter(
                    "rlt_serve_kvfleet_layer_ships_total",
                    "Ships streamed per layer (layerwise pipelining), "
                    "by replica role",
                ),
                "layer_ship_messages": registry.counter(
                    "rlt_serve_kvfleet_layer_ship_messages_total",
                    "Per-layer ship messages sent, by replica role",
                ),
                "ship_partial_drops": registry.counter(
                    "rlt_serve_kvfleet_ship_partial_drops_total",
                    "Layerwise ships abandoned mid-stream (staged "
                    "partial aborted; cold prefill), by replica role",
                ),
            }

    # -- internals --------------------------------------------------------
    def _event(self, name: str, level: str = "info", **kv: Any) -> None:
        if self._events is not None:
            try:
                self._events.record("kvfleet", name, level=level, **kv)
            except Exception:  # noqa: BLE001 - forensics never block KV
                pass

    def _mark(self, rid: Any, span: str, **attrs: Any) -> None:
        if self.tracer is not None and rid is not None:
            self.tracer.event(str(rid), span, attrs=attrs or None)

    def _fault(self, point: str) -> None:
        if self.faults is not None:
            self.faults.hit(point)

    def _put(self, peer: int, item: Any) -> bool:
        """Send one message to ``peer``'s inbox; a message that carries
        blocks travels in the wire form (:func:`to_wire`)."""
        q = self.peers.get(int(peer))
        if q is None:
            return False
        kind, body = item
        if "blocks" in body:
            body = dict(body, blocks=to_wire(body["blocks"]))
        try:
            q.put((kind, body))
            return True
        except Exception:  # noqa: BLE001 - a broken peer queue is a
            return False  # failed transfer, not a crashed replica

    def _charge(self, nbytes: int, now: float) -> None:
        self._window.append((now, int(nbytes)))

    def _window_rate(self, now: float) -> float:
        cutoff = now - self.bandwidth_window_s
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()
        if not self._window:
            return 0.0
        return sum(b for _, b in self._window) / self.bandwidth_window_s

    def register_peer(self, idx: int, queue: Any) -> None:
        """A replica joined the fleet (autoscale-up): adopt its inbox."""
        with self._lock:
            self.peers[int(idx)] = queue

    def pending(self) -> bool:
        """Work waiting for the loop thread: inbound messages or fetches
        whose deadlines need checking."""
        with self._lock:
            if self._pending:
                return True
        try:
            return not self.inbox.empty()
        except Exception:  # noqa: BLE001 - a broken inbox has no work
            return False

    def pending_fetches(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- sends ------------------------------------------------------------
    def request_fetch(
        self, request_id: str, peer: int, digests_hex: Sequence[str]
    ) -> bool:
        """Ask ``peer`` for a digest chain on behalf of a parked
        request. False (cold prefill, never a queue) when the peer is
        unknown, a fetch for the id is already pending, or a budget
        refuses: estimated in-flight bytes over ``max_inflight_mb``, or
        the bandwidth window over ``bandwidth_mbps``."""
        peer = int(peer)
        digests_hex = list(digests_hex)
        if not digests_hex or peer == self.index:
            return False
        est = 2 * self.block_bytes * len(digests_hex)
        now = self._clock()
        with self._lock:
            if request_id in self._pending:
                return False
            inflight = sum(
                p["est_bytes"] for p in self._pending.values()
            )
            if (
                self.max_inflight_bytes
                and inflight + est > self.max_inflight_bytes
            ):
                self.fetch_refused += 1
                return False
            if (
                self.bandwidth_bytes_per_s
                and self._window_rate(now) > self.bandwidth_bytes_per_s
            ):
                self.fetch_refused += 1
                return False
            self._pending[request_id] = {
                "peer": peer,
                "digests": digests_hex,
                "deadline": now + self.timeout_s,
                "est_bytes": est,
            }
        ok = self._put(peer, (
            "fetch",
            {"src": self.index, "req": request_id,
             "digests": digests_hex},
        ))
        if not ok:
            with self._lock:
                self._pending.pop(request_id, None)
            return False
        with self._lock:
            self.fetches += 1
        if self._m is not None:
            self._m["fetches"].inc(1, role=self.role)
        self._event(
            "kvfleet_fetch", request_id=request_id, peer=peer,
            blocks=len(digests_hex),
        )
        return True

    def request_store_fetch(
        self, request_id: str, digests_hex: Sequence[str]
    ) -> bool:
        """Park a request on a PERSISTENT-STORE fetch: no live peer
        holds the chain, but the object store does (per the directory's
        store-held half). Same budgets and same park -> import ->
        admit-warm contract as :meth:`request_fetch`; the read itself
        runs inside :meth:`service` on the loop thread (the import is a
        pool write). False = cold prefill, never a queue."""
        digests_hex = list(digests_hex)
        if not digests_hex or self.store is None:
            return False
        est = 2 * self.block_bytes * len(digests_hex)
        now = self._clock()
        with self._lock:
            if request_id in self._pending:
                return False
            inflight = sum(
                p["est_bytes"] for p in self._pending.values()
            )
            if (
                self.max_inflight_bytes
                and inflight + est > self.max_inflight_bytes
            ):
                self.fetch_refused += 1
                return False
            if (
                self.bandwidth_bytes_per_s
                and self._window_rate(now) > self.bandwidth_bytes_per_s
            ):
                self.fetch_refused += 1
                return False
            self._pending[request_id] = {
                "peer": None,
                "store": True,
                "digests": digests_hex,
                "deadline": now + self.timeout_s,
                "est_bytes": est,
            }
            self.store_fetches += 1
        if self._m is not None:
            self._m["fetches"].inc(1, role=self.role)
        self._event(
            "kvstore_fetch", request_id=request_id,
            blocks=len(digests_hex),
        )
        return True

    def ship(
        self,
        target: int,
        request_id: str,
        blocks: Sequence[Any],
        layerwise: Optional[bool] = None,
    ) -> bool:
        """Ship a finished prefill's exported pages to the decode
        replica ``target``. Best-effort: a failed ship only costs the
        decode side a cold prefill (the journal resubmit still runs).

        ``layerwise`` (None = the plane's ``layerwise_ship`` default)
        streams one ``ship_layer`` message per LAYER instead of one
        whole-prompt blob, so the receiver starts importing layer 0
        while the upper layers are still in flight — the transfer hides
        behind the receiver's compute instead of stacking in front of
        its first decode. Mesh-sharded payloads (shard dicts) always
        fall back to the whole-prompt form."""
        blocks = list(blocks)
        use_layers = self.layerwise_ship if layerwise is None else bool(
            layerwise
        )
        if use_layers and blocks and all(
            not isinstance(kp, dict) and not isinstance(vp, dict)
            and getattr(kp, "ndim", 0) >= 1
            for _, kp, vp in blocks
        ):
            return self._ship_layerwise(int(target), request_id, blocks)
        nbytes = blocks_nbytes(blocks)
        ok = self._put(int(target), (
            "ship",
            {"src": self.index, "request_id": request_id,
             "blocks": blocks},
        ))
        if ok:
            now = self._clock()
            with self._lock:
                self.ships += 1
                self.ship_blocks += len(blocks)
                self.ship_bytes += nbytes
                self._charge(nbytes, now)
            if self._m is not None:
                self._m["ships"].inc(1, role=self.role)
            self._event(
                "kvfleet_ship", request_id=request_id, target=int(target),
                blocks=len(blocks), nbytes=nbytes, layerwise=False,
            )
        return ok

    def _ship_layerwise(
        self, target: int, request_id: str, blocks: List[Any]
    ) -> bool:
        """The layer-pipelined send: one message per layer, each
        carrying every block's ``(digest, k_layer, v_layer)`` slice in
        chain order. Aborting on the first failed put leaves the
        receiver with a half-staged set its deadline sweep cleans up —
        never a matchable half-block."""
        n_layers = int(blocks[0][1].shape[0])
        nbytes = blocks_nbytes(blocks)
        for layer in range(n_layers):
            msg_blocks = [
                (hexd, kp[layer:layer + 1], vp[layer:layer + 1])
                for hexd, kp, vp in blocks
            ]
            ok = self._put(target, (
                "ship_layer",
                {"src": self.index, "request_id": request_id,
                 "layer": layer, "n_layers": n_layers,
                 "blocks": msg_blocks},
            ))
            if not ok:
                return False
            with self._lock:
                self.layer_ship_messages += 1
            if self._m is not None:
                self._m["layer_ship_messages"].inc(1, role=self.role)
        now = self._clock()
        with self._lock:
            self.ships += 1
            self.layer_ships += 1
            self.ship_blocks += len(blocks)
            self.ship_bytes += nbytes
            self._charge(nbytes, now)
        if self._m is not None:
            self._m["ships"].inc(1, role=self.role)
            self._m["layer_ships"].inc(1, role=self.role)
        self._event(
            "kvfleet_ship", request_id=request_id, target=target,
            blocks=len(blocks), nbytes=nbytes, layerwise=True,
            layers=n_layers,
        )
        return True

    # -- the loop-thread pump ---------------------------------------------
    def service(
        self,
        export_fn: Optional[Callable[[Sequence[str]], List[Any]]],
        import_fn: Optional[Callable[[Sequence[Any]], int]],
        layer_import_fn: Optional[
            Callable[[str, Any, Any, int, int], bool]
        ] = None,
        abort_fn: Optional[Callable[[Sequence[str]], None]] = None,
    ) -> Dict[str, Any]:
        """Drain the inbox and settle deadlines — MUST run on the
        engine's driving thread (``export_fn``/``import_fn`` execute
        pool reads and writes on the engine's stream):

        - ``fetch`` requests export the asked digests (prefix order,
          stopping at the first miss) and answer with the blocks plus
          the explicit ``missing`` tail — staleness is an answer, not a
          timeout;
        - ``ship`` payloads and fetch responses import immediately
          (blocks land in the pool before this step's admission scan);
        - pending fetches past their deadline expire.

        Returns ``{"fetched": [(request_id, blocks_imported)],
        "failed": [(request_id, reason)], "store_fetched":
        [request_id]}`` for the scheduler to re-queue its parked
        requests (warm or cold respectively); ``store_fetched`` lists
        the subset of ``fetched`` satisfied by the persistent store
        rather than a live peer.
        """
        fetched: List[Tuple[str, int]] = []
        failed: List[Tuple[str, str]] = []
        store_fetched: List[str] = []
        now = self._clock()
        with self._lock:
            have_pending = bool(self._pending)
        if not have_pending and now - self._last_drain < self.min_poll_s:
            return {
                "fetched": fetched, "failed": failed,
                "store_fetched": store_fetched,
            }
        self._last_drain = now
        # Store-kind pendings resolve synchronously here (the read is
        # local I/O; the import is a pool write that must run
        # on this thread) — before the deadline sweep can expire them.
        # A vanished/corrupt store entry is an explicit miss -> cold
        # prefill, never a lost request.
        with self._lock:
            store_rids = [
                rid for rid, p in self._pending.items() if p.get("store")
            ]
        for rid in store_rids:
            with self._lock:
                pend = self._pending.pop(rid, None)
            if pend is None:
                continue
            try:
                blocks, missing = self.store.get_chain(pend["digests"])
            except Exception:  # noqa: BLE001 - a vanished store dir
                blocks, missing = [], list(pend["digests"])  # = miss
            if not blocks:
                with self._lock:
                    self.store_fetch_misses += 1
                if self._m is not None:
                    self._m["fetch_timeouts"].inc(1, role=self.role)
                self._event(
                    "kvstore_fetch_miss", level="warn", request_id=rid,
                    missing=len(missing),
                )
                failed.append((rid, "store_miss"))
                continue
            n = 0
            self._fault("kvfleet_fetch")
            if import_fn is not None:
                n = int(import_fn(blocks))
            nbytes = blocks_nbytes(blocks)
            with self._lock:
                self.store_fetch_blocks += len(blocks)
                self.store_fetch_bytes += nbytes
                self.imports += n
                self._charge(nbytes, now)
            if self._m is not None:
                self._m["fetch_bytes"].inc(nbytes, role=self.role)
            self._event(
                "kvstore_fetch_done", request_id=rid,
                blocks=len(blocks), missing=len(missing),
                nbytes=nbytes,
            )
            fetched.append((rid, n))
            store_fetched.append(rid)
        while True:
            try:
                item = self.inbox.get_nowait()
            except Exception:  # noqa: BLE001 - Empty/broken both mean
                break  # "nothing more to drain"
            if not (isinstance(item, tuple) and len(item) == 2):
                continue
            kind, body = item
            if isinstance(body, dict) and body.get("blocks"):
                body = dict(body, blocks=from_wire(body["blocks"]))
            if kind == "fetch" and export_fn is not None:
                digests = list(body.get("digests") or [])
                blocks = list(export_fn(digests))
                missing = digests[len(blocks):]
                nbytes = blocks_nbytes(blocks)
                with self._lock:
                    self.served_fetches += 1
                    self._charge(nbytes, now)
                self._put(int(body.get("src", -1)), (
                    "blocks",
                    {"req": body.get("req"), "blocks": blocks,
                     "missing": missing},
                ))
            elif kind == "blocks":
                rid = body.get("req")
                with self._lock:
                    pend = self._pending.pop(rid, None)
                if pend is None:
                    continue  # late response past its timeout
                blocks = list(body.get("blocks") or [])
                missing = list(body.get("missing") or [])
                if not blocks:
                    # Directory staleness: the peer no longer holds even
                    # the chain head — cold prefill now, not at timeout.
                    with self._lock:
                        self.fetch_stale += 1
                    if self._m is not None:
                        self._m["fetch_timeouts"].inc(1, role=self.role)
                    self._event(
                        "kvfleet_fetch_stale", level="warn",
                        request_id=rid, peer=pend["peer"],
                        missing=len(missing),
                    )
                    failed.append((rid, "stale"))
                    continue
                n = 0
                self._fault("kvfleet_fetch")
                if import_fn is not None:
                    n = int(import_fn(blocks))
                nbytes = blocks_nbytes(blocks)
                with self._lock:
                    self.fetch_blocks += len(blocks)
                    self.fetch_bytes += nbytes
                    self.imports += n
                    if missing:
                        self.fetch_stale += 1
                    self._charge(nbytes, now)
                if self._m is not None:
                    self._m["fetch_bytes"].inc(nbytes, role=self.role)
                self._event(
                    "kvfleet_fetch_done", request_id=rid,
                    peer=pend["peer"], blocks=len(blocks),
                    missing=len(missing), nbytes=nbytes,
                )
                fetched.append((rid, n))
            elif kind == "ship" and import_fn is not None:
                blocks = list(body.get("blocks") or [])
                n = int(import_fn(blocks))
                with self._lock:
                    self.imports += n
                # Ship-land mark: the decode side's only record of the
                # transit ending — the stream's resubmit has not arrived
                # yet, so no scheduler span can carry this boundary.
                self._mark(
                    body.get("request_id"), _trace.SPAN_KV_SHIP_LAND,
                    src=body.get("src"), blocks=n, layerwise=False,
                )
                self._event(
                    "kvfleet_ship_import",
                    request_id=body.get("request_id"),
                    src=body.get("src"), blocks=n, layerwise=False,
                )
            elif kind == "ship_layer":
                self._apply_ship_layer(
                    body, now, import_fn, layer_import_fn, abort_fn
                )
        # Half-staged layerwise ships whose sender went quiet: abort the
        # pinned staging blocks so the pool slots recycle — the decode
        # side's admission simply cold-prefills what never finished.
        with self._lock:
            dead_parts = [
                (key, self._ship_parts.pop(key)["digests"])
                for key in [
                    k for k, p in self._ship_parts.items()
                    if now >= p["deadline"]
                ]
            ]
            self.ship_partial_drops += len(dead_parts)
        if dead_parts and self._m is not None:
            self._m["ship_partial_drops"].inc(
                len(dead_parts), role=self.role
            )
        for key, digests in dead_parts:
            if abort_fn is not None:
                try:
                    abort_fn(digests)
                except Exception:  # noqa: BLE001 - cleanup best-effort
                    pass
            self._event(
                "kvfleet_ship_partial_drop", level="warn",
                request_id=key[1], src=key[0],
            )
        # Deadlines: a peer that died mid-fetch (or a transfer slower
        # than the window) never answers — the parked request re-queues
        # for cold prefill instead of waiting forever.
        with self._lock:
            expired = [
                rid for rid, p in self._pending.items()
                if now >= p["deadline"]
            ]
            for rid in expired:
                del self._pending[rid]
                self.fetch_timeouts += 1
        for rid in expired:
            if self._m is not None:
                self._m["fetch_timeouts"].inc(1, role=self.role)
            self._event(
                "kvfleet_fetch_timeout", level="warn", request_id=rid,
            )
            failed.append((rid, "timeout"))
        return {
            "fetched": fetched, "failed": failed,
            "store_fetched": store_fetched,
        }

    def _apply_ship_layer(
        self,
        body: Dict[str, Any],
        now: float,
        import_fn: Optional[Callable[[Sequence[Any]], int]],
        layer_import_fn: Optional[
            Callable[[str, Any, Any, int, int], bool]
        ],
        abort_fn: Optional[Callable[[Sequence[str]], None]],
    ) -> None:
        """One inbound ``ship_layer`` message: import every block's
        layer slice IMMEDIATELY (this is the overlap win — layer 0
        lands in the pool while layers 1.. are still in flight). Any
        per-block refusal (no layer path on this engine, pool full,
        out-of-order layer) aborts the whole request's staging — the
        engine-side invariant that a half-shipped block is never
        matchable makes the abort free."""
        src = int(body.get("src", -1))
        rid = str(body.get("request_id"))
        layer = int(body.get("layer", 0))
        n_layers = int(body.get("n_layers", 0))
        blocks = list(body.get("blocks") or [])
        if not blocks or n_layers <= 0:
            return
        key = (src, rid)
        if layer_import_fn is None:
            # This engine cannot stage layers (mesh, no pool): buffer is
            # pointless — just drop; the decode side cold-prefills.
            with self._lock:
                self.ship_partial_drops += 1
                self._ship_parts.pop(key, None)
            if self._m is not None:
                self._m["ship_partial_drops"].inc(1, role=self.role)
            return
        with self._lock:
            part = self._ship_parts.get(key)
            if part is None:
                part = {
                    "digests": [],
                    "next": 0,
                    "deadline": now + self.timeout_s,
                }
                self._ship_parts[key] = part
        digests = [str(h) for h, _, _ in blocks]
        ok = True
        for hexd, kl, vl in blocks:
            if not layer_import_fn(hexd, kl, vl, layer, n_layers):
                ok = False
                break
        with self._lock:
            part["next"] = layer + 1
            part["deadline"] = now + self.timeout_s
            for h in digests:
                if h not in part["digests"]:
                    part["digests"].append(h)
        if not ok:
            with self._lock:
                staged = self._ship_parts.pop(key, None)
                self.ship_partial_drops += 1
            if self._m is not None:
                self._m["ship_partial_drops"].inc(1, role=self.role)
            if abort_fn is not None and staged is not None:
                try:
                    abort_fn(staged["digests"])
                except Exception:  # noqa: BLE001 - cleanup best-effort
                    pass
            self._event(
                "kvfleet_ship_layer_abort", level="warn",
                request_id=rid, src=src, layer=layer,
            )
            return
        nbytes = blocks_nbytes(blocks)
        with self._lock:
            self._charge(nbytes, now)
        self._event(
            "kvfleet_ship_layer", request_id=rid, src=src,
            layer=layer, n_layers=n_layers, blocks=len(blocks),
            nbytes=nbytes,
        )
        if layer + 1 >= n_layers:
            with self._lock:
                self._ship_parts.pop(key, None)
                self.imports += len(blocks)
            self._mark(
                rid, _trace.SPAN_KV_SHIP_LAND,
                src=src, blocks=len(blocks), layerwise=True,
            )
            self._event(
                "kvfleet_ship_import", request_id=rid, src=src,
                blocks=len(blocks), layerwise=True,
            )

    # -- read side ---------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        """The ``kvfleet`` stats block (rides the replica stats
        endpoint into the fleet rows)."""
        with self._lock:
            return {
                "role": self.role,
                "peers": len(self.peers),
                "fetches": self.fetches,
                "fetch_blocks": self.fetch_blocks,
                "fetch_bytes": self.fetch_bytes,
                "fetch_timeouts": self.fetch_timeouts,
                "fetch_stale": self.fetch_stale,
                "fetch_refused": self.fetch_refused,
                "served_fetches": self.served_fetches,
                "ships": self.ships,
                "ship_blocks": self.ship_blocks,
                "ship_bytes": self.ship_bytes,
                "layerwise": self.layerwise_ship,
                "layer_ships": self.layer_ships,
                "layer_ship_messages": self.layer_ship_messages,
                "ship_partial_drops": self.ship_partial_drops,
                "imports": self.imports,
                "store_fetches": self.store_fetches,
                "store_fetch_blocks": self.store_fetch_blocks,
                "store_fetch_bytes": self.store_fetch_bytes,
                "store_fetch_misses": self.store_fetch_misses,
                "pending_fetches": len(self._pending),
                "timeout_s": self.timeout_s,
                "max_inflight_mb": round(
                    self.max_inflight_bytes / (1 << 20), 3
                ),
            }


#: Journal-header ``kvfleet`` keys a replayed capture surfaces — the
#: role/disagg knobs that shaped a recorded session (the single-engine
#: replay has no fleet to ship across; shipped outcomes replay as the
#: recorded truncations, as the preemption drain's migrations do).
KVFLEET_HEADER_KEYS = frozenset((
    "role", "peers", "timeout_s", "max_inflight_mb", "bandwidth_mbps",
    "layerwise",
))


def kvfleet_config_from_header(
    header: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    """The recorded fleet-KV/disagg knobs from a journal header (empty
    when the capture predates the KV plane or ran without one)."""
    if not header:
        return {}
    section = header.get("kvfleet") or {}
    return {
        k: v for k, v in section.items() if k in KVFLEET_HEADER_KEYS
    }
