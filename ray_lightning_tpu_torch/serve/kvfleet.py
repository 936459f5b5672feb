"""Fleet KV directory (PyTorch port of the directory half of
``ray_lightning_tpu/serve/kvfleet.py``).

:class:`FleetKVDirectory` is the driver-side digest -> replica map that
the router's prefix affinity reads: which replica holds which chained
block digests (the engine's ``_block_digests``), with one invalidation
path for a lost replica and for evicted blocks, plus a store-held half
that only the object store's own reports prune. It is pure host-side
dict work, the same as the reference's.

The transfer plane (``KVFleetPlane``: cross-replica prefix fetches and
disaggregated prefill/decode ships) and ``kvfleet_config_from_header``
are ROADMAP queue 1 item 9; ``start_replicas`` refuses ``kvfleet=True``
and roles other than ``"mixed"`` until then.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import (
    Any,
    Dict,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
)

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
