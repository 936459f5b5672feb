"""KV object store: the fleet-shared persistent tier (PyTorch port of
``ray_lightning_tpu/serve/kvstore.py``).

A content-addressed page store keyed by the engines' chained blake2
digests, under every local tier (device pool -> host RAM -> disk):

- :class:`LocalDirBackend` — one ``<key>.kv`` file per entry under a
  shared directory. Writes are atomic (tmp + ``os.replace``), reads touch
  the mtime so the LRU-by-last-access GC sees real recency, and
  construction prunes torn ``.tmp`` leftovers.
- :class:`S3ObjectBackend` — the same duck interface built from an
  ``s3://`` URL; every data operation raises (interface only, as in the
  reference).
- :class:`FleetKVStore` — the policy both ends share: the engines' tier
  sink and the scheduler's write-through write into it, the fleet KV
  plane reads chains back (``get_chain``, chain order, stopping at the
  first miss), ``budget_mb`` is held LRU on measured file bytes, and
  ``manifest`` seeds a restarted fleet's directory.

An entry is ``MAGIC + blake2b(body) + pickle(body)`` with the body
``{"digest", "k", "v"}``, each payload ``("array", dtype name, shape,
raw bytes)``. The port builds that body from CPU tensors with the same
builtin tuples and the same pickle protocol as the reference builds it
from numpy arrays, so an entry is byte for byte the reference's for the
same digest and block, and a directory written by either package reads
in the other. bfloat16 travels as raw bytes plus the name
``"bfloat16"``; the port views them back with ``torch.frombuffer`` (no
numpy bfloat16 is needed). Damage of any kind (short file, bad magic,
checksum mismatch, an unpicklable body, a foreign namespace's key) reads
as an explicit miss: the entry is deleted and reported through the
dropped ring, never raised and never served.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pickle
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

#: Envelope magic: bumping it invalidates (prunes) every older entry
#: instead of mis-parsing it.
_MAGIC = b"RLTKVS1\n"
_CHECK_BYTES = 16
#: One store entry per digest: ``<digest-hex>.kv`` under the root.
_SUFFIX = ".kv"


def _checksum(body: bytes) -> bytes:
    return hashlib.blake2b(body, digest_size=_CHECK_BYTES).digest()


def kvstore_namespace(ckpt_path: Optional[str], config: Any) -> str:
    """The store namespace of one model identity: a short digest over
    the checkpoint path and the full model config. Two engines share
    store entries iff this matches — the chained token digests alone
    say nothing about WHICH model produced the KV bytes, so one shared
    store serving two model versions would silently hand out wrong
    pages without this fence. Pure function of its inputs: every gang
    member and every restart derives the same namespace."""
    cfg = (
        dataclasses.asdict(config)
        if dataclasses.is_dataclass(config)
        else dict(config or {})
    )
    blob = json.dumps(
        {"ckpt": str(ckpt_path or ""), "cfg": cfg},
        sort_keys=True,
        default=str,
    ).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


#: The one bfloat16 name object. The reference's numpy bfloat16 dtype
#: hands out one cached name string, so pickle writes its second use in
#: an entry as a memo reference; numpy's own dtypes build a fresh string
#: per call, which pickle writes out again. :func:`_dtype_name` follows
#: both, so the pickled body is byte for byte the reference's.
_BF16 = "bfloat16"


def _dtype_name(dtype: torch.dtype) -> str:
    name = str(dtype).replace("torch.", "")
    if name == _BF16:
        return _BF16
    return str(np.dtype(name))


def _raw(arr: Any) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, raw bytes) of one array: a CPU tensor (the
    port's host block) or a numpy array, in the reference's byte order."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return _dtype_name(t.dtype), list(t.shape), raw
    a = np.ascontiguousarray(arr)
    return str(a.dtype), list(a.shape), a.tobytes()


def _tensor(dstr: str, shape: Sequence[int], raw: bytes) -> torch.Tensor:
    """Raw bytes back to a CPU tensor of dtype ``dstr`` (a torch dtype
    name: ``float32``, ``bfloat16``, ...)."""
    dtype = getattr(torch, str(dstr), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown payload dtype {dstr!r}")
    buf = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    return buf.view(dtype).reshape([int(n) for n in shape])


def pack_payload(payload: Any) -> Any:
    """One block payload (a CPU tensor or array, or a ``{shard_index:
    array}`` dict as a mesh engine of the reference spills) -> the
    builtin-only form: ``("array", dtype, shape, raw)`` or ``("shards",
    [(index, dtype, shape, raw), ...])``. None stays None."""
    if payload is None:
        return None
    if isinstance(payload, dict):
        shards = []
        for key in sorted(payload):
            dstr, shape, raw = _raw(payload[key])
            shards.append((
                [[int(a), int(b)] for a, b in key], dstr, shape, raw,
            ))
        return ("shards", shards)
    dstr, shape, raw = _raw(payload)
    return ("array", dstr, shape, raw)


def unpack_payload(packed: Any) -> Any:
    """:func:`pack_payload`'s form back to CPU tensors."""
    if packed is None:
        return None
    if packed[0] == "shards":
        return {
            tuple((int(a), int(b)) for a, b in key): _tensor(d, s, raw)
            for key, d, s, raw in packed[1]
        }
    _, dstr, shape, raw = packed
    return _tensor(dstr, shape, raw)


def encode_entry(digest_hex: str, kp: Any, vp: Any) -> bytes:
    """One block -> the checksummed envelope the backends store."""
    body = pickle.dumps(
        {
            "digest": str(digest_hex),
            "k": pack_payload(kp),
            "v": pack_payload(vp),
        },
        protocol=pickle.HIGHEST_PROTOCOL,
    )
    return _MAGIC + _checksum(body) + body


def decode_entry(data: bytes) -> Optional[Tuple[str, Any, Any]]:
    """The envelope back to ``(digest_hex, k, v)`` (CPU tensors); None on ANY
    damage (short file, bad magic, checksum mismatch, unpicklable body)
    — corruption is a miss, never an exception on the fetch path."""
    try:
        if not data.startswith(_MAGIC):
            return None
        check = data[len(_MAGIC):len(_MAGIC) + _CHECK_BYTES]
        body = data[len(_MAGIC) + _CHECK_BYTES:]
        if len(check) != _CHECK_BYTES or _checksum(body) != check:
            return None
        rec = pickle.loads(body)
        return (
            str(rec["digest"]),
            unpack_payload(rec["k"]),
            unpack_payload(rec["v"]),
        )
    except Exception:  # noqa: BLE001 - damage of any shape is a miss
        return None


class LocalDirBackend:
    """Shared-directory object backend: one ``<digest-hex>.kv`` file per
    entry. Multiple processes (every replica + the driver) open the
    same root; the directory of files IS the shared truth — no index
    file to corrupt, content-addressing makes concurrent writers
    idempotent, and ``os.replace`` makes each entry appear atomically
    or not at all."""

    name = "local-dir"

    def __init__(self, root: str) -> None:
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self.prune_partials()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + _SUFFIX)

    def prune_partials(self) -> int:
        """Remove torn ``.tmp`` leftovers from a writer that died
        mid-put (its ``os.replace`` never ran, so no entry exists)."""
        n = 0
        try:
            names = os.listdir(self.root)
        except OSError:
            return 0
        for name in names:
            if name.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.root, name))
                    n += 1
                except OSError:
                    pass
        return n

    def put(self, key: str, data: bytes) -> int:
        """Atomic write; returns bytes written. Raises OSError on a
        full/vanished volume — the store layer counts it loudly."""
        path = self._path(key)
        tmp = path + f".{os.getpid()}.tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return len(data)

    def get(self, key: str) -> Optional[bytes]:
        """Entry bytes, or None when absent/unreadable. A read touches
        mtime so LRU-by-last-access sees real recency."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
            try:
                os.utime(path)
            except OSError:
                pass
            return data
        except OSError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except OSError:
            pass

    def entries(self) -> List[Tuple[str, int, float]]:
        """``(key, nbytes, last_access)`` per live entry — MEASURED
        file sizes straight from the directory (the budget's truth even
        with other processes writing)."""
        out: List[Tuple[str, int, float]] = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.endswith(_SUFFIX):
                continue
            try:
                st = os.stat(os.path.join(self.root, name))
            except OSError:
                continue  # deleted under us: fine, it's gone
            out.append((name[: -len(_SUFFIX)], int(st.st_size), st.st_mtime))
        return out


class S3ObjectBackend:
    """S3-shaped stub behind the same duck interface. Constructible
    from an ``s3://bucket/prefix`` URL so config plumbing, journal
    headers, and tests can carry the scheme today; every data operation
    raises until a real client lands (the container ships no boto —
    nothing to silently half-work)."""

    name = "s3"

    def __init__(self, url: str) -> None:
        self.url = str(url)
        rest = self.url[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise ValueError(f"S3 kvstore URL {url!r} names no bucket")
        self.bucket = bucket
        self.prefix = prefix.strip("/")

    def _unavailable(self) -> "NotImplementedError":
        return NotImplementedError(
            "S3 kvstore backend is interface-only in this build: "
            f"{self.url!r} parsed, but no S3 client is baked into the "
            "container — use a shared local-dir path (NFS/persistent "
            "volume) for a durable store today"
        )

    def prune_partials(self) -> int:
        return 0  # multipart uploads never surface as torn objects

    def put(self, key: str, data: bytes) -> int:  # noqa: ARG002
        raise self._unavailable()

    def get(self, key: str) -> Optional[bytes]:  # noqa: ARG002
        raise self._unavailable()

    def delete(self, key: str) -> None:  # noqa: ARG002
        raise self._unavailable()

    def entries(self) -> List[Tuple[str, int, float]]:
        raise self._unavailable()


def open_backend(path: str) -> Any:
    """Dispatch a ``kvstore_dir`` value to its backend: ``s3://`` URLs
    to the S3-shaped stub, everything else to the local-dir backend."""
    if str(path).startswith("s3://"):
        return S3ObjectBackend(path)
    return LocalDirBackend(path)


class FleetKVStore:
    """The persistent KV tier both ends of the fleet share: engines and
    retiring replicas WRITE dying/finished pages through, the fleet
    plane READS chains back on an admission miss with no live holder,
    and a restarting fleet pre-seeds its directory from the manifest.

    Thread-safe; every backend failure degrades to a counted miss or a
    counted write error — a vanished store directory costs cold
    prefills, never requests. ``budget_mb`` (0 = unbounded) is enforced
    LRU-by-last-access on measured file bytes, at construction (the
    prune pass) and after every write.
    """

    def __init__(
        self,
        path: str,
        budget_mb: float = 0.0,
        registry: Optional[Any] = None,
        events: Optional[Any] = None,
        namespace: Optional[str] = None,
    ) -> None:
        self.path = str(path)
        #: Model-identity fence (see :func:`kvstore_namespace`): entry
        #: keys become ``<namespace>.<digest-hex>`` and the manifest
        #: only surfaces THIS namespace, so one shared directory can
        #: hold many model versions without ever cross-serving pages.
        #: Empty = legacy single-model layout (bare digest keys).
        self.namespace = str(namespace) if namespace else ""
        self.budget_bytes = int(float(budget_mb) * (1 << 20))
        self.backend = open_backend(path)
        self._lock = threading.Lock()
        self._events = events
        # Cumulative accounting (the kvstore stats block).
        self.hits = 0
        self.misses = 0
        self.writes = 0
        self.write_errors = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.evictions = 0
        self.corrupt = 0
        #: Bounded rings the router's refresh feeds into the directory's
        #: store-held half — NOT drained on read (idempotent observe/
        #: forget make re-reporting across scrapes safe, exactly like
        #: the engines' dropped-digest ring).
        self._recent_writes: "deque[str]" = deque(maxlen=256)
        self._recent_dropped: "deque[str]" = deque(maxlen=256)
        self._m = None
        if registry is not None:
            self._m = {
                "hits": registry.counter(
                    "rlt_serve_kvstore_hits_total",
                    "KV store chain lookups that returned blocks",
                ),
                "misses": registry.counter(
                    "rlt_serve_kvstore_misses_total",
                    "KV store lookups that found nothing (including "
                    "corrupt entries, counted as explicit misses)",
                ),
                "writes": registry.counter(
                    "rlt_serve_kvstore_writes_total",
                    "KV blocks written through to the store",
                ),
                "write_errors": registry.counter(
                    "rlt_serve_kvstore_write_errors_total",
                    "KV store writes that failed (pages lost loudly)",
                ),
                "bytes": registry.counter(
                    "rlt_serve_kvstore_bytes_total",
                    "Payload bytes moved through the store, by "
                    "direction",
                ),
                "evictions": registry.counter(
                    "rlt_serve_kvstore_evictions_total",
                    "Store entries evicted by the kvstore_mb budget "
                    "or deleted as corrupt",
                ),
            }
        # Constructor GC: enforce the budget over whatever survived the
        # previous fleet (and count what it costs) before serving.
        try:
            self.gc()
        except NotImplementedError:
            pass  # the S3 stub: nothing to prune until a client lands

    # -- internals --------------------------------------------------------
    def _key(self, digest_hex: str) -> str:
        """The backend key of one bare digest under this namespace."""
        d = str(digest_hex)
        return f"{self.namespace}.{d}" if self.namespace else d

    def _event(self, name: str, level: str = "info", **kv: Any) -> None:
        if self._events is not None:
            try:
                self._events.record("kvstore", name, level=level, **kv)
            except Exception:  # noqa: BLE001 - forensics never block KV
                pass

    def _drop(self, key: str, reason: str) -> None:
        """Delete one entry and report it through the dropped ring so
        the directory's store-held half forgets the route."""
        try:
            self.backend.delete(key)
        except Exception:  # noqa: BLE001 - already-gone is the goal
            pass
        with self._lock:
            self.evictions += 1
            if reason == "corrupt":
                self.corrupt += 1
            self._recent_dropped.append(key)
        if self._m is not None:
            self._m["evictions"].inc(1)
        self._event("kvstore_drop", level="warn", digest=key, reason=reason)

    # -- sink (write-through) ---------------------------------------------
    def put_block(self, digest_hex: str, kp: Any, vp: Any) -> bool:
        """Write one block through; False (counted, evented, never
        raised) when the backend fails — the page is lost LOUDLY via
        ``rlt_serve_kvstore_write_errors_total``, and the caller's own
        path (eviction, retire, park) still completes."""
        key = self._key(digest_hex)
        try:
            # The envelope embeds the FULL namespaced key: a legacy (or
            # foreign-namespace) entry renamed/copied under this key
            # fails the round-trip identity check in get_chain and
            # decodes as an explicit miss, never as wrong-model KV.
            data = encode_entry(key, kp, vp)
            n = self.backend.put(key, data)
        except Exception as exc:  # noqa: BLE001 - full disk, vanished
            # dir, stub backend: all the same loud, non-fatal loss.
            with self._lock:
                self.write_errors += 1
            if self._m is not None:
                self._m["write_errors"].inc(1)
            self._event(
                "kvstore_write_error", level="warn", digest=key,
                error=f"{type(exc).__name__}: {exc}"[:200],
            )
            return False
        with self._lock:
            self.writes += 1
            self.bytes_written += n
            self._recent_writes.append(key)
        if self._m is not None:
            self._m["writes"].inc(1)
            self._m["bytes"].inc(n, direction="write")
        return True

    def put_blocks(self, blocks: Sequence[Tuple[str, Any, Any]]) -> int:
        """Write an export wire form through (``[(digest_hex, kp, vp),
        ...]``); returns blocks stored. Already-present digests are
        rewritten — content addressing makes that byte-idempotent, and
        the fresh mtime is exactly the LRU touch we want."""
        n = 0
        for hexd, kp, vp in blocks:
            if self.put_block(hexd, kp, vp):
                n += 1
        if n:
            self.gc()
        return n

    # -- source (fetch) ---------------------------------------------------
    def get_chain(
        self, digests_hex: Sequence[str]
    ) -> Tuple[List[Tuple[str, Any, Any]], List[str]]:
        """A digest chain back in the export wire form, chain order,
        stopping at the first miss (a later block without its ancestors
        can never be matched engine-side): ``(blocks, missing_tail)``.
        A corrupt entry is deleted, rung, and treated as the miss."""
        digests_hex = [str(d) for d in digests_hex]
        out: List[Tuple[str, Any, Any]] = []
        for i, bare in enumerate(digests_hex):
            key = self._key(bare)
            try:
                data = self.backend.get(key)
            except Exception:  # noqa: BLE001 - vanished dir = miss
                data = None
            entry = decode_entry(data) if data is not None else None
            # The embedded digest must round-trip the NAMESPACED key: a
            # legacy bare-digest entry surfacing under this key (moved
            # file, pre-namespace store) mismatches and is dropped as an
            # explicit miss — wrong-model KV can never be served.
            if entry is None or entry[0] != key:
                if data is not None:
                    self._drop(key, "corrupt")
                with self._lock:
                    self.misses += 1
                if self._m is not None:
                    self._m["misses"].inc(1)
                return out, digests_hex[i:]
            with self._lock:
                self.hits += 1
                self.bytes_read += len(data)
            if self._m is not None:
                self._m["hits"].inc(1)
                self._m["bytes"].inc(len(data), direction="read")
            # Callers speak BARE digests (the engines' wire form); the
            # namespace is this store's private key prefix.
            out.append((bare, entry[1], entry[2]))
        return out, []

    def contains(self, digest_hex: str) -> bool:
        """Pure existence probe (no payload read, no hit/miss count) —
        the directory-seeding and hint paths' cheap check."""
        try:
            key = self._key(digest_hex)
            return any(k == key for k, _, _ in self.backend.entries())
        except Exception:  # noqa: BLE001 - vanished dir holds nothing
            return False

    # -- warm-start -------------------------------------------------------
    def manifest(self) -> List[str]:
        """Every stored digest hex, most-recently-used last — the
        restarted fleet's directory seed
        (``ServeClient.seed_store_directory``)."""
        try:
            ents = sorted(self.backend.entries(), key=lambda e: e[2])
        except Exception:  # noqa: BLE001 - no dir, no manifest
            return []
        if not self.namespace:
            # Legacy layout: surface only bare-digest keys — another
            # model's namespaced entries are not OUR warm set.
            return [k for k, _, _ in ents if "." not in k]
        prefix = self.namespace + "."
        return [
            k[len(prefix):] for k, _, _ in ents if k.startswith(prefix)
        ]

    # -- GC ---------------------------------------------------------------
    def gc(self) -> int:
        """Enforce ``budget_mb`` LRU-by-last-access on measured file
        bytes; returns entries evicted. Also the construction-time
        prune pass (the backend already cleared torn tmp files)."""
        if not self.budget_bytes:
            return 0
        try:
            ents = sorted(self.backend.entries(), key=lambda e: e[2])
        except Exception:  # noqa: BLE001 - vanished dir: nothing held
            return 0
        total = sum(n for _, n, _ in ents)
        dropped = 0
        for key, n, _ in ents:
            if total <= self.budget_bytes:
                break
            self._drop(key, "budget")
            total -= n
            dropped += 1
        return dropped

    # -- read side --------------------------------------------------------
    def entry_count(self) -> int:
        try:
            return len(self.backend.entries())
        except Exception:  # noqa: BLE001
            return 0

    def total_bytes(self) -> int:
        try:
            return sum(n for _, n, _ in self.backend.entries())
        except Exception:  # noqa: BLE001
            return 0

    def stats(self) -> Dict[str, Any]:
        """The ``kvstore`` stats block (rides the replica stats
        endpoint into the fleet rows). The rings are
        snapshots, not drains — see their declaration."""
        with self._lock:
            return {
                "backend": getattr(self.backend, "name", "?"),
                "path": self.path,
                "namespace": self.namespace,
                "budget_mb": round(self.budget_bytes / (1 << 20), 3),
                "hits": self.hits,
                "misses": self.misses,
                "writes": self.writes,
                "write_errors": self.write_errors,
                "bytes_written": self.bytes_written,
                "bytes_read": self.bytes_read,
                "evictions": self.evictions,
                "corrupt": self.corrupt,
                "recent_writes": list(self._recent_writes),
                "recent_dropped": list(self._recent_dropped),
            }


#: Journal-header ``kvstore`` keys a replayed capture surfaces — which
#: persistent tier (if any) shaped a recorded session.
KVSTORE_HEADER_KEYS = frozenset((
    "dir", "budget_mb", "writethrough", "namespace",
))


def kvstore_config_from_header(
    header: Optional[Dict[str, Any]],
) -> Dict[str, Any]:
    """The recorded persistent-store knobs from a journal header (empty
    when the capture predates the store or ran without one)."""
    if not header:
        return {}
    section = header.get("kvstore") or {}
    return {
        k: v for k, v in section.items() if k in KVSTORE_HEADER_KEYS
    }
