"""Fabric client mode: drive a remote fabric head from a lightweight process
(PyTorch port of ``ray_lightning_tpu/fabric/client.py``).

``fabric.init(address="host:port", authkey=...)`` connects this process to
a :class:`~ray_lightning_tpu_torch.fabric.server.FabricServer` and every
fabric call (actor spawn, method call, ``put`` / ``get`` / ``wait`` /
``free`` / ``kill``, placement groups, queues, actor metadata) proxies
over the socket. The actors run on the head, which owns the cards; the
client stays a thin controller that needs neither a card nor a CUDA
context.

Concurrency: one TCP connection per client *thread* (the protocol is
request/response), created lazily and cached thread-locally, so a serving
client's per-stream reader threads and a blocking ``get`` from another
thread never interleave frames.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle


class FabricClient:
    def __init__(self, address: str, authkey: Optional[str] = None) -> None:
        host, _, port = address.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._authkey = self._resolve_authkey(authkey)
        self._local = threading.local()
        self._conns: List[Any] = []
        self._lock = threading.Lock()
        # Validate eagerly so a bad address fails at init, not first use.
        self.request(("ping",))

    @staticmethod
    def _resolve_authkey(explicit: Optional[str]) -> bytes:
        """Explicit arg > RLT_FABRIC_AUTHKEY. There is no static default:
        servers generate a per-instance key (printed in their ready line)
        so that reaching the port is not enough to own the fabric."""
        import os

        key = explicit or os.environ.get("RLT_FABRIC_AUTHKEY")
        if not key:
            raise RuntimeError(
                "fabric client mode needs the server's authkey: pass "
                "fabric.init(address=..., authkey=...) or set "
                "RLT_FABRIC_AUTHKEY. The server prints a generated key in "
                "its 'FABRIC_SERVER_READY <addr> key=<key>' line (an "
                "operator-set RLT_FABRIC_AUTHKEY on the server side must "
                "be used instead when present)."
            )
        return key.encode()

    # -- transport ------------------------------------------------------
    def _conn(self) -> Any:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            from multiprocessing import AuthenticationError
            from multiprocessing.connection import Client as MPClient

            try:
                conn = MPClient(
                    self._addr, family="AF_INET", authkey=self._authkey
                )
            except AuthenticationError as exc:
                raise RuntimeError(
                    f"fabric head at {self._addr[0]}:{self._addr[1]} "
                    "rejected the authkey; use the key from the server's "
                    "ready line (or its RLT_FABRIC_AUTHKEY)"
                ) from exc
            self._local.conn = conn
            with self._lock:
                self._conns.append(conn)
        return conn

    def request(self, msg: Any) -> Any:
        conn = self._conn()
        conn.send_bytes(cloudpickle.dumps(msg, protocol=5))
        status, *rest = cloudpickle.loads(conn.recv_bytes())
        if status == "ok":
            return rest[0]
        if status == "timeout":
            raise TimeoutError("fabric.get timed out (remote)")
        raise rest[0]

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


_client: Optional[FabricClient] = None


def connect(address: str, authkey: Optional[str] = None) -> FabricClient:
    """Connect this process to a remote fabric head (client mode)."""
    global _client
    if _client is not None:
        host, _, port = address.rpartition(":")
        if (host or "127.0.0.1", int(port)) != _client._addr:
            raise RuntimeError(
                f"already connected to fabric head at "
                f"{_client._addr[0]}:{_client._addr[1]}; call "
                f"fabric.shutdown() before connecting to {address}"
            )
        return _client
    _client = FabricClient(address, authkey=authkey)
    return _client


def get_client() -> Optional[FabricClient]:
    return _client


def is_connected() -> bool:
    return _client is not None


def disconnect() -> None:
    global _client
    if _client is not None:
        _client.close()
        _client = None


# ---------------------------------------------------------------------------
# Client-side handle types mirroring core's surface
# ---------------------------------------------------------------------------
class _ClientRemoteMethod:
    def __init__(self, handle: "ClientActorHandle", name: str) -> None:
        self._handle = handle
        self._name = name

    def remote(self, *args: Any, **kwargs: Any):
        from ray_lightning_tpu_torch.fabric.core import TaskRef

        blob = cloudpickle.dumps((self._name, args, kwargs), protocol=5)
        call_id = _client.request(("call", self._handle.actor_id, blob))
        return TaskRef(actor_id=self._handle.actor_id, call_id=call_id)


class ClientActorHandle:
    """Client-side proxy to an actor living on the fabric head."""

    def __init__(self, actor_id: str) -> None:
        self.actor_id = actor_id

    def _meta(self) -> Dict[str, Any]:
        return _client.request(("actor_meta", self.actor_id))

    @property
    def node_id(self) -> str:
        return self._meta()["node_id"]

    @property
    def node_ip(self) -> str:
        return self._meta()["node_ip"]

    @property
    def allocated_resources(self) -> Dict[str, float]:
        return self._meta()["allocated_resources"]

    @property
    def visible_cards(self) -> List[str]:
        return self._meta()["visible_cards"]

    @property
    def actor_options(self) -> Dict[str, Any]:
        return self._meta()["actor_options"]

    def is_alive(self) -> bool:
        return self._meta()["is_alive"]

    def __getattr__(self, name: str) -> _ClientRemoteMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return _ClientRemoteMethod(self, name)


class ClientActorClass:
    def __init__(self, cls: type, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = options or {}

    def options(self, **opts: Any) -> "ClientActorClass":
        merged = dict(self._options)
        merged.update(opts)
        return ClientActorClass(self._cls, merged)

    def remote(self, *args: Any, **kwargs: Any) -> ClientActorHandle:
        blob = cloudpickle.dumps((self._cls, args, kwargs), protocol=5)
        opts = dict(self._options)
        pg = opts.pop("placement_group", None)
        if pg is not None:
            # Ship the id; the server resolves it to its live PlacementGroup
            # (which holds Node objects and cannot cross the wire).
            opts["__pg_id__"] = pg.id
        actor_id = _client.request(("spawn", blob, opts))
        return ClientActorHandle(actor_id)


# ---------------------------------------------------------------------------
# API surface used by core's routing
# ---------------------------------------------------------------------------
def remote(cls: type) -> ClientActorClass:
    return ClientActorClass(cls)


def get(refs: Any, timeout: Optional[float] = None) -> Any:
    from ray_lightning_tpu_torch.fabric.core import ObjectRef, TaskRef

    if isinstance(refs, (list, tuple)):
        return type(refs)(get(r, timeout=timeout) for r in refs)
    if isinstance(refs, (ObjectRef, TaskRef)):
        return _client.request(("get", refs, timeout))
    return refs


def put(obj: Any) -> Any:
    return _client.request(("put", cloudpickle.dumps(obj, protocol=5)))


def free(refs: Sequence[Any]) -> None:
    _client.request(("free", list(refs)))


def wait(
    refs: Sequence[Any], num_returns: int = 1, timeout: Optional[float] = None
) -> Tuple[List[Any], List[Any]]:
    return _client.request(("wait", list(refs), num_returns, timeout))


def kill(handle: Any, no_restart: bool = True) -> None:
    # Same contract as core.kill: the fabric never restarts actors in
    # place, so no_restart=False fails loudly instead of silently doing
    # the no_restart=True thing (serve.supervisor restarts replicas).
    if not no_restart:
        raise ValueError(
            "fabric.kill(no_restart=False) is unsupported: fabric "
            "actors are never restarted in place; use "
            "serve.supervisor.FleetSupervisor for replica restarts"
        )
    _client.request(("kill", handle.actor_id))


class ClientPlacementGroup:
    """Client-side proxy to a placement group living on the fabric head."""

    def __init__(
        self, pg_id: str, bundle_node_ids: List[str], strategy: str
    ) -> None:
        self.id = pg_id
        self.bundle_node_ids = bundle_node_ids
        self.strategy = strategy
        self.removed = False


def placement_group(
    bundles: Sequence[Dict[str, float]], strategy: str = "PACK"
) -> ClientPlacementGroup:
    pg_id, node_ids = _client.request(
        ("pg_create", [dict(b) for b in bundles], strategy)
    )
    return ClientPlacementGroup(pg_id, node_ids, strategy)


def remove_placement_group(pg: Any) -> None:
    _client.request(("pg_remove", pg.id))
    pg.removed = True


def nodes() -> List[Dict[str, Any]]:
    return _client.request(("nodes",))


def cluster_resources() -> Dict[str, float]:
    return _client.request(("cluster_resources",))


def available_resources() -> Dict[str, float]:
    return _client.request(("available_resources",))


# ---------------------------------------------------------------------------
# Client-mode queue
# ---------------------------------------------------------------------------
def _rebuild_worker_queue(proxy_blob: bytes) -> Any:
    # Runs inside the head and its workers, which carry the head's mp
    # authkey: the manager proxy authenticates directly there.
    return cloudpickle.loads(proxy_blob)


class ClientQueue:
    """Queue living on the fabric head.

    The client drives it via RPC (its mp authkey differs from the head's,
    so the manager proxy is unusable client-side); pickled into an actor's
    arguments it rebuilds as the head's manager-proxy queue.
    """

    def __init__(self, maxsize: int = 0) -> None:
        self._qid, self._proxy_blob = _client.request(("queue_create", maxsize))

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        _client.request(("queue_op", self._qid, "put", (item, block, timeout)))

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        return _client.request(("queue_op", self._qid, "get", (block, timeout)))

    def get_nowait(self) -> Any:
        return _client.request(("queue_op", self._qid, "get_nowait", ()))

    def empty(self) -> bool:
        return _client.request(("queue_op", self._qid, "empty", ()))

    def qsize(self) -> int:
        return _client.request(("queue_op", self._qid, "qsize", ()))

    def shutdown(self) -> None:
        # Release the head-side queue and its registry entry.
        if _client is not None:
            try:
                _client.request(("queue_delete", self._qid))
            except Exception:  # noqa: BLE001 - head may already be gone
                pass

    def __reduce__(self):
        return (_rebuild_worker_queue, (self._proxy_blob,))
