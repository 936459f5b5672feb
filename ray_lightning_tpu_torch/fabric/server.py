"""Fabric head server: serves a local fabric session to remote clients
(PyTorch port of ``ray_lightning_tpu/fabric/server.py``).

A thin request/response protocol over ``multiprocessing.connection`` (TCP
+ authkey): the head owns the actors, the shared-memory object store, the
queues and the cards (``"GPU"`` is the accelerator resource, as in local
mode); clients drive them remotely through
``fabric.init(address="host:port", authkey=...)``.

Run standalone::

    python -m ray_lightning_tpu_torch.fabric.server --port 0 [--num-gpus 1]

It prints ``FABRIC_SERVER_READY <host:port> key=<key>`` once it listens
(the key only when it generated one). SIGINT stops it; its fabric
session's exit hook then kills every actor it spawned.

Wire protocol (cloudpickle payloads; one request -> one response per client
thread, so a slow ``get`` never blocks other clients: each client thread
opens its own connection):
  ("spawn", blob, opts)        -> ("ok", actor_id)
  ("call", actor_id, blob)     -> ("ok", call_id)
  ("get", ref, timeout)        -> ("ok", value) | ("timeout",) | ("err", exc)
  ("wait", refs, n, timeout)   -> ("ok", (done_refs, pending_refs))
  ("put", payload_blob)        -> ("ok", ObjectRef)
  ("free", [refs])             -> ("ok", None)
  ("kill", actor_id)           -> ("ok", None)
  ("pg_create", bundles, strategy) -> ("ok", (pg_id, bundle_node_ids))
  ("pg_remove", pg_id)         -> ("ok", None)
  ("nodes" | "cluster_resources" | "available_resources") -> ("ok", value)
  ("queue_create", maxsize)    -> ("ok", (qid, proxy_blob))
  ("queue_op", qid, op, args)  -> ("ok", value) | ("err", exc)
  ("queue_delete", qid)        -> ("ok", None)
  ("actor_meta", actor_id)     -> ("ok", {node_id, node_ip, ...})

A value answers ``get`` as the value itself: a worker's result of 1 MiB
or more, which reaches the head parked in shared memory
(``fabric/worker.py:_send_frame``), was already loaded and unlinked by the
head's reader thread, so no segment name crosses the wire to a client
that may run on another host.
"""
from __future__ import annotations

import threading
import traceback
from typing import Any, Dict, Optional

import cloudpickle


def _env_authkey() -> Optional[bytes]:
    import os

    key = os.environ.get("RLT_FABRIC_AUTHKEY")
    return key.encode() if key else None


class FabricServer:
    """Owns a real local fabric session and serves it over a socket.

    Authentication: a shared secret over ``multiprocessing.connection``'s
    HMAC challenge. Resolution order: explicit ``authkey`` ctor arg, then
    ``RLT_FABRIC_AUTHKEY``, else a per-server random key is GENERATED
    (``secrets.token_hex``) and printed with the ready line: a process
    that can merely reach the port does not own the fabric.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        authkey: Optional[bytes] = None,
    ) -> None:
        from multiprocessing.connection import Listener

        from ray_lightning_tpu_torch.fabric import core

        # Only tear down the session at shutdown if this server created it;
        # when embedded next to an existing local session, stopping the
        # server must not kill the host process's actors or object store.
        self._owns_session = not core.is_initialized()
        if self._owns_session:
            core.init()
        key = authkey if authkey is not None else _env_authkey()
        if key is not None and not key:
            raise ValueError("authkey must be non-empty")
        self.authkey_generated = key is None
        if key is None:
            import secrets

            key = secrets.token_hex(16).encode()
        # Printable form for the ready line. Generated keys are always
        # hex; an operator-passed binary key stays usable (it is never
        # echoed) and only its display form is escaped.
        self.authkey = key.decode("utf-8", "backslashreplace")
        # A serving client opens a connection per stream thread, many at
        # once: with the default backlog of 1 the kernel drops the
        # handshakes that overflow it, and their clients wait forever for
        # a challenge.
        self._listener = Listener(
            address=(host, port), family="AF_INET", authkey=key,
            backlog=128,
        )
        self.address = f"{self._listener.address[0]}:{self._listener.address[1]}"
        self._queues: Dict[str, Any] = {}
        self._actors: Dict[str, Any] = {}
        self._pgs: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop.is_set():
                self._stop.wait(0.5)
        finally:
            self.shutdown()

    def start(self) -> None:
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fabric-server-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        from multiprocessing import AuthenticationError

        while not self._stop.is_set():
            try:
                conn = self._listener.accept()
            except (AuthenticationError, EOFError, ConnectionError):
                # Bad key, port scanner, or half-open handshake: the
                # misbehaving CLIENT must not kill the server; drop the
                # connection and keep listening.
                continue
            except OSError:
                if self._stop.is_set():
                    break  # listener closed by shutdown()
                # Transient socket error: back off briefly so a dead
                # listener cannot spin this loop hot.
                self._stop.wait(0.1)
                continue
            t = threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            )
            t.start()

    def shutdown(self) -> None:
        from ray_lightning_tpu_torch.fabric import core

        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._owns_session:
            core.shutdown()

    # ------------------------------------------------------------------
    def _client_loop(self, conn: Any) -> None:
        while not self._stop.is_set():
            try:
                msg = cloudpickle.loads(conn.recv_bytes())
            except (EOFError, OSError):
                break
            try:
                resp = self._handle(msg)
            except BaseException as exc:  # noqa: BLE001 - ship to client
                resp = ("err", _exc_for_wire(exc))
            try:
                conn.send_bytes(cloudpickle.dumps(resp, protocol=5))
            except (OSError, BrokenPipeError):
                break
        try:
            conn.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def _handle(self, msg: Any) -> Any:
        from ray_lightning_tpu_torch.fabric import core

        kind = msg[0]
        if kind == "spawn":
            _, blob, opts = msg
            cls, args, kwargs = cloudpickle.loads(blob)
            opts = dict(opts)
            # Clients reference placement groups by id (the server-side
            # PlacementGroup holds live Node objects and never crosses the
            # wire); resolve to the registered object before scheduling.
            pg_id = opts.pop("__pg_id__", None)
            if pg_id is not None:
                pg = self._pgs.get(pg_id)
                if pg is None:
                    raise core.FabricError(f"unknown placement group {pg_id}")
                opts["placement_group"] = pg
            handle = core.remote(cls).options(**opts).remote(*args, **kwargs)
            self._actors[handle.actor_id] = handle
            return ("ok", handle.actor_id)
        if kind == "call":
            _, actor_id, blob = msg
            handle = self._actors.get(actor_id)
            if handle is None:
                raise core.ActorDiedError(f"unknown actor {actor_id}")
            name, args, kwargs = cloudpickle.loads(blob)
            ref = getattr(handle, name).remote(*args, **kwargs)
            return ("ok", ref.call_id)
        if kind == "get":
            _, ref, timeout = msg
            try:
                return ("ok", core.get(ref, timeout=timeout))
            except TimeoutError:
                return ("timeout",)
        if kind == "wait":
            _, refs, num_returns, timeout = msg
            done, pending = core.wait(
                refs, num_returns=num_returns, timeout=timeout
            )
            return ("ok", (done, pending))
        if kind == "put":
            _, blob = msg
            return ("ok", core.put(cloudpickle.loads(blob)))
        if kind == "free":
            _, refs = msg
            core.free(refs)
            return ("ok", None)
        if kind == "kill":
            _, actor_id = msg
            handle = self._actors.pop(actor_id, None)
            if handle is not None:
                core.kill(handle)
            return ("ok", None)
        if kind == "pg_create":
            _, bundles, strategy = msg
            pg = core.placement_group(bundles, strategy=strategy)
            self._pgs[pg.id] = pg
            return ("ok", (pg.id, pg.bundle_node_ids))
        if kind == "pg_remove":
            _, pg_id = msg
            pg = self._pgs.pop(pg_id, None)
            if pg is not None:
                core.remove_placement_group(pg)
            return ("ok", None)
        if kind == "nodes":
            return ("ok", core.nodes())
        if kind == "cluster_resources":
            return ("ok", core.cluster_resources())
        if kind == "available_resources":
            return ("ok", core.available_resources())
        if kind == "actor_meta":
            _, actor_id = msg
            handle = self._actors.get(actor_id)
            if handle is None:
                raise core.ActorDiedError(f"unknown actor {actor_id}")
            return (
                "ok",
                {
                    "node_id": handle.node_id,
                    "node_ip": handle.node_ip,
                    "allocated_resources": handle.allocated_resources,
                    "visible_cards": handle.visible_cards,
                    "actor_options": handle.actor_options,
                    "is_alive": handle.is_alive(),
                },
            )
        if kind == "queue_create":
            import uuid

            from ray_lightning_tpu_torch.fabric.queue import Queue

            qid = uuid.uuid4().hex[:12]
            q = Queue(msg[1] if len(msg) > 1 else 0)
            self._queues[qid] = q
            # Ship the manager-proxy state so head-spawned workers (which
            # carry the head's mp authkey) can use the queue directly.
            proxy_blob = cloudpickle.dumps(q, protocol=5)
            return ("ok", (qid, proxy_blob))
        if kind == "queue_op":
            _, qid, op, args = msg
            q = self._queues[qid]
            return ("ok", getattr(q, op)(*args))
        if kind == "queue_delete":
            _, qid = msg
            q = self._queues.pop(qid, None)
            if q is not None:
                q.shutdown()
            return ("ok", None)
        if kind == "ping":
            return ("ok", "pong")
        raise ValueError(f"unknown request {kind!r}")


def _exc_for_wire(exc: BaseException) -> BaseException:
    try:
        cloudpickle.dumps(exc)
        return exc
    except Exception:  # noqa: BLE001
        return RuntimeError(
            f"{type(exc).__name__}: {exc}\n{traceback.format_exc()}"
        )


def main(argv: Any = None) -> None:
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None)
    args = parser.parse_args(argv)

    from ray_lightning_tpu_torch.fabric import core

    core.init(num_cpus=args.num_cpus, num_gpus=args.num_gpus)
    server = FabricServer(host=args.host, port=args.port)
    # Parseable ready line for launch scripts and tests. A GENERATED key
    # is printed so the operator can hand it to clients; an
    # operator-provided key (env or ctor) is never echoed.
    if server.authkey_generated:
        print(
            f"FABRIC_SERVER_READY {server.address} key={server.authkey}",
            flush=True,
        )
    else:
        print(f"FABRIC_SERVER_READY {server.address}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass  # SIGINT is the stop signal; the session's exit hook cleans up


if __name__ == "__main__":
    main()
