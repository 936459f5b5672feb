"""Serving replica: a fabric actor hosting one DecodeEngine + Scheduler
(PyTorch port of ``ray_lightning_tpu/serve/server.py``).

``build_engine`` is the entry point a replica (and a journal replay)
builds its engine through: it loads the weights (a checkpoint the port's
``Trainer`` wrote, or explicit params), optionally quantizes them to
weight-only int8 (``int8=True``; ``spec_draft_int8`` for the draft
model), and constructs the :class:`DecodeEngine`.

:class:`ServeReplica` is one replica: the actor's RPC surface (``submit``
/ ``result`` / ``cancel`` / ``stats`` ...) only touches host-side queues;
a daemon loop thread drives the scheduler, so every dispatch and graph
replay runs on that one thread while requests stream in through the
fabric connection. Fleets are spawned through
``serve.client.start_replicas``. A replica has a ``role`` (``mixed``,
``prefill`` or ``decode``); with ``kv_inbox``/``kv_peers`` it runs the
fleet KV plane (``serve/kvfleet.py``: peer fetches and disaggregated
ships), and with ``kvstore_dir`` its engine writes to and reads from the
KV object store (``serve/kvstore.py``; ``park_session`` parks a
conversation there).

A tensor-parallel replica is a gang of rank processes (``mesh``
``"MODELxDATA"``, ``dist``, ``gang_queues``; spawned by
``start_replicas(hosts_per_replica=N)``): the leader is a
:class:`ServeReplica` whose scheduler drives a :class:`_GangLeaderEngine`,
which ships every device-mutating engine call to the
:class:`ServeShardFollower` ranks before running it; each rank runs the
same engine on its slice of the heads, and the collectives inside the
model functions keep them in step. The profiler RPC (ROADMAP queue 1
item 14) is not ported.
"""
from __future__ import annotations

import hashlib
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_lightning_tpu_torch.models.gpt import GPTConfig, params_to
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.quantize import quantize_params_int8
from ray_lightning_tpu_torch.utils.state_stream import load_state_stream


def load_serve_params(
    ckpt_path: str, model_config: Optional[Dict[str, Any]] = None
) -> Tuple[Dict[str, Any], GPTConfig]:
    """Load (params, GPTConfig) for serving from a checkpoint file: a state
    stream holding ``{"params", "gpt_config"}`` (``model_config`` entries
    override the stored config) or a trainer checkpoint ``{"params": ...}``
    (plus optimizer state, ignored), which needs ``model_config``. Tensors
    land on the CPU; the engine moves them."""
    overrides = dict(model_config or {})
    with open(ckpt_path, "rb") as f:
        tree = load_state_stream(f.read())
    stored = dict(tree.get("gpt_config") or {})
    if stored:
        stored.update(overrides)
        cfg_fields = stored
    elif overrides:
        cfg_fields = overrides
    else:
        raise ValueError(
            f"checkpoint {ckpt_path} carries no gpt_config; pass the model "
            "config (model_config)"
        )
    params = tree["params"] if "params" in tree else tree
    return params, GPTConfig(**cfg_fields)


#: Engine-facing construction kwargs (the JAX package's set): what a
#: journal header's engine section and a replica's config carry into
#: :func:`build_engine`, and what a gang follower builds its engine from.
#: ``kvstore_dir``/``kvstore_mb`` are leader-only, as in the JAX package:
#: a follower gets them apart (:data:`STORE_KEYS`) only to join the head
#: gathers of its split gang's store writes.
ENGINE_KEYS = frozenset((
    "ckpt_path", "model_config", "params", "int8", "num_slots", "max_seq",
    "prefill_buckets", "decode_fold", "pipeline", "prefill_chunk",
    "prefix_blocks", "prefix_block", "prefix_host_mb", "prefix_disk_dir",
    "prefix_disk_mb", "kv_page", "kv_pages", "spec", "spec_depth",
    "spec_draft_ckpt", "spec_draft_config", "spec_draft_int8",
    "spec_window", "mesh", "piggyback_chunks", "fold_ladder",
))


#: The store's kwargs a gang follower takes beside :data:`ENGINE_KEYS`:
#: its engine opens no store, but gathers the heads the leader writes.
STORE_KEYS = frozenset(("kvstore_dir", "kvstore_mb", "kvstore_namespace"))


def build_engine(
    ckpt_path: Optional[str] = None,
    model_config: Optional[Dict[str, Any]] = None,
    params: Any = None,
    int8: bool = False,
    num_slots: int = 4,
    max_seq: Optional[int] = None,
    prefill_buckets: Optional[Sequence[int]] = None,
    decode_fold: int = 1,
    pipeline: bool = True,
    prefill_chunk: int = 0,
    prefix_blocks: int = 0,
    prefix_block: int = 16,
    prefix_host_mb: float = 0.0,
    prefix_disk_dir: Optional[str] = None,
    prefix_disk_mb: float = 0.0,
    kvstore_dir: Optional[str] = None,
    kvstore_mb: float = 0.0,
    kvstore_namespace: Optional[str] = None,
    kv_page: int = 0,
    kv_pages: int = 0,
    spec: str = "off",
    spec_depth: int = 4,
    spec_draft_ckpt: Optional[str] = None,
    spec_draft_config: Optional[Dict[str, Any]] = None,
    spec_draft_int8: bool = False,
    spec_window: int = 32,
    mesh: Optional[str] = None,
    piggyback_chunks: int = 0,
    fold_ladder: Optional[Sequence[int]] = None,
    device: Any = "cuda",
) -> Any:
    """Load weights (and the draft model for ``spec="model"``) and
    construct the engine on ``device`` (the card unless ``"cpu"`` is
    passed). ``int8`` quantizes the weights at load
    (``utils/quantize.py:quantize_params_int8``, on the device), and
    ``spec_draft_int8`` the draft's. ``kvstore_dir`` gives the engine the
    KV object store, namespaced by ``kvstore_namespace`` or else by the raw
    (``ckpt_path``, ``model_config``) pair, so the driver and every
    replica derive the same namespace without loading the checkpoint.
    ``mesh`` is a ``"MODELxDATA"`` spec (``parallel/mesh.py:
    mesh_from_spec``): None or ``"1x1"`` is the one-card engine; anything
    larger needs this process joined to a world of exactly model x data
    ranks (:func:`_setup_gang_rendezvous`), every rank of which builds the
    same engine from the same checkpoint and keeps its slice."""
    from ray_lightning_tpu_torch.parallel.mesh import mesh_from_spec
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.kvstore import (
        kvstore_namespace as _kvstore_namespace,
    )

    device = resolve_device(device)
    t_load = time.perf_counter()
    serve_mesh = mesh_from_spec(mesh)
    if params is None:
        if ckpt_path is None:
            raise ValueError("need ckpt_path or params")
        params, cfg = load_serve_params(ckpt_path, model_config)
    else:
        if model_config is None:
            raise ValueError("explicit params need model_config")
        cfg = (
            model_config
            if isinstance(model_config, GPTConfig)
            else GPTConfig(**model_config)
        )
    if int8:
        params = quantize_params_int8(params_to(params, device))
    spec_params = None
    spec_cfg = None
    if spec == "model":
        if spec_draft_ckpt is None:
            raise ValueError(
                "spec='model' needs spec_draft_ckpt (the draft model's "
                "checkpoint)"
            )
        spec_params, spec_cfg = load_serve_params(
            spec_draft_ckpt, spec_draft_config
        )
        if spec_draft_int8:
            spec_params = quantize_params_int8(params_to(spec_params, device))
    load_s = time.perf_counter() - t_load
    engine = DecodeEngine(
        params,
        cfg,
        num_slots=num_slots,
        max_seq=max_seq,
        prefill_buckets=prefill_buckets,
        decode_fold=decode_fold,
        pipeline=pipeline,
        prefill_chunk=prefill_chunk,
        prefix_blocks=prefix_blocks,
        prefix_block=prefix_block,
        prefix_host_mb=prefix_host_mb,
        prefix_disk_dir=prefix_disk_dir,
        prefix_disk_mb=prefix_disk_mb,
        kvstore_dir=kvstore_dir,
        kvstore_mb=kvstore_mb,
        kvstore_namespace=(
            kvstore_namespace
            or _kvstore_namespace(ckpt_path, model_config)
        ),
        kv_page=kv_page,
        kv_pages=kv_pages,
        spec=spec,
        spec_depth=spec_depth,
        spec_params=spec_params,
        spec_config=spec_cfg,
        spec_window=spec_window,
        piggyback_chunks=piggyback_chunks,
        fold_ladder=fold_ladder,
        mesh=serve_mesh,
        device=device,
    )
    #: Seconds the checkpoint took to read (and quantize), before the
    #: engine was built.
    engine.load_s = load_s
    return engine


def _setup_gang_rendezvous(dist: Dict[str, Any]) -> None:
    """Join this process to its gang's world (``dist``: ``num_hosts``,
    ``host_rank``, ``coordinator_address``, ``backend``): one rank per
    process, NCCL where each rank owns a whole card and gloo where ranks
    share one or run on the CPU (``parallel/mesh.py:setup_distributed``).
    Runs before the engine is built; a gang of one does nothing."""
    n = int(dist.get("num_hosts", 1))
    if n <= 1:
        return
    from ray_lightning_tpu_torch.parallel.env import DistEnv
    from ray_lightning_tpu_torch.parallel.mesh import setup_distributed

    setup_distributed(
        DistEnv(world_size=n, num_hosts=n,
                host_rank=int(dist.get("host_rank", 0)),
                coordinator_address=dist.get("coordinator_address"),
                backend=str(dist.get("backend") or "gloo")),
        timeout_s=dist.get("timeout_s"),
    )


class _TokenLog:
    """What a gang member's engine emitted, in call order: a running
    SHA-256 over every (request id, token) the recorded calls returned, and
    their counts. The leader's proxy and each follower record their own
    engine's results of the same op stream, so equal digests mean the
    ranks emitted the same tokens in the same order."""

    def __init__(self) -> None:
        self._hash = hashlib.sha256()
        self.ops = 0
        self.tokens = 0
        self._rids: set = set()

    def _add(self, rid: Any, tok: Any) -> None:
        if rid is None or tok is None:
            return
        self._rids.add(rid)
        self.tokens += 1
        self._hash.update(f"{rid}:{int(tok)};".encode())

    def record(self, name: str, args: tuple, kwargs: dict, out: Any) -> None:
        if name in _GANG_OPS:
            self.ops += 1
        if name == "admit":
            self._add(kwargs.get("request_id"), out[1])
        elif name == "admit_many":
            reqs = kwargs.get("requests", args[0] if args else [])
            for req, (_, tok, _) in zip(reqs, out):
                self._add(req.get("request_id"), tok)
        elif name in ("prefill_step", "pop_chunk_events"):
            for _, task, tok, _ in out:
                self._add(task.request_id, tok)
        elif name == "step":
            for _, rid, tok, _ in out:
                self._add(rid, tok)

    def digest(self) -> Dict[str, Any]:
        return {"ops": self.ops, "requests": len(self._rids),
                "tokens": self.tokens, "sha256": self._hash.hexdigest()}


#: The engine calls that move device state (or, for the exports, run the
#: pool reads and the head gathers every rank must run alike): a gang
#: leader ships each to its followers before running it (JAX
#: ``serve/server.py:228-318``). A split gang's exports return whole
#: blocks on every rank; its imports (whole blocks, or one layer of them)
#: keep each rank's heads.
_GANG_OPS = ("admit", "admit_many", "prefill_step", "step", "release",
             "import_prefix_blocks", "import_prefix_block_layer",
             "abort_layer_imports", "export_blocks_by_digest",
             "export_prefix_blocks", "evict_prefix_chain")


class _GangLeaderEngine:
    """Leader-side engine proxy of a tensor-parallel serving gang.

    Every rank must issue the same sequence of engine calls: the model
    functions' collectives pair up across the ranks only then. The
    scheduler mutates the engine through :data:`_GANG_OPS`; the leader
    ships each call's name and arguments to every follower's queue BEFORE
    running it, and the followers replay the stream on engines built the
    same way. Host bookkeeping (slot choice, the prefix pool's walk and
    LRU, the fold ladder, the piggyback plan) is a function of the op
    stream and of the tokens, which every rank samples from the same
    reduced logits, so the gang stays in step without sharing state.
    Reads delegate without broadcasting, and so do attribute writes (the
    scheduler's ``tracer`` and ``events`` land on the engine). ``log``
    records what the leader's engine emitted (:class:`_TokenLog`)."""

    _OWN = ("_engine", "_queues", "log")

    def __init__(self, engine: Any, queues: Sequence[Any]) -> None:
        object.__setattr__(self, "_engine", engine)
        object.__setattr__(self, "_queues", list(queues))
        object.__setattr__(self, "log", _TokenLog())

    def __getattr__(self, name: str) -> Any:
        if name in _GANG_OPS:
            return lambda *a, **kw: self._call(name, a, kw)
        return getattr(self._engine, name)

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self._OWN:
            object.__setattr__(self, name, value)
        else:
            setattr(self._engine, name, value)

    def _broadcast(self, name: str, args: tuple, kwargs: dict) -> None:
        for q in self._queues:
            q.put((name, args, kwargs))

    def _call(self, name: str, args: tuple, kwargs: dict) -> Any:
        self._broadcast(name, args, kwargs)
        out = getattr(self._engine, name)(*args, **kwargs)
        self.log.record(name, args, kwargs, out)
        return out

    def pop_chunk_events(self) -> Any:
        out = self._engine.pop_chunk_events()
        self.log.record("pop_chunk_events", (), {}, out)
        return out

    def close(self) -> None:
        """End-of-life sentinel: followers drain and exit their loops."""
        for q in self._queues:
            try:
                q.put(None)
            except Exception:  # noqa: BLE001 - best-effort drain
                pass


def _collectives() -> Dict[str, Any]:
    """This process's model-group all-reduces and their gloo seconds
    (``parallel/tp.py:collective_stats``)."""
    from ray_lightning_tpu_torch.parallel.tp import collective_stats

    return {"calls": collective_stats.calls,
            "seconds": collective_stats.seconds}


class ServeShardFollower:
    """A rank > 0 member of a tensor-parallel serving gang (a fabric
    actor; JAX ``serve/server.py:320-424``).

    Joins the gang's world (:func:`_setup_gang_rendezvous`), builds the
    same engine as the leader (:func:`build_engine` on the
    :data:`ENGINE_KEYS` and :data:`STORE_KEYS` of the leader's kwargs; the
    KV store stays the leader's, the follower joins its head gathers), and
    replays the leader's op stream on a daemon thread, so
    every rank runs the same dispatches and collectives. It takes no
    requests: traffic enters through the leader. The replayed calls carry
    the request ids, so the engine's spans land on this process's tracer
    under the leader's ids (:meth:`trace_dump`). A call that fails leaves
    the gang unable to pair its collectives: the loop stops loud (stderr,
    ``stats()["error"]``)."""

    def __init__(
        self,
        op_queue: Any,
        dist: Optional[Dict[str, Any]] = None,
        faults: Any = None,
        device: Any = "cuda",
        **engine_kwargs: Any,
    ) -> None:
        t_init = time.time()
        from ray_lightning_tpu_torch.obs.trace import RequestTracer
        from ray_lightning_tpu_torch.serve.faults import FaultInjector

        self._startup: Dict[str, Any] = {
            "worker_t0": float(os.environ.get("RLT_WORKER_T0") or "nan"),
            "init_t0": t_init,
            "imports_end": time.time(),
        }
        # The follower_op point wedges (or preempts) this op loop.
        self.faults = (
            FaultInjector.parse(faults) or FaultInjector.from_env()
        )
        self._dist = dict(dist or {})
        _setup_gang_rendezvous(self._dist)
        self.engine = build_engine(
            device=device,
            **{k: v for k, v in engine_kwargs.items()
               if k in ENGINE_KEYS or k in STORE_KEYS},
        )
        self.device = self.engine.device
        if self.device.type == "cuda" and self.device.index is None:
            import torch

            self.device = torch.device("cuda", torch.cuda.current_device())
        self.tracer = RequestTracer(capacity=4096)
        self.engine.tracer = self.tracer
        self.log = _TokenLog()
        self.error: Optional[str] = None
        self._queue = op_queue
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="serve-shard-follower", daemon=True
        )
        self._thread.start()
        self._startup["init_end"] = time.time()

    def _loop(self) -> None:
        import queue as _q

        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                op = self._queue.get(timeout=0.25)
            except (_q.Empty, EOFError, BrokenPipeError, ConnectionError):
                continue
            if op is None:
                break
            name, args, kwargs = op
            if self.faults is not None:
                self.faults.hit("follower_op")
            try:
                out = getattr(self.engine, name)(*args, **kwargs)
                self.log.record(name, args, kwargs, out)
                if name == "step":
                    # The leader's scheduler pops these after each step.
                    self.log.record("pop_chunk_events", (), {},
                                    self.engine.pop_chunk_events())
            except Exception as exc:  # noqa: BLE001 - the gang is broken
                self.error = f"{name}: {type(exc).__name__}: {exc}"
                print(f"serve shard follower desync on {self.error}",
                      file=sys.stderr, flush=True)
                break

    def ping(self) -> str:
        return "ok"

    def stats(self) -> Dict[str, Any]:
        """This rank's kernel counters, memory, mesh, graphs, the ops it
        replayed, its start-up and its loop's error (None while it runs)."""
        eng = self.engine
        return {
            "kernels": _kernel_counts(),
            "collectives": _collectives(),
            "memory": eng.memory_stats(),
            "kv_gather": _kv_gather(eng),
            "mesh": eng.mesh_desc,
            "graphed": eng.graphed,
            "compiled_count": eng.compiled_count,
            "backend": None if eng.mesh is None else eng.mesh.backend,
            "ops": self.log.ops,
            "startup": dict(self._startup),
            "error": self.error,
            "alive": self._thread.is_alive(),
        }

    def token_digest(self) -> Dict[str, Any]:
        """The digest of the tokens this rank's engine emitted
        (:class:`_TokenLog`)."""
        return self.log.digest()

    def trace_dump(self, n: int = 16) -> Dict[str, Any]:
        """This follower's trace ring in the stitching wire form."""
        return self.tracer.dump(n)

    def inject_fault(self, plan: Any) -> list:
        """Arm (or disarm with None) a fault plan on this live follower:
        how a test preempts or wedges ONE member of a gang. Replaces any
        previous plan; returns the armed rules."""
        from ray_lightning_tpu_torch.serve.faults import FaultInjector

        inj = FaultInjector.parse(plan)
        self.faults = inj
        return [] if inj is None else inj.describe()

    def preempt_state(self) -> Dict[str, Any]:
        """This follower's preemption-monitor state (what its fabric
        heartbeats carry)."""
        from ray_lightning_tpu_torch.serve.preempt import peek_state

        return peek_state() or {"pending": False}

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)


def _kv_gather(engine: Any) -> Dict[str, Any]:
    """The bytes and host seconds of a split engine's head gathers (its
    KV exports and store writes; 0 on one card)."""
    return {"bytes": int(engine.kv_gather_bytes),
            "seconds": float(engine.kv_gather_s)}


def _kernel_counts() -> Dict[str, Any]:
    """The flash kernels' launch counters of this process (K1 forward,
    K2 dK/dV, K3 dQ), the reference-path calls, and the seconds each
    kernel library took to build here (0.0: loaded as built before): how
    a driver reads a replica's kernels from inside its process."""
    from ray_lightning_tpu_torch.ops import _build
    from ray_lightning_tpu_torch.ops.flash_attention import counters

    return {
        "launches": counters.launches,
        "bwd_dkv_launches": counters.bwd_dkv_launches,
        "bwd_dq_launches": counters.bwd_dq_launches,
        "reference": counters.reference,
        "build_s": dict(_build.build_seconds),
    }


class ServeReplica:
    """One serving replica (designed to run as a fabric actor).

    ``params`` may be passed directly (tests) or loaded from
    ``ckpt_path``; ``int8=True`` quantizes the tree at load. The engine
    runs on ``device``: the card unless the caller passes ``"cpu"``.
    ``stats()["compiles_since_init"]`` counts CUDA graphs captured after
    the engine's construction (the JAX replica's backend compiles since
    init), and ``stats()["kernels"]`` carries the process's flash kernel
    counters. With the fleet KV plane on, ``stats()`` carries its
    ``kvfleet`` block, and with a store its ``kvstore`` block (whose write
    and drop rings feed the router's directory).

    ``mesh`` (``"MODELxDATA"``) with ``dist`` (this rank's place in the
    gang, :func:`_setup_gang_rendezvous`) and ``gang_queues`` (one op queue
    per follower) makes this process the leader of a tensor-parallel gang
    (``start_replicas(hosts_per_replica=N)``): its scheduler drives a
    :class:`_GangLeaderEngine`. ``stats()`` carries ``mesh``,
    ``gang_hosts``, ``graphed`` and the backend. A split gang's KV plane
    and store move whole blocks (its engine's exports gather every rank's
    heads; its imports keep each rank's).
    """

    def __init__(
        self,
        ckpt_path: Optional[str] = None,
        model_config: Optional[Dict[str, Any]] = None,
        params: Any = None,
        int8: bool = False,
        num_slots: int = 4,
        max_seq: Optional[int] = None,
        prefill_buckets: Optional[Sequence[int]] = None,
        max_prefills_per_step: int = 1,
        decode_fold: int = 1,
        fold_ladder: Optional[Sequence[int]] = None,
        piggyback_chunks: int = 0,
        pipeline: bool = True,
        prefill_chunk: int = 0,
        prefix_blocks: int = 0,
        prefix_block: int = 16,
        prefix_host_mb: float = 0.0,
        prefix_disk_dir: Optional[str] = None,
        prefix_disk_mb: float = 0.0,
        kv_page: int = 0,
        kv_pages: int = 0,
        max_prefill_chunks_per_step: int = 1,
        spec: str = "off",
        spec_depth: int = 4,
        spec_draft_ckpt: Optional[str] = None,
        spec_draft_config: Optional[Dict[str, Any]] = None,
        spec_draft_int8: bool = False,
        spec_window: int = 32,
        priority_age_s: Optional[float] = None,
        tick_s: float = 0.002,
        tracing: bool = True,
        trace_capacity: int = 8192,
        journal: bool = True,
        journal_dir: Optional[str] = None,
        journal_capacity: int = 4096,
        router_config: Optional[Dict[str, Any]] = None,
        watchdog: bool = True,
        watchdog_interval_s: float = 1.0,
        stall_s: float = 10.0,
        slo: Optional[Dict[str, Any]] = None,
        blackbox_dir: Optional[str] = None,
        blackbox_keep: int = 3,
        mesh: Optional[str] = None,
        dist: Optional[Dict[str, Any]] = None,
        gang_queues: Optional[Sequence[Any]] = None,
        faults: Any = None,
        preempt_grace_s: float = 30.0,
        preempt_sigterm: bool = True,
        preempt_metadata: bool = False,
        role: str = "mixed",
        kv_self: Optional[int] = None,
        kv_inbox: Any = None,
        kv_peers: Optional[Dict[int, Any]] = None,
        kvfleet_timeout_s: float = 5.0,
        kvfleet_inflight_mb: float = 64.0,
        kvfleet_bandwidth_mbps: float = 0.0,
        kvfleet_layerwise: bool = False,
        kvstore_dir: Optional[str] = None,
        kvstore_mb: float = 0.0,
        kvstore_namespace: Optional[str] = None,
        kvstore_writethrough: bool = False,
        device: Any = "cuda",
    ) -> None:
        t_init = time.time()
        import torch

        from ray_lightning_tpu_torch.obs import blackbox as obs_blackbox
        from ray_lightning_tpu_torch.obs import health as obs_health
        from ray_lightning_tpu_torch.obs.events import get_event_log
        from ray_lightning_tpu_torch.obs.registry import get_registry
        from ray_lightning_tpu_torch.obs.trace import RequestTracer
        from ray_lightning_tpu_torch.serve.faults import FaultInjector
        from ray_lightning_tpu_torch.serve.kvfleet import ROLES, KVFleetPlane
        from ray_lightning_tpu_torch.serve.metrics import ServeMetrics
        from ray_lightning_tpu_torch.serve.preempt import get_monitor
        from ray_lightning_tpu_torch.serve.scheduler import Scheduler
        from ray_lightning_tpu_torch.ops import _build
        from ray_lightning_tpu_torch.utils.graphs import capture_stats

        # Where this replica's start-up goes (``stats()["startup"]``): the
        # interpreter (the fabric worker stamps RLT_WORKER_T0), the imports
        # that unpickling this class and the lines above ran, the CUDA
        # context, the checkpoint read, the engine's set-up, the kernel
        # library's load and the graph capture.
        startup: Dict[str, Any] = {
            "worker_t0": float(os.environ.get("RLT_WORKER_T0") or "nan"),
            "init_t0": t_init,
            "imports_end": time.time(),
        }
        t = time.perf_counter()
        if resolve_device(device).type == "cuda":
            torch.zeros(1, device=device)
        startup["cuda_context_s"] = time.perf_counter() - t
        # A gang's leader joins the gang's world before its engine (whose
        # mesh is built over that world) exists.
        self._dist = dict(dist or {})
        t = time.perf_counter()
        _setup_gang_rendezvous(self._dist)
        startup["rendezvous_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.engine = build_engine(
            ckpt_path=ckpt_path,
            model_config=model_config,
            params=params,
            int8=int8,
            num_slots=num_slots,
            max_seq=max_seq,
            prefill_buckets=prefill_buckets,
            decode_fold=decode_fold,
            fold_ladder=fold_ladder,
            piggyback_chunks=piggyback_chunks,
            pipeline=pipeline,
            prefill_chunk=prefill_chunk,
            prefix_blocks=prefix_blocks,
            prefix_block=prefix_block,
            prefix_host_mb=prefix_host_mb,
            prefix_disk_dir=prefix_disk_dir,
            prefix_disk_mb=prefix_disk_mb,
            kvstore_dir=kvstore_dir,
            kvstore_mb=kvstore_mb,
            kvstore_namespace=kvstore_namespace,
            kv_page=kv_page,
            kv_pages=kv_pages,
            spec=spec,
            spec_depth=spec_depth,
            spec_draft_ckpt=spec_draft_ckpt,
            spec_draft_config=spec_draft_config,
            spec_draft_int8=spec_draft_int8,
            spec_window=spec_window,
            mesh=mesh,
            device=device,
        )
        kernel_s = sum(_build.load_seconds.values())
        startup.update(
            weights_load_s=self.engine.load_s,
            engine_setup_s=(time.perf_counter() - t - self.engine.load_s
                            - self.engine.capture_s),
            kernel_load_s=kernel_s,
            # The first capture runs each body once, which loads the
            # kernel library: the two are split here.
            capture_s=max(0.0, self.engine.capture_s - kernel_s),
        )
        self.device = self.engine.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type == "cuda":
            # The current device is per thread: the loop thread sets it
            # again before its first replay.
            torch.cuda.set_device(self.device)
        self.int8 = bool(int8)
        # A gang: the scheduler drives the proxy that ships every device-
        # mutating call to the followers before running it here; reads,
        # stats and RPCs use the engine itself.
        self._gang: Optional[_GangLeaderEngine] = (
            _GangLeaderEngine(self.engine, gang_queues)
            if gang_queues else None
        )
        # The fleet KV role. A prefill replica ships each finished
        # prefill's blocks, which only a prefix pool holds.
        self.role = str(role)
        if self.role not in ROLES:
            raise ValueError(
                f"unknown replica role {role!r}; valid roles: {ROLES}"
            )
        if self.role == "prefill" and not self.engine.prefix_blocks:
            raise ValueError(
                "role='prefill' needs a prefix pool to ship from: set "
                "prefix_blocks (dense) or kv_pages (paged)"
            )
        self._registry = get_registry()
        self._registry.gauge(
            "rlt_serve_compiled_executables",
            "Engine CUDA graphs captured at construction",
        ).set(self.engine.compiled_count)
        # The frozen-capture contract as a metric: every graph is
        # captured inside the engine's constructor, so any capture after
        # this baseline means a dispatch left the plan.
        self._captures = capture_stats
        self._captures_at_init = capture_stats.graphs
        self.metrics = ServeMetrics(
            self.engine.num_slots, registry=self._registry
        )
        self.metrics.record_memory(self.engine.memory_stats())
        self.tracer = RequestTracer(
            capacity=trace_capacity, enabled=bool(tracing)
        )
        self.events = get_event_log()
        # Preemption signal plane (serve.preempt): SIGTERM, the optional
        # metadata poller, and the `preempt` fault action all funnel into
        # one process monitor; health()/stats() ship its state. SIGTERM
        # records the notice WITHOUT exiting (the drain is the response;
        # fabric kill()'s shutdown message / SIGKILL escalation still end
        # the process), and the notice wakes the loop thread.
        self._work = threading.Event()
        self.preempt = get_monitor(
            grace_s=float(preempt_grace_s), events=self.events
        )
        self.preempt.add_callback(lambda _m: self._work.set())
        if preempt_sigterm:
            self.preempt.install_sigterm()
        if preempt_metadata:
            self.preempt.start_metadata_poller()
        # Workload journal: the deterministic capture of this replica's
        # externally-sourced request stream; the header pins the
        # config/checkpoint identity a replay rebuilds from.
        self.journal = None
        if journal:
            from ray_lightning_tpu_torch.obs.journal import (
                WorkloadJournal,
                engine_header,
            )

            self.journal = WorkloadJournal(
                capacity=int(journal_capacity), spill_dir=journal_dir
            )
            self.journal.set_header(engine_header(
                self.engine,
                ckpt_path=ckpt_path,
                int8=self.int8,
                spec_draft_ckpt=spec_draft_ckpt,
                spec_draft_config=spec_draft_config,
                spec_draft_int8=spec_draft_int8,
                max_prefills_per_step=max_prefills_per_step,
                max_prefill_chunks_per_step=max_prefill_chunks_per_step,
                priority_age_s=priority_age_s,
                router=router_config,
                # The knobs that shaped a fleet capture: shipped outcomes
                # replay as their recorded truncations, and a replay
                # surfaces the sections as kvfleet_config/kvstore_config.
                kvfleet=(
                    {
                        "role": self.role,
                        "peers": len(kv_peers or {}),
                        "timeout_s": float(kvfleet_timeout_s),
                        "max_inflight_mb": float(kvfleet_inflight_mb),
                        "bandwidth_mbps": float(kvfleet_bandwidth_mbps),
                        "layerwise": bool(kvfleet_layerwise),
                    }
                    if (kv_inbox is not None or self.role != "mixed")
                    else None
                ),
                kvstore=(
                    {
                        "dir": self.engine.kvstore_dir,
                        "budget_mb": float(kvstore_mb),
                        "writethrough": bool(kvstore_writethrough),
                        "namespace": self.engine.kvstore_namespace,
                    }
                    if self.engine.kvstore is not None
                    else None
                ),
            ))
        # Deterministic fault injection: an explicit plan beats the
        # RLT_FAULTS env gate; a live replica can be re-armed through
        # the inject_fault RPC.
        self.faults = FaultInjector.parse(
            faults, events=self.events
        ) or FaultInjector.from_env(events=self.events)
        # The store was built in the engine's constructor, before this
        # replica had an event log: its drops and write errors go there.
        if self.engine.kvstore is not None:
            self.engine.kvstore._events = self.events
        # The fleet KV plane, built only when transfer wiring was handed
        # in (start_replicas makes one inbox per replica when it is on).
        self.kvfleet = None
        if kv_inbox is not None:
            self.kvfleet = KVFleetPlane(
                index=0 if kv_self is None else int(kv_self),
                role=self.role,
                inbox=kv_inbox,
                peers=kv_peers,
                block_bytes=self.engine.prefix_block_nbytes,
                timeout_s=float(kvfleet_timeout_s),
                max_inflight_mb=float(kvfleet_inflight_mb),
                bandwidth_mbps=float(kvfleet_bandwidth_mbps),
                layerwise_ship=bool(kvfleet_layerwise),
                registry=self._registry,
                events=self.events,
                store=self.engine.kvstore,
            )
        self.scheduler = Scheduler(
            self._gang if self._gang is not None else self.engine,
            metrics=self.metrics,
            max_prefills_per_step=max_prefills_per_step,
            max_prefill_chunks_per_step=max_prefill_chunks_per_step,
            priority_age_s=priority_age_s,
            tracer=self.tracer,
            events=self.events,
            journal=self.journal,
            faults=self.faults,
            kvfleet=self.kvfleet,
            role=self.role,
            kvstore=self.engine.kvstore,
            kvstore_writethrough=bool(kvstore_writethrough),
        )
        self._serve_config: Dict[str, Any] = {
            "num_slots": self.engine.num_slots,
            "max_seq": self.engine.max_seq,
            "decode_fold": self.engine.decode_fold,
            "fold_ladder": list(self.engine.fold_ladder),
            "piggyback_chunks": self.engine.piggyback_chunks,
            "pipeline": self.engine.pipeline,
            "prefill_chunk": self.engine.prefill_chunk,
            "prefix_blocks": self.engine.prefix_blocks,
            "kv_page": self.engine.kv_page,
            "kv_pages": self.engine.kv_pages,
            "prefix_host_mb": self.engine.prefix_host_mb,
            "prefix_disk_dir": self.engine.prefix_disk_dir,
            "prefix_disk_mb": self.engine.prefix_disk_mb,
            "spec": self.engine.spec,
            "spec_depth": self.engine.spec_depth,
            "int8": self.int8,
            "mesh": self.engine.mesh_desc,
            "gang_hosts": int(self._dist.get("num_hosts", 1)),
            "role": self.role,
            "kvfleet": self.kvfleet is not None,
            "kvfleet_layerwise": bool(kvfleet_layerwise),
            "kvstore_dir": self.engine.kvstore_dir,
            "kvstore_mb": self.engine.kvstore_mb,
            "kvstore_namespace": self.engine.kvstore_namespace,
            "kvstore_writethrough": bool(kvstore_writethrough),
            "device": str(self.device),
            "watchdog": bool(watchdog),
            "stall_s": float(stall_s),
            "slo": dict(slo or {}),
            "journal": self.journal is not None,
            "preempt_grace_s": float(preempt_grace_s),
        }
        self.events.record(
            "serve", "replica_init",
            slots=self.engine.num_slots,
            compiled=self.engine.compiled_count,
        )
        # -- the active half: flight recorder + watchdog ------------------
        self.blackbox = obs_blackbox.FlightRecorder(
            outdir=blackbox_dir,
            keep=blackbox_keep,
            registry=self._registry,
            events=self.events,
            tracer=self.tracer,
            journal=self.journal,
            # The LAST report, not a fresh evaluation: a dump triggered
            # from inside evaluate() (on_unhealthy) must capture the
            # verdict that fired it, and must not recurse.
            health_fn=lambda: (
                self.watchdog.report().to_dict()
                if self.watchdog is not None
                else self.health()
            ),
            config=self._serve_config,
        )
        self.watchdog: Optional[Any] = None
        if watchdog:
            reg = self._registry
            tokens = reg.counter("rlt_serve_tokens_emitted_total")
            lifecycle = reg.counter("rlt_serve_requests_total")
            wd = obs_health.Watchdog(
                interval_s=float(watchdog_interval_s),
                registry=reg,
                events=self.events,
                on_unhealthy=lambda comp, rep: self.blackbox.maybe_dump(
                    f"unhealthy:{comp}"
                ),
            )
            # Every check only READS state the hot paths already publish
            # (registry counters, slot counts) — zero hot-loop cost.
            wd.add_check(obs_health.engine_stall_check(
                lambda: self.engine.num_active, tokens.value, float(stall_s)
            ))
            wd.add_check(obs_health.admission_wedge_check(
                self.scheduler.queue_depth,
                lambda: lifecycle.value(kind="admitted"),
                float(stall_s),
                free_slots_fn=lambda: len(self.engine.free_slots()),
            ))
            wd.add_check(obs_health.compile_storm_check(
                self._compiles_since_init
            ))
            if slo:
                wd.add_check(obs_health.slo_check(
                    obs_health.parse_slo_rules(dict(slo)),
                    self.metrics.snapshot,
                    registry=reg,
                    events=self.events,
                ))
            self.watchdog = wd.start()
        self._tick = float(tick_s)
        #: request_id -> {"tokens": [...], "done": bool, "status": str}
        self._buffers: Dict[str, Dict[str, Any]] = {}
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="serve-replica-loop", daemon=True
        )
        self._thread.start()
        startup["init_end"] = time.time()
        self._startup = startup

    def _compiles_since_init(self) -> int:
        return self._captures.graphs - self._captures_at_init

    # -- loop thread (owns all engine work) -------------------------------
    def _loop(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            if not self.scheduler.has_work():
                self._work.wait(timeout=0.1)
                self._work.clear()
                continue
            events = self.scheduler.step()
            if events:
                with self._cond:
                    for ev in events:
                        buf = self._buffers.setdefault(
                            ev.request_id,
                            {"tokens": [], "done": False, "status": "running"},
                        )
                        if ev.token is not None:
                            buf["tokens"].append(ev.token)
                        if ev.done:
                            buf["done"] = True
                            buf["status"] = (
                                "finished" if ev.reason in ("token", "finished")
                                else ev.reason
                            )
                            if ev.ship_to is not None:
                                # The client resubmits on this decode
                                # replica and the stream goes on there.
                                buf["ship_to"] = int(ev.ship_to)
                                buf["ship_digests"] = list(
                                    ev.ship_digests or []
                                )
                    self._cond.notify_all()
            if self._tick:
                self._stop.wait(self._tick)

    # -- RPC surface ------------------------------------------------------
    def ping(self) -> str:
        return "ok"

    def submit(
        self,
        prompt: Sequence[int],
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        seed: int = 0,
        eos_token: Optional[int] = None,
        priority: int = 0,
        deadline_s: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
        kv_hint: Optional[Dict[str, Any]] = None,
        ship_to: Optional[int] = None,
    ) -> str:
        """``request_id`` lets the CLIENT mint the id before the RPC —
        the trace-stitching anchor. ``tenant`` labels the request's
        cost-ledger record. ``kv_hint``/``ship_to`` are the router's fleet
        KV placement hints (fetch the prefix chain from a warm peer or the
        store; ship the finished prefill's blocks to that decode replica);
        without a fleet KV plane the request prefills and decodes here."""
        return self.submit_many([{
            "prompt": prompt, "max_new_tokens": max_new_tokens,
            "temperature": temperature, "top_k": top_k, "top_p": top_p,
            "seed": seed, "eos_token": eos_token, "priority": priority,
            "deadline_s": deadline_s, "request_id": request_id,
            "tenant": tenant, "kv_hint": kv_hint, "ship_to": ship_to,
        }])[0]

    def submit_many(
        self, requests: Sequence[Dict[str, Any]]
    ) -> List[str]:
        """Batched admission: ONE RPC admits every request in
        ``requests`` (each a dict of :meth:`submit` kwargs plus
        ``prompt``), seeding all result buffers under one lock pass and
        waking the serve loop once. Per-request semantics are identical
        to ``submit``."""
        from ray_lightning_tpu_torch.serve.scheduler import SamplingParams

        rids: List[str] = []
        for req in requests:
            if self.faults is not None:
                self.faults.hit("rpc_submit")
            # The buffer is seeded BEFORE the scheduler sees the request
            # (a resubmitted id starts from an empty buffer): the loop
            # thread may emit its first token before this call returns.
            given = req.get("request_id")
            if given is not None:
                with self._cond:
                    self._buffers[given] = {
                        "tokens": [], "done": False, "status": "queued",
                    }
            rids.append(self.scheduler.submit(
                req["prompt"],
                SamplingParams(
                    max_new_tokens=req.get("max_new_tokens", 32),
                    temperature=req.get("temperature", 0.0),
                    top_k=req.get("top_k"),
                    top_p=req.get("top_p"),
                    seed=req.get("seed", 0),
                    eos_token=req.get("eos_token"),
                ),
                request_id=req.get("request_id"),
                priority=req.get("priority", 0),
                deadline_s=req.get("deadline_s"),
                tenant=req.get("tenant"),
                kv_hint=req.get("kv_hint"),
                ship_to=req.get("ship_to"),
            ))
        with self._cond:
            for rid in rids:
                self._buffers.setdefault(rid, {
                    "tokens": [], "done": False, "status": "queued",
                })
        self._work.set()
        return rids

    def result(
        self, request_id: str, cursor: int = 0, wait_s: float = 0.0
    ) -> Dict[str, Any]:
        """Tokens past ``cursor`` plus done/status. ``wait_s > 0`` blocks
        (briefly — the actor handles calls serially) until new tokens or
        completion, which keeps streaming polls cheap."""
        import time as _time

        if self.faults is not None:
            self.faults.hit("rpc_result")
        deadline = _time.monotonic() + max(0.0, wait_s)
        with self._cond:
            while True:
                buf = self._buffers.get(request_id)
                if buf is None:
                    raise KeyError(f"unknown request {request_id!r}")
                if buf["done"] or len(buf["tokens"]) > cursor:
                    break
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            out = {
                "tokens": list(buf["tokens"][cursor:]),
                "done": buf["done"],
                "status": buf["status"],
            }
            if "ship_to" in buf:
                out["ship_to"] = buf["ship_to"]
                out["ship_digests"] = buf.get("ship_digests") or []
            return out

    def cancel(self, request_id: str) -> bool:
        ok = self.scheduler.cancel(request_id)
        self._work.set()
        return ok

    def stats(self) -> Dict[str, Any]:
        """The stats endpoint: metrics snapshot + engine anatomy +
        embedded registry values + this process's kernel counters."""
        snap = self.metrics.snapshot()
        snap.update(
            {
                "active_slots": self.engine.num_active,
                "compiled_count": self.engine.compiled_count,
                # Graphs captured since construction ended: non-zero
                # means a shape leaked into the hot path.
                "compiles_since_init": self._compiles_since_init(),
                "capture_s": self.engine.capture_s,
                "graph_bytes": self.engine.graph_bytes,
                "kernels": _kernel_counts(),
                "collectives": _collectives(),
                "startup": dict(self._startup),
                "device": str(self.device),
                "max_seq": self.engine.max_seq,
                "prefill_buckets": list(self.engine.prefill_buckets),
                "decode_fold": self.engine.decode_fold,
                "pipeline": self.engine.pipeline,
                "prefill_chunk": self.engine.prefill_chunk,
                "prefix_cache": self.engine.prefix_blocks > 0,
                "paged": self.engine.paged,
                "kv_page": self.engine.kv_page,
                "kv_pages_total": self.engine.kv_pages,
                "int8": self.int8,
                "mesh": self.engine.mesh_desc,
                "gang_hosts": int(self._dist.get("num_hosts", 1)),
                "graphed": self.engine.graphed,
                "backend": (None if self.engine.mesh is None
                            else self.engine.mesh.backend),
                "memory": self.engine.memory_stats(),
                "kv_gather": _kv_gather(self.engine),
                "tracing": self.tracer.enabled,
                "metrics": self._registry.to_dict(),
            }
        )
        snap["role"] = self.role
        if self.kvfleet is not None:
            snap["kvfleet"] = self.kvfleet.stats()
        if self.engine.kvstore is not None:
            # Counters and the write/drop rings the router's directory
            # feeds its store-held half from. The store keys its entries
            # "<namespace>.<digest>"; the directory speaks bare digests,
            # so the rings go out bare (the router's hex decode drops a
            # namespaced key).
            kvs = self.engine.kvstore.stats()
            prefix = f"{kvs['namespace']}." if kvs["namespace"] else ""
            for ring in ("recent_writes", "recent_dropped"):
                kvs[ring] = [k[len(prefix):] if k.startswith(prefix) else k
                             for k in kvs[ring]]
            snap["kvstore"] = kvs
        snap["slo_breaches"] = int(sum(
            self._registry.counter(
                "rlt_slo_breaches_total"
            ).samples().values()
        ))
        if self.engine.prefix_blocks:
            snap["prefix"] = self.engine.prefix_stats()
            # Eviction-invalidation feed for the driver-side fleet
            # directory: digests this engine dropped from EVERY tier.
            snap["kv_dropped"] = {
                "total": self.engine.kv_dropped_total,
                "recent": self.engine.dropped_digests(),
            }
        if self.engine.paged:
            snap["kv_pages"] = self.engine.kv_page_stats()
        snap["fold_k"] = {
            "ladder": list(self.engine.fold_ladder),
            "dispatches": {
                str(k): int(n)
                for k, n in self.engine.fold_dispatches.items()
            },
        }
        if self.engine.piggyback_chunks:
            snap["piggyback"] = {
                "chunks": self.engine.piggyback_chunks,
                "dispatches": int(self.engine.piggyback_dispatches),
                "chunk_rows": int(self.engine.piggyback_chunk_rows),
            }
        snap["spec"] = self.engine.spec
        if self.engine.spec != "off":
            snap["spec_stats"] = self.engine.spec_stats()
        snap["health"] = self.health()["verdict"]
        snap["preempt"] = self.preempt.state()
        return snap

    # -- health / forensics RPCs ------------------------------------------
    def health(self) -> Dict[str, Any]:
        """This replica's health report (obs.health), evaluated FRESH."""
        if self.watchdog is None:
            out = {
                "verdict": "healthy", "healthy": True, "reasons": [],
                "components": {}, "watchdog": False,
            }
        else:
            out = self.watchdog.evaluate().to_dict()
            out["watchdog"] = True
        # Preemption is NOT unhealthiness (the process still serves).
        out["preempt"] = self.preempt.state()
        return out

    def debug_dump(
        self, reason: str = "rpc", pull: bool = False
    ) -> Dict[str, Any]:
        """Write a flight-recorder bundle NOW (not rate-limited); returns
        its manifest, plus the bundle files inline when ``pull``."""
        from ray_lightning_tpu_torch.obs import blackbox as obs_blackbox

        manifest = self.blackbox.dump(reason=reason)
        if pull:
            manifest["files_content"] = obs_blackbox.read_bundle(
                manifest["dir"]
            )
        return manifest

    def recent_events(self, n: int = 64) -> list:
        """Tail of this process's structured event log (obs.events)."""
        return self.events.tail(n)

    def inject_fault(self, plan: Any) -> list:
        """Arm (or disarm with None) a deterministic fault plan on this
        LIVE replica; returns the armed rules. Replaces any previous
        plan."""
        from ray_lightning_tpu_torch.serve.faults import FaultInjector

        inj = FaultInjector.parse(plan, events=self.events)
        self.faults = inj
        self.scheduler.faults = inj
        return [] if inj is None else inj.describe()

    # -- preemption drain RPCs --------------------------------------------
    def preempt_now(self, grace_s: Optional[float] = None) -> float:
        """Record a preemption notice on this replica; returns the
        deadline's remaining seconds."""
        self.preempt.notice(grace_s=grace_s, source="rpc")
        return float(self.preempt.remaining() or 0.0)

    def begin_drain(
        self,
        budget_s: Optional[float] = None,
        wait_s: float = 15.0,
    ) -> Dict[str, Any]:
        """Run the graceful-drain classification: requests that can
        finish inside ``budget_s`` (default: the monitor's remaining
        grace) keep running; the rest are cancelled at the next step
        boundary and returned as the MIGRATE set, each with its cached
        prefix blocks serialized for the survivor. Blocks until the loop
        thread publishes the plan (it does engine work)."""
        if budget_s is None:
            budget_s = self.preempt.remaining()
        if budget_s is None:
            budget_s = self.preempt.grace_s
        self.scheduler.request_drain(float(budget_s))
        self._work.set()  # an idle loop must still produce the plan
        plan = self.scheduler.drain_result(timeout=float(wait_s))
        if plan is None:
            raise TimeoutError(
                f"drain plan not produced within {wait_s}s (loop thread "
                "wedged?)"
            )
        return plan

    def import_prefix_blocks(self, blocks: Any) -> int:
        """Accept a dying peer's exported prefix blocks: queued here,
        imported into the engine pool at the top of the next scheduler
        step (engine mutations stay on the loop thread). Returns blocks
        queued (a gang's leader runs the import as an op of its stream,
        each rank keeping its heads)."""
        n = self.scheduler.enqueue_prefix_import(blocks)
        self._work.set()
        return n

    def park_session(
        self,
        tokens: Sequence[int],
        request_id: Optional[str] = None,
        wait_s: float = 15.0,
    ) -> Dict[str, Any]:
        """Park an idle conversation: write ``tokens``' cached chain to
        the KV object store and free its local pages (only when every
        block was stored). Blocks until the loop thread publishes the
        record (export and eviction are engine work). The next submit of
        the same prefix restores it through a store fetch, on any
        replica."""
        if self.engine.kvstore is None:
            raise RuntimeError(
                "park_session needs the KV object store: start the replica "
                "with kvstore_dir"
            )
        self.scheduler.request_park(tokens, request_id=request_id)
        self._work.set()  # an idle loop must still produce the record
        out = self.scheduler.park_result(timeout=float(wait_s))
        if out is None:
            raise TimeoutError(
                f"park result not produced within {wait_s}s (loop thread "
                "wedged?)"
            )
        return out

    def register_kv_peer(self, idx: int, queue: Any) -> bool:
        """Adopt a new fleet member's KV inbox. False without a fleet KV
        plane."""
        if self.kvfleet is None:
            return False
        self.kvfleet.register_peer(int(idx), queue)
        return True

    def journal_dump(self, n: Optional[int] = None) -> Dict[str, Any]:
        """This replica's workload journal in the wire form (header +
        newest ``n`` entries; all when None). Empty when journaling is
        off."""
        if self.journal is None:
            return {"header": None, "entries": []}
        return self.journal.dump(n)

    # -- observability RPCs ----------------------------------------------
    def trace(self, request_id: str) -> list:
        """One request's recorded spans (oldest first); [] when unknown
        or already rotated out of the ring buffer."""
        return self.tracer.trace(request_id)

    def recent_traces(self, n: int = 8) -> Dict[str, list]:
        return self.tracer.recent_traces(n)

    def trace_dump(self, n: int = 16) -> Dict[str, Any]:
        """This process's trace ring in the stitching wire form (recent
        traces + wall-clock offset)."""
        return self.tracer.dump(n)

    def export_trace(
        self, request_id: Optional[str] = None, n: int = 8
    ) -> Dict[str, Any]:
        """Chrome trace-event JSON (a dict) of one request, or the ``n``
        most recent."""
        from ray_lightning_tpu_torch.obs.trace import to_chrome_trace

        traces = (
            {request_id: self.tracer.trace(request_id)}
            if request_id is not None
            else self.tracer.recent_traces(n)
        )
        return to_chrome_trace(
            {rid: evs for rid, evs in traces.items() if evs}
        )

    def metrics_text(self) -> str:
        """This replica process's registry in Prometheus text format."""
        return self._registry.render()

    def token_digest(self) -> Optional[Dict[str, Any]]:
        """A gang leader's digest of the tokens its engine emitted, to hold
        against each follower's (``ServeShardFollower.token_digest``); None
        outside a gang."""
        return None if self._gang is None else self._gang.log.digest()

    def profile(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        raise NotImplementedError(
            "ServeReplica.profile (a torch.profiler capture) is not ported "
            "yet (ROADMAP queue 1 item 14)"
        )

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.journal is not None:
            self.journal.close()  # flush/close any open spill file
        self._stop.set()
        self._work.set()
        self._thread.join(timeout=5.0)
        if self._gang is not None:
            # After the loop thread's last call: followers drain and exit.
            self._gang.close()
