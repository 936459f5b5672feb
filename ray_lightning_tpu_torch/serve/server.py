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
conversation there). The multi-host gang (``mesh``, ``dist``,
``gang_queues``: ROADMAP queue 1 item 11b) and the profiler RPC (item 14)
are not ported: their options raise unless left at the JAX defaults.
"""
from __future__ import annotations

import threading
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
#: :func:`build_engine`.
ENGINE_KEYS = frozenset((
    "ckpt_path", "model_config", "params", "int8", "num_slots", "max_seq",
    "prefill_buckets", "decode_fold", "pipeline", "prefill_chunk",
    "prefix_blocks", "prefix_block", "prefix_host_mb", "prefix_disk_dir",
    "prefix_disk_mb", "kv_page", "kv_pages", "spec", "spec_depth",
    "spec_draft_ckpt", "spec_draft_config", "spec_draft_int8",
    "spec_window", "mesh", "piggyback_chunks", "fold_ladder",
))


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
    ``mesh`` other than None or ``"1x1"`` raises (ROADMAP queue 1 item
    11)."""
    from ray_lightning_tpu_torch.serve.engine import DecodeEngine
    from ray_lightning_tpu_torch.serve.kvstore import (
        kvstore_namespace as _kvstore_namespace,
    )

    device = resolve_device(device)
    if mesh not in (None, "1x1"):
        raise NotImplementedError(
            f"build_engine mesh={mesh!r} is not ported yet (ROADMAP queue 1 "
            "item 11b, mesh serving); serve on one card (mesh None or '1x1')"
        )
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
    return DecodeEngine(
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
        device=device,
    )


#: ServeReplica options of the JAX signature that the port does not run
#: yet: name -> (the JAX default, which the port accepts, and the ROADMAP
#: item).
_REPLICA_UNPORTED: Dict[str, Tuple[Any, str]] = {
    "dist": (None, "queue 1 item 11b (multi-host serving gangs)"),
    "gang_queues": (None, "queue 1 item 11b (multi-host serving gangs)"),
}


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
        from ray_lightning_tpu_torch.utils.graphs import capture_stats

        given = locals()
        for name, (default, item) in _REPLICA_UNPORTED.items():
            if given[name] != default:
                raise NotImplementedError(
                    f"ServeReplica option {name}={given[name]!r} is not "
                    f"ported yet (ROADMAP {item})"
                )
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
        self.device = self.engine.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self.device.type == "cuda":
            # The current device is per thread: the loop thread sets it
            # again before its first replay.
            torch.cuda.set_device(self.device)
        self.int8 = bool(int8)
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
            self.engine,
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
                "memory": self.engine.memory_stats(),
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
        queued."""
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
