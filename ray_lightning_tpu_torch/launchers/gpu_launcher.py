"""``GPULauncher``: create the worker actors, join them into one process
group, run the stage and recover rank 0's results (the port of
``ray_lightning_tpu/launchers/tpu_launcher.py``, after the reference's
``RayLauncher``, ``launchers/ray_launcher.py:27-379``).

Launch sequence:
  1. ``setup_workers``: spawn one actor per rank with its resources and
     env (a whole card each, or a share of one), run ``init_hook`` once
     on each (``ray_launcher.py:79-83``), broadcast the seed.
  2. The coordinator: worker 0's node IP and a free port on that node, for
     any world above 1 (``ray_launcher.py:85-87``); a group of one
     rendezvous on a port of its own.
  3. ``get_local_ranks``: global -> (local, node) rank from the actors'
     node IPs (``ray_launcher.py:130-157``).
  4. Ship ``(module, spec, strategy, datamodule)`` once with
     ``fabric.put`` (and a checkpoint to resume, as a ref of its own),
     run :func:`_worker_entry` on every actor and drive
     :func:`~ray_lightning_tpu_torch.launchers.utils.process_results`.
  5. Return rank 0's ``WorkerOutput``; kill the actors.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.launchers.utils import (
    WorkerOutput,
    get_executable_cls,
    process_results,
)
from ray_lightning_tpu_torch.parallel.env import DistEnv
from ray_lightning_tpu_torch.utils.seed import GLOBAL_SEED_ENV


def _worker_entry(
    spec_ref: Any,
    host_rank: int,
    dist_env: DistEnv,
    stage: str,
    ckpt_ref: Any,
    queue: Any,
) -> Optional[WorkerOutput]:
    """Runs inside each actor: join the group, rebuild the loop and run
    the stage (``_wrapping_function``, ``ray_launcher.py:252-310``).
    Returns rank 0's ``WorkerOutput`` (None on the other ranks)."""
    from ray_lightning_tpu_torch.trainer.loop import TrainingLoop

    module, spec, strategy, datamodule = fabric.get(spec_ref)
    ckpt_stream = None if ckpt_ref is None else fabric.get(ckpt_ref)
    strategy.set_remote(True)
    strategy.setup_worker(dist_env)
    try:
        loop = TrainingLoop(spec, module, strategy, datamodule=datamodule)
        if stage == "fit":
            loop.run_fit(ckpt_stream)
            results = None
        elif stage in ("validate", "test"):
            results = loop.run_evaluate(stage, ckpt_stream)
        elif stage == "predict":
            results = loop.run_predict(ckpt_stream)
        else:
            raise ValueError(f"unknown stage {stage}")
        output = loop.collect_rank_zero_results(results)
    finally:
        strategy.teardown_worker()
    return output


class GPULauncher:
    def __init__(self, strategy: Any, trainer: Any) -> None:
        self._strategy = strategy
        self._trainer = trainer
        self._workers: List[Any] = []
        #: The worker-to-driver queue (the tune session's, ROADMAP queue 1
        #: item 14); None until then.
        self.tune_queue: Any = None

    # ------------------------------------------------------------------
    def launch(
        self,
        stage: str,
        module: Any,
        datamodule: Any = None,
        ckpt_stream: Optional[bytes] = None,
    ) -> Optional[WorkerOutput]:
        if not fabric.is_initialized():
            fabric.init()
        plans, _use_gpu = self._strategy.plan_workers()
        try:
            self.setup_workers(plans)
            dist_envs = self._build_dist_envs(plans)
            return self.run_function_on_workers(
                stage, module, datamodule, ckpt_stream, dist_envs)
        finally:
            self.teardown_workers()

    # ------------------------------------------------------------------
    def setup_workers(self, plans: List[Any]) -> None:
        from ray_lightning_tpu_torch.obs.events import get_event_log

        worker_cls = get_executable_cls()
        t0 = time.monotonic()
        for plan in plans:
            # Spawned together (each boots its interpreter and imports
            # torch), then one readiness barrier: a constructor that
            # failed raises there.
            opts: Dict[str, Any] = dict(num_cpus=plan.num_cpus,
                                        resources=plan.resources,
                                        env=plan.env, lazy_init=True)
            if plan.num_gpus:
                opts["num_gpus"] = plan.num_gpus
            self._workers.append(
                fabric.remote(worker_cls).options(**opts).remote())
        fabric.get([w.get_node_id.remote() for w in self._workers])
        #: Seconds from the first spawn until every worker answered.
        self.spawn_s = time.monotonic() - t0
        get_event_log().record("launcher", "workers_ready",
                               workers=len(self._workers),
                               seconds=self.spawn_s)
        if self._strategy.init_hook:
            fabric.get([w.execute.remote(self._strategy.init_hook)
                        for w in self._workers])
        # Seed broadcast (PL_GLOBAL_SEED, ray_launcher.py:169-172).
        seed = os.environ.get(GLOBAL_SEED_ENV)
        if seed is not None:
            fabric.get([w.set_env_var.remote(GLOBAL_SEED_ENV, seed)
                        for w in self._workers])

    def _build_dist_envs(self, plans: List[Any]) -> List[DistEnv]:
        world = len(plans)
        coordinator = None
        if world > 1:
            # The store lives in rank 0: its node, not the driver's.
            ip = fabric.get(self._workers[0].get_node_ip.remote())
            port = fabric.get(self._workers[0].find_free_port.remote())
            coordinator = f"{ip}:{port}"
        global_to_local = self.get_local_ranks()
        backend = self._strategy.backend
        return [
            DistEnv(
                world_size=world,
                num_hosts=world,
                host_rank=rank,
                node_rank=global_to_local[rank][1],
                local_chips=1,
                coordinator_address=coordinator,
                first_chip_rank=rank,
                global_to_local=global_to_local,
                backend=backend,
            )
            for rank in range(world)
        ]

    def get_local_ranks(self) -> Dict[int, Tuple[int, int]]:
        """global rank -> (local rank, node rank) from the actors' node IPs
        (the reference's algorithm, ``ray_launcher.py:130-157``)."""
        node_ips = fabric.get([w.get_node_ip.remote() for w in self._workers])
        rank_map: Dict[int, Tuple[int, int]] = {}
        node_order: List[str] = []
        per_node: Dict[str, int] = defaultdict(int)
        for global_rank, ip in enumerate(node_ips):
            if ip not in node_order:
                node_order.append(ip)
            rank_map[global_rank] = (per_node[ip], node_order.index(ip))
            per_node[ip] += 1
        return rank_map

    # ------------------------------------------------------------------
    def run_function_on_workers(
        self,
        stage: str,
        module: Any,
        datamodule: Any,
        ckpt_stream: Optional[bytes],
        dist_envs: List[DistEnv],
    ) -> Optional[WorkerOutput]:
        spec = self._trainer._make_spec()
        # One upload shared by every worker, without the driver trainer's
        # back-reference (ray_launcher.py:232-247).
        module.trainer = None
        refs = [fabric.put((module, spec, self._strategy, datamodule))]
        # A checkpoint travels through the object store too.
        if ckpt_stream is not None:
            refs.append(fabric.put(ckpt_stream))
        try:
            futures = [
                w.execute.remote(_worker_entry, refs[0], rank,
                                 dist_envs[rank], stage,
                                 refs[1] if len(refs) > 1 else None,
                                 self.tune_queue)
                for rank, w in enumerate(self._workers)
            ]
            results = process_results(futures, self.tune_queue)
        finally:
            module.trainer = self._trainer
            fabric.free(refs)
        return results[0]

    # ------------------------------------------------------------------
    def teardown_workers(self) -> None:
        for worker in self._workers:
            try:
                fabric.kill(worker)
            except Exception:  # noqa: BLE001 - best effort
                pass
        self._workers = []
