"""Strategy: where the train and eval steps run, how state moves, and,
for a launched fit, how the workers are planned and joined (the port of
``ray_lightning_tpu/strategies/base.py``).

The JAX strategy compiles each step into one XLA program. Here a step is
a body (:class:`TrainProgram`): the module's loss, the backward, the
strategy's gradient reduction, the optional grad-norm log, then the update
of :class:`~ray_lightning_tpu_torch.trainer.optim.TrainOptimizer`, which
changes the parameter tensors in place; on the card the body is captured
as a CUDA graph and replayed, collectives included.

A strategy has two sides, as in the JAX package:

- the driver plans the worker actors (:meth:`Strategy.plan_workers`:
  count, resources, env) and picks the launcher
  (:meth:`Strategy._configure_launcher`);
- each worker joins the process group (:meth:`Strategy.setup_worker`:
  ``torch.distributed.init_process_group``, the reference's
  ``ray_ddp.py:192-196``), then places state and builds the steps.

One process per card, as in the reference (``ray_ddp.py``): a worker owns
one whole card (``num_gpus=1``, so it sees ``cuda:0``), its sampler shard
is its rank's (:meth:`Strategy.sampler_kwargs`) and ``batch_multiplier``
is 1. The JAX package runs one process per host driving several chips and
shards a host batch over them; the update is the same for any split,
because the data-parallel gradient is the mean over the global batch and
the sampler hands the ranks of a step the same set of rows as the JAX
host batch of that step (rank ``r`` takes every ``world``-th row from
``r``). Ranks average their gradients with collectives in the step
(:meth:`Strategy.reduce_grads`), average their logs
(:meth:`Strategy.reduce_logs`) and sum eval's ``(sums, count)``.

The groups: NCCL when each rank owns a whole card, and then every step is
a graph; gloo on the CPU, or when ranks share a card (``resources_per_
worker={"GPU": 0.5}``, the reference's fractional GPUs), and then steps
run eagerly, since gloo's collectives cannot be captured. Both backends
run the same collective sequence: SUM then a divide (gloo has no
``AVG``), all-reduce then a slice (gloo has no ``reduce_scatter``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.parallel.env import DistEnv
from ray_lightning_tpu_torch.trainer.optim import TrainOptimizer, global_norm
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.graphs import Program, pinned_copy
from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map


def not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP queue 1 item {item})"
    )


def to_host(tree: Any) -> Any:
    """A detached CPU copy of a tree (what checkpoints and the module
    keep)."""
    return tree_map(
        lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x,
        tree,
    )


@dataclass
class WorkerPlan:
    """Placement request for one worker actor."""

    host_rank: int
    resources: Dict[str, float]
    env: Dict[str, str]
    num_cpus: float = 1.0
    num_gpus: float = 0.0


class Strategy:
    """Base distributed strategy: data parallelism over launched workers,
    one per card (see the module docstring).

    Args mirror the JAX package's (``strategies/base.py:41``), with
    ``use_gpu`` in place of ``use_tpu``:
      num_workers: data-parallel ranks, one worker process and card each.
      num_cpus_per_worker: CPUs reserved per worker actor.
      use_gpu: True (the default) trains on the cards, False on the CPU
        over gloo. There is no "auto": a request for cards the fabric
        lacks fails at placement.
      num_hosts: worker processes; must divide ``num_workers``, and
        anything but one process per card raises (ROADMAP item 11b).
      init_hook: callable run once on each worker after spawn, before
        the fit (``ray_launcher.py:79-83``).
      resources_per_worker: extra logical resources per actor; ``"GPU"``
        below 1 shares a card between ranks (gloo, eager).
    """

    strategy_name = "base"
    #: Whether :meth:`gather_state` and the optimizer's gathered state are
    #: collectives every rank must enter (the sharded strategy's are).
    gather_is_collective = False

    def __init__(
        self,
        num_workers: int = 1,
        num_cpus_per_worker: float = 1,
        use_gpu: bool = True,
        num_hosts: Optional[int] = None,
        init_hook: Optional[Callable[[], None]] = None,
        resources_per_worker: Optional[Dict[str, float]] = None,
    ) -> None:
        if int(num_workers) < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = int(num_workers)
        self.num_cpus_per_worker = num_cpus_per_worker
        self.use_gpu = bool(use_gpu)
        self._num_hosts = num_hosts
        self.init_hook = init_hook
        self.resources_per_worker = dict(resources_per_worker or {})
        gpus = self.resources_per_worker.get("GPU")
        if gpus is not None and not self.use_gpu:
            raise ValueError(
                "resources_per_worker asks for GPU with use_gpu=False")
        if gpus is not None and float(gpus) > 1:
            raise not_ported(
                f"several cards per worker process (GPU={gpus})", "11b")
        if gpus is not None and float(gpus) <= 0:
            raise ValueError(f"resources_per_worker GPU must be > 0, got {gpus}")
        # Worker-side state (set in setup_worker).
        self.device: Optional[torch.device] = None
        self.dist_env: Optional[DistEnv] = None
        self._is_remote = False
        self._module: Any = None
        self._mesh: Any = None

    # ------------------------------------------------------------------
    # Driver side
    # ------------------------------------------------------------------
    @property
    def gpu_share(self) -> float:
        """The share of a card each worker gets (0 on the CPU)."""
        if not self.use_gpu:
            return 0.0
        return float(self.resources_per_worker.get("GPU", 1.0))

    @property
    def backend(self) -> str:
        """The group's ``torch.distributed`` backend: NCCL when each rank
        owns a whole card, gloo on the CPU or on shared cards."""
        return "nccl" if self.gpu_share >= 1.0 else "gloo"

    def _resolve_num_hosts(self) -> int:
        if self._num_hosts is not None:
            if self.num_workers % int(self._num_hosts):
                raise ValueError(
                    f"num_workers={self.num_workers} not divisible by "
                    f"num_hosts={self._num_hosts}"
                )
            if int(self._num_hosts) != self.num_workers:
                raise not_ported(
                    f"several cards per worker process (num_workers="
                    f"{self.num_workers} over num_hosts={self._num_hosts})",
                    "11b")
        return self.num_workers

    def plan_workers(self) -> Tuple[List[WorkerPlan], bool]:
        """Compute actor placements: one per rank. Returns (plans,
        use_gpu)."""
        import os

        from ray_lightning_tpu_torch.utils.rank_zero import rank_zero_warn

        share = self.gpu_share
        if self.use_gpu and share != int(share):
            # The reference's fractional GPUs (ray_ddp.py:84-100).
            rank_zero_warn(
                f"requesting a fractional GPU per worker (GPU={share}): "
                "ranks share a card and contend for it; use whole cards "
                "for speed"
            )
            rank_zero_warn(
                "ranks that share a card join over gloo and train "
                "eagerly: gloo's collectives cannot be captured in a CUDA "
                "graph"
            )
        num_hosts = self._resolve_num_hosts()
        plans: List[WorkerPlan] = []
        for host_rank in range(num_hosts):
            resources = {k: float(v) for k, v in
                         self.resources_per_worker.items() if k != "GPU"}
            env: Dict[str, str] = {}
            if not self.use_gpu:
                env["CUDA_VISIBLE_DEVICES"] = ""  # a CPU worker sees no card
            if "OMP_NUM_THREADS" not in os.environ:
                # Ray's default for its workers: threads = reserved CPUs.
                env["OMP_NUM_THREADS"] = str(
                    max(1, int(self.num_cpus_per_worker)))
            plans.append(WorkerPlan(
                host_rank=host_rank, resources=resources, env=env,
                num_cpus=self.num_cpus_per_worker, num_gpus=share,
            ))
        return plans, self.use_gpu

    def _configure_launcher(self, trainer: Any) -> Any:
        from ray_lightning_tpu_torch.launchers.gpu_launcher import GPULauncher

        return GPULauncher(self, trainer)

    # Rank properties, valid on the driver before launch (the reference's
    # fallbacks, ray_horovod.py:110-141) and in workers after setup_worker.
    @property
    def world_size(self) -> int:
        return self.num_workers

    @property
    def global_rank(self) -> int:
        return self.dist_env.host_rank if self.dist_env else 0

    @property
    def local_rank(self) -> int:
        return self.dist_env.local_rank if self.dist_env else 0

    @property
    def node_rank(self) -> int:
        return self.dist_env.node_rank if self.dist_env else 0

    def set_remote(self, remote: bool) -> None:
        self._is_remote = remote

    # ------------------------------------------------------------------
    # Worker side
    # ------------------------------------------------------------------
    def setup_worker(self, dist_env: DistEnv) -> None:
        """Join the process group; called once inside each worker. A
        collective runs once here: a group must have run one before a
        CUDA graph can capture its collectives."""
        import torch.distributed as dist

        from ray_lightning_tpu_torch.parallel.mesh import setup_distributed
        from ray_lightning_tpu_torch.utils.rank_zero import rank_zero_only

        self.dist_env = dist_env
        self._is_remote = True
        rank_zero_only.rank = dist_env.global_rank
        if self.use_gpu:
            self.device = resolve_device("cuda:0")
            torch.cuda.set_device(self.device)
        else:
            self.device = torch.device("cpu")
        setup_distributed(dist_env)
        warm = torch.ones(1, device=self.device)
        dist.all_reduce(warm)
        if float(warm) != float(dist_env.world_size):
            raise RuntimeError(
                f"the warm-up all-reduce gave {float(warm)}, expected "
                f"{dist_env.world_size}")

    def bind_module(self, module: Any) -> None:
        """Give the strategy the user module before state placement."""
        self._module = module

    @property
    def mesh(self) -> Any:
        """The group as a 1-D ``DeviceMesh`` named ``"data"`` (built on
        first use)."""
        if self._mesh is None:
            from ray_lightning_tpu_torch.parallel.mesh import build_mesh

            self._mesh = build_mesh(self.device)
        return self._mesh

    @property
    def grouped(self) -> bool:
        """Whether this process is a rank of a launched group."""
        return self.dist_env is not None

    @property
    def capture_graphs(self) -> bool:
        """Whether the steps may be captured as CUDA graphs: not over
        gloo, whose collectives cannot be captured."""
        return not (self.grouped and self.dist_env.backend == "gloo")

    def teardown_worker(self) -> None:
        from ray_lightning_tpu_torch.parallel.mesh import teardown_distributed

        if self.grouped:
            teardown_distributed()

    # -- collectives ----------------------------------------------------
    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The data-parallel gradient: the mean over ranks, as ONE
        coalesced all-reduce per dtype of the flattened gradients, then a
        divide by the world size (the single fused all-reduce XLA inserts
        into the JAX step). The identity outside a group."""
        if not self.grouped:
            return grads
        import torch.distributed as dist

        world = float(self.dist_env.world_size)
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault(g.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([grads[i].reshape(-1) for i in idx])
            dist.all_reduce(flat)
            flat.div_(world)
            for i, piece in zip(idx, flat.split([grads[i].numel()
                                                 for i in idx])):
                out[i] = piece.view_as(grads[i])
        return out  # type: ignore[return-value]

    def reduce_logs(self, logs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """The step's logs averaged over ranks (one all-reduce of the
        stacked fp32 values). Outside a group: as given."""
        if not self.grouped or not logs:
            return logs
        import torch.distributed as dist

        vals = torch.stack([torch.as_tensor(v).float().reshape(())
                            for v in logs.values()])
        dist.all_reduce(vals)
        vals.div_(float(self.dist_env.world_size))
        return dict(zip(logs.keys(), vals.unbind(0)))

    def reduce_eval(self, sums: Dict[str, torch.Tensor],
                    count: float) -> Tuple[Dict[str, torch.Tensor], float]:
        """Eval's per-key sums and real-row count summed over ranks (one
        all-reduce). Outside a group: as given."""
        if not self.grouped:
            return sums, count
        import torch.distributed as dist

        vals = torch.stack(
            [torch.tensor(float(count), device=self.device)]
            + [v.float().reshape(()).to(self.device) for v in sums.values()])
        dist.all_reduce(vals)
        return dict(zip(sums.keys(), vals[1:].unbind(0))), float(vals[0])

    def any_rank(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a MAX
        all-reduce: the JAX loop's ``process_allgather`` consensus)."""
        if not self.grouped or self.dist_env.world_size == 1:
            return bool(flag)
        import torch.distributed as dist

        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item() > 0)

    def barrier(self, name: str = "barrier") -> None:
        """Block until every rank reaches this point."""
        if self.grouped and self.dist_env.world_size > 1:
            import torch.distributed as dist

            dist.barrier()

    def gather_predictions(self, out: Any, mask: np.ndarray) -> Tuple[Any, np.ndarray]:
        """Every rank's predictions and masks for one step, concatenated
        in rank order (the global batch, as the JAX package's replicated
        predict output holds it). Outside a group: as given."""
        if not self.grouped or self.dist_env.world_size == 1:
            return out, mask
        import torch.distributed as dist

        parts: List[Any] = [None] * self.dist_env.world_size
        dist.all_gather_object(parts, (to_host(out), np.asarray(mask)))

        def merge(trees: list) -> Any:
            head = trees[0]
            if isinstance(head, dict):
                return {k: merge([t[k] for t in trees]) for k in head}
            if isinstance(head, (list, tuple)):
                return type(head)(merge([t[i] for t in trees])
                                  for i in range(len(head)))
            return torch.cat(trees, 0)

        return (merge([p[0] for p in parts]),
                np.concatenate([p[1] for p in parts]))

    # -- layout --------------------------------------------------------
    @property
    def batch_multiplier(self) -> int:
        """Cards this process feeds: 1 (one process per card)."""
        return 1

    def sampler_kwargs(self) -> Dict[str, int]:
        """The sampler shard of this rank (the reference's per-worker
        sampler, ``ray_ddp.py:315-324``)."""
        env = self.dist_env
        if env is None:
            return {"num_replicas": 1, "rank": 0}
        return {"num_replicas": env.world_size, "rank": env.host_rank}

    # -- precision -----------------------------------------------------
    @staticmethod
    def _compute_dtype(module: Any) -> Optional[torch.dtype]:
        """Trainer-level mixed precision: params stay fp32 masters and the
        step sees params AND batch cast to bfloat16; grads come back fp32
        through the cast. fp16 requests map to bf16 too, as in the JAX
        package (no loss scaling). Not ``torch.autocast``: it keeps some
        ops in fp32, so the step would compute something else than the
        JAX package's."""
        p = str(getattr(module, "precision", "fp32") or "fp32").lower()
        if p in ("fp32", "32", "32-true", "float32"):
            return None
        if p in ("bf16", "bf16-mixed", "bfloat16", "16", "16-mixed",
                 "fp16", "float16"):
            return torch.bfloat16
        if p in ("bf16-true", "16-true"):
            raise ValueError(
                f"precision {p!r} (true half) is not a trainer-level option; "
                "use 'bf16-mixed', or store low-precision params in the "
                "module itself"
            )
        raise ValueError(f"unsupported precision {p!r}")

    def _prep_compute(self, module: Any) -> Callable:
        """``prep(params, batch) -> (params, batch)`` with the trainer's
        mixed-precision cast (a no-op for fp32)."""
        cdt = self._compute_dtype(module)
        if cdt is None:
            return lambda params, batch: (params, batch)
        cast = self._cast_floating
        return lambda params, batch: (cast(params, cdt), cast(batch, cdt))

    @staticmethod
    def _cast_floating(tree: Any, dtype: torch.dtype) -> Any:
        return tree_map(
            lambda x: x.to(dtype) if torch.is_floating_point(x) else x, tree
        )

    # -- state movement ------------------------------------------------
    def place_batch(self, batch: Any) -> Any:
        """A host batch (numpy leaves) as tensors on the device."""
        return tree_map(
            lambda x: torch.as_tensor(np.asarray(x)).to(self.device), batch
        )

    def place_params(self, params: Any) -> Any:
        """The parameter tree as trainable fp32-or-as-given leaf tensors on
        the device (copies: the loop owns them). In a group, rank 0's
        values are broadcast, so every rank starts from the same tree
        whatever its own initializer drew."""
        placed = tree_map(
            lambda x: torch.as_tensor(x)
            .detach()
            .to(self.device, copy=True),
            params,
        )
        if self.grouped and self.dist_env.world_size > 1:
            import torch.distributed as dist

            for leaf in tree_leaves(placed):
                dist.broadcast(leaf, src=0)
        return tree_map(lambda x: x.requires_grad_(True), placed)

    def gather_state(self, tree: Any) -> Any:
        """The full tree as a detached CPU copy (what checkpoints and the
        module keep)."""
        return to_host(tree)

    # -- steps ---------------------------------------------------------
    def make_optimizer(
        self,
        factory: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
        leaves: List[torch.Tensor],
        lr_schedule: Optional[Callable[[int], float]],
        clip: Optional[float],
        accumulate: int,
    ) -> TrainOptimizer:
        """The update rule over the parameter leaves (the sharded strategy
        gives the module's optimizer slices instead)."""
        return TrainOptimizer(factory, leaves, lr_schedule, clip=clip,
                              accumulate=accumulate)

    def compile_train_step(
        self,
        module: Any,
        optimizer: TrainOptimizer,
        seed: int,
        log_grad_norm: bool = False,
        fold_steps: int = 1,
    ) -> "TrainProgram":
        """The training program of ``fold_steps`` = K steps per dispatch
        (:class:`TrainProgram`): ``step(params, host_batches, start_step)
        -> logs`` with each log a (K,) tensor."""
        return TrainProgram(self, module, optimizer, seed, log_grad_norm,
                            fold_steps)

    def compile_eval_step(self, module: Any, stage: str) -> Callable:
        """The eval program of a stage.

        predict: ``(params, batch, mask) -> (preds, mask)``.

        val/test: ``(params, batch, mask) -> (sums, count)``, with ``sums``
        the per-key metric totals over the REAL rows only and ``count`` the
        real rows. The JAX package vmaps the step over singleton batches
        and weights by the mask; ``torch.func.vmap`` cannot go through a
        ctypes kernel, so the step runs on each real row as a batch of one
        (padding rows are skipped). A module whose metrics are not
        per-sample means sets ``supports_per_sample_eval = False`` and is
        evaluated on the whole batch, weighted by its real rows.
        """
        prep = self._prep_compute(module)

        if stage == "predict":

            @torch.no_grad()
            def pstep(params, batch, mask):
                params, batch = prep(params, batch)
                return module.predict_step(params, batch), mask

            return pstep

        fn = (
            module.validation_step
            if stage in ("val", "validate")
            else module.test_step
        )
        per_sample = getattr(module, "supports_per_sample_eval", True)

        grouped = self.grouped

        @torch.no_grad()
        def estep(params, batch, mask) -> Tuple[Dict[str, torch.Tensor], float]:
            params, batch = prep(params, batch)
            mask = np.asarray(mask, dtype=bool)
            count = float(mask.sum())
            if not per_sample:
                logs = dict(fn(params, batch))
                return self.reduce_eval(
                    {k: torch.as_tensor(v).float() * count
                     for k, v in logs.items()}, count)
            sums: Dict[str, torch.Tensor] = {}
            for i in np.nonzero(mask)[0]:
                one = tree_map(lambda x: x[i : i + 1], batch)
                for k, v in dict(fn(params, one)).items():
                    v = torch.as_tensor(v).float().reshape(())
                    sums[k] = sums[k] + v if k in sums else v
            if grouped and not sums:
                # A rank whose rows are all padding still enters the
                # collective with every key: zero sums from one row.
                one = tree_map(lambda x: x[:1], batch)
                sums = {k: torch.zeros((), device=self.device)
                        for k in dict(fn(params, one))}
            return self.reduce_eval(sums, count)

        return estep


class SingleDeviceStrategy(Strategy):
    """The in-process strategy ``Trainer`` uses when it is given none: one
    device, no launcher, no process group (the JAX package's
    ``SingleDeviceStrategy``, ``strategies/base.py:697``, at one
    device)."""

    strategy_name = "single_device"

    def __init__(self, device: Union[str, torch.device] = "cuda") -> None:
        dev = resolve_device(device)
        super().__init__(num_workers=1, use_gpu=dev.type == "cuda")
        self.device = dev


def _stack(trees: list) -> Any:
    """Host batches of one structure as one batch of stacked numpy
    leaves (K, ...)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])


class TrainProgram:
    """K training steps per dispatch (the JAX loop's
    ``steps_per_execution``; K = 1 is the single-step program).

    ``program(params, host_batches, start_step)`` takes K host batches,
    stages them as one stacked (K, ...) copy into fixed device buffers and
    runs K steps: each the module's loss on its batch, the backward, the
    optional pre-clip global grad norm, and the optimizer's work at the
    micro-batch's planned window position (:meth:`TrainOptimizer.take`,
    the learning rate read from a device buffer). Returns the logs as (K,)
    tensors (no sync).

    On the card each distinct plan of window positions (one, or a few
    under accumulation) is captured at its first call: the body runs for
    real on the capture stream, which warms the kernels up, then is
    recorded; later calls replay it. A capture that fails raises. When the
    optimizer's step is graph-safe (:attr:`TrainOptimizer.step_in_graph`:
    ``torch.optim``'s capturable optimizers, SGD at a constant lr) one
    graph holds all K steps; otherwise each step's forward and backward is
    a graph of its own and the optimizer steps between the replays. The
    module's generator of step k of the dispatch is reseeded from (seed,
    step) before each call, the counterpart of ``fold_in(rng, step)``; it
    is registered with the graphs, so a replay draws from the seed it
    holds then. Elsewhere, or with ``_graphs=False`` (private: the eager
    baseline), the same bodies run directly."""

    def __init__(self, strategy: Strategy, module: Any,
                 optimizer: TrainOptimizer, seed: int, log_grad_norm: bool,
                 fold: int, _graphs: bool = True) -> None:
        self.device = strategy.device
        self.strategy = strategy
        self.module = module
        self.optimizer = optimizer
        self.seed = int(seed)
        self.log_grad_norm = bool(log_grad_norm)
        self.K = int(fold)
        self.prep = strategy._prep_compute(module)
        self.capture = (bool(_graphs) and self.device.type == "cuda"
                        and strategy.capture_graphs)
        self.generators = [torch.Generator(device=self.device)
                           for _ in range(self.K)]
        self.lrs = torch.zeros(self.K, dtype=torch.float32, device=self.device)
        # The steps each program holds: all K, or one each.
        self.segments = ([tuple(range(self.K))] if optimizer.step_in_graph
                         else [(k,) for k in range(self.K)])
        self.batch: Any = None  # (K, ...) device buffers
        self.out: Dict[str, torch.Tensor] = {}
        self.programs: Dict[tuple, List[Program]] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None

    @property
    def compiled_count(self) -> int:
        """Graphs captured so far (per plan of window positions, one per
        segment)."""
        return sum(p.graph is not None for progs in self.programs.values()
                   for p in progs)

    def _stage(self, host_batches: list) -> None:
        host = tree_map(torch.as_tensor, _stack(host_batches))
        if self.batch is None:
            self.batch = tree_map(
                lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      device=self.device), host)
        for dst, src in zip(tree_leaves(self.batch), tree_leaves(host)):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"batch of shape {tuple(src.shape[1:])} {src.dtype} after "
                    f"{tuple(dst.shape[1:])} {dst.dtype}: a training program "
                    "takes batches of one shape"
                )
            pinned_copy(dst, src)

    def _body(self, params: Any, plan: tuple, steps: tuple) -> Callable:
        leaves = self.optimizer.leaves
        strategy = self.strategy

        def body() -> None:
            for k in steps:
                pos, updates = plan[k]
                batch = tree_map(lambda x: x[k], self.batch)
                self.optimizer.gather_params()
                p, b = self.prep(params, batch)
                # ZeRO-3: the full leaves the forward reads only through
                # their cast copies go before the forward, the rest after
                # the backward.
                self.optimizer.release_params(tree_leaves(p))
                loss, logs = self.module.training_step(p, b,
                                                       self.generators[k])
                grads = torch.autograd.grad(loss, leaves)
                self.optimizer.release_params()
                # The strategy's reduction: the mean over ranks (the
                # identity on one device).
                grads = strategy.reduce_grads(list(grads))
                logs = {name: v.detach() for name, v in dict(logs).items()}
                logs.setdefault("loss", loss.detach())
                logs = strategy.reduce_logs(logs)
                if self.log_grad_norm:
                    # Of the reduced gradients: the same on every rank.
                    logs["grad_norm"] = global_norm(grads)
                self.optimizer.take(grads, pos, updates, self.lrs[k])
                for name, v in logs.items():
                    if name not in self.out:  # a warm-up run, before capture
                        self.out[name] = torch.zeros(
                            self.K, dtype=torch.float32, device=self.device)
                    self.out[name][k].copy_(
                        torch.as_tensor(v).float().reshape(()))

        return body

    def __call__(self, params: Any, host_batches: list,
                 start_step: int) -> Dict[str, torch.Tensor]:
        if len(host_batches) != self.K:
            raise ValueError(
                f"a {self.K}-step program got {len(host_batches)} batches")
        plan = tuple(self.optimizer.plan(self.K))
        lrs = self.optimizer.lrs(list(plan))
        self._stage(host_batches)
        pinned_copy(self.lrs, torch.tensor(lrs, dtype=torch.float32))
        for k, g in enumerate(self.generators):
            g.manual_seed((self.seed * 2**20 + int(start_step) + k) % 2**63)
        progs = self.programs.get(plan)
        new = progs is None
        if new:
            progs = self.programs[plan] = [
                Program(self._body(params, plan, steps))
                for steps in self.segments]
        for steps, prog in zip(self.segments, progs):
            if new and self.capture:
                prog.warm_up()
                prog.capture(self.pool,
                             tuple(self.generators[k] for k in steps))
            else:
                prog()
            if not self.optimizer.step_in_graph:
                for k in steps:
                    if plan[k][1]:
                        self.optimizer.update(lrs[k])
        self.optimizer.commit(list(plan))
        return {name: v.clone() for name, v in self.out.items()}
