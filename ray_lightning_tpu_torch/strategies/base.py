"""Strategy: where the train and eval steps run and how state moves
(subset of ``ray_lightning_tpu/strategies/base.py``: the single-process
parts and ``SingleDeviceStrategy``).

The JAX strategy compiles each step into one XLA program. Here a step is
a body (:class:`TrainProgram`): the module's loss, the backward, the
optional grad-norm log, then the update of
:class:`~ray_lightning_tpu_torch.trainer.optim.TrainOptimizer`, which
changes the parameter tensors in place; on the card the body is captured
as a CUDA graph and replayed. Multi-device strategies (DDP,
ring all-reduce, ZeRO, GSPMD) are ROADMAP queue 1 item 11.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.trainer.optim import TrainOptimizer, global_norm
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.graphs import Program, pinned_copy
from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map


class Strategy:
    """Base strategy: one process, one device."""

    strategy_name = "base"

    def __init__(self, device: Union[str, torch.device] = "cuda") -> None:
        self.device = resolve_device(device)

    # -- layout --------------------------------------------------------
    @property
    def batch_multiplier(self) -> int:
        """Devices this process feeds: host batch = batch_size * this."""
        return 1

    def sampler_kwargs(self) -> Dict[str, int]:
        return {"num_replicas": 1, "rank": 0}

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
        the device (copies: the loop owns them)."""
        return tree_map(
            lambda x: torch.as_tensor(x)
            .detach()
            .to(self.device, copy=True)
            .requires_grad_(True),
            params,
        )

    @staticmethod
    def gather_state(tree: Any) -> Any:
        """A detached CPU copy of a tree (what checkpoints and the module
        keep)."""
        return tree_map(
            lambda x: x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x,
            tree,
        )

    # -- steps ---------------------------------------------------------
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

        @torch.no_grad()
        def estep(params, batch, mask) -> Tuple[Dict[str, torch.Tensor], float]:
            params, batch = prep(params, batch)
            mask = np.asarray(mask, dtype=bool)
            count = float(mask.sum())
            if not per_sample:
                logs = dict(fn(params, batch))
                return {k: torch.as_tensor(v).float() * count for k, v in logs.items()}, count
            sums: Dict[str, torch.Tensor] = {}
            for i in np.nonzero(mask)[0]:
                one = tree_map(lambda x: x[i : i + 1], batch)
                for k, v in dict(fn(params, one)).items():
                    v = torch.as_tensor(v).float().reshape(())
                    sums[k] = sums[k] + v if k in sums else v
            return sums, count

        return estep


class SingleDeviceStrategy(Strategy):
    """The in-process strategy ``Trainer`` uses when it is given none: one
    device, no launcher (the JAX package's ``SingleDeviceStrategy``,
    ``strategies/base.py:697``, at one device)."""

    strategy_name = "single_device"


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
        self.module = module
        self.optimizer = optimizer
        self.seed = int(seed)
        self.log_grad_norm = bool(log_grad_norm)
        self.K = int(fold)
        self.prep = strategy._prep_compute(module)
        self.capture = bool(_graphs) and self.device.type == "cuda"
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

        def body() -> None:
            for k in steps:
                pos, updates = plan[k]
                batch = tree_map(lambda x: x[k], self.batch)
                p, b = self.prep(params, batch)
                loss, logs = self.module.training_step(p, b,
                                                       self.generators[k])
                grads = torch.autograd.grad(loss, leaves)
                logs = {name: v.detach() for name, v in dict(logs).items()}
                if self.log_grad_norm:
                    logs["grad_norm"] = global_norm(grads)
                self.optimizer.take(list(grads), pos, updates, self.lrs[k])
                logs.setdefault("loss", loss.detach())
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
