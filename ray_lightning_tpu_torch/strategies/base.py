"""Strategy: where the train and eval steps run and how state moves
(subset of ``ray_lightning_tpu/strategies/base.py``: the single-process
parts and ``SingleDeviceStrategy``).

The JAX strategy compiles each step into one XLA program. PyTorch runs
eagerly, so here a step is a plain function: the module's loss, the
backward, the optional grad-norm log, then the update of
:class:`~ray_lightning_tpu_torch.trainer.optim.TrainOptimizer`, which
changes the parameter tensors in place. Multi-device strategies (DDP,
ring all-reduce, ZeRO, GSPMD) are ROADMAP queue 1 item 11.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.trainer.optim import TrainOptimizer, global_norm
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.tree import tree_map


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
    ) -> Callable:
        """``step(params, batch, step_idx) -> logs``: loss, backward,
        the optional pre-clip global grad norm, then the update (in place
        on ``params``). The module's generator is reseeded from (seed,
        step) each step, the counterpart of ``fold_in(rng, step)``."""
        prep = self._prep_compute(module)
        generator = torch.Generator(device=self.device)

        def step(params: Any, batch: Any, step_idx: int) -> Dict[str, Any]:
            generator.manual_seed((int(seed) * 2**20 + int(step_idx)) % 2**63)
            p, b = prep(params, batch)
            loss, logs = module.training_step(p, b, generator)
            grads = torch.autograd.grad(loss, optimizer.leaves)
            logs = {k: v.detach() for k, v in dict(logs).items()}
            if log_grad_norm:
                logs["grad_norm"] = global_norm(grads)
            optimizer.step(list(grads))
            logs.setdefault("loss", loss.detach())
            return logs

        return step

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
