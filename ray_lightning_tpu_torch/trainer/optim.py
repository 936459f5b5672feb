"""The optimizer update around a module's ``torch.optim`` optimizer, with
the JAX trainer's optax semantics, and the learning-rate schedule GPTLM
declares.

``TrainOptimizer`` is the counterpart of the optax chain the JAX loop
builds (``ray_lightning_tpu/trainer/loop.py:409``):
``MultiSteps(chain(clip_by_global_norm, module_tx))``.

- Accumulation (``optax.MultiSteps``): the buffer holds the running MEAN
  of the micro-batch gradients, ``acc += (g - acc) / (mini_step + 1)``;
  the K-th micro-batch applies one update from it. ``flush`` applies a
  partial window (the epoch-end flush).
- Clipping (``optax.clip_by_global_norm``): when the global norm is not
  below the limit, every gradient is scaled as ``g / norm * limit``, with
  no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
- The schedule (optax embeds it in the transform): each update sets every
  group's ``lr`` to ``schedule(update_count)``, 0-based.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import torch


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(
            "The cosine_decay_schedule requires positive decay_steps, got "
            f"decay_steps={cos_steps}."
        )

    def schedule(count: int) -> float:
        count = float(count)
        if warmup_steps > 0 and count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, float(cos_steps))
        decayed = (1 - alpha) * (0.5 * (1 + math.cos(math.pi * t / cos_steps))) ** exponent + alpha
        return peak_value * decayed

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the 2-norm of all leaves together, fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class TrainOptimizer:
    """One update rule over the parameter leaves: accumulation, clipping,
    the schedule, then the module's optimizer."""

    def __init__(
        self,
        factory: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
        leaves: List[torch.Tensor],
        lr_schedule: Optional[Callable[[int], float]] = None,
        clip: Optional[float] = None,
        accumulate: int = 1,
    ) -> None:
        self.leaves = leaves
        self.opt = factory(leaves)
        self.lr_schedule = lr_schedule
        self.clip = float(clip) if clip else None
        self.accumulate = int(accumulate)
        self.mini_step = 0  # micro-batches in the open window
        self.update_count = 0  # updates applied (windows + flushes)
        self.acc: Optional[List[torch.Tensor]] = (
            [torch.zeros_like(p) for p in leaves] if self.accumulate > 1 else None
        )

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        """Take one micro-batch's gradients: update, or accumulate and
        update when the window is full."""
        if self.acc is None:
            self._apply(grads)
            return
        n = self.mini_step + 1
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / n)
        self.mini_step = n
        if n == self.accumulate:
            self.flush()

    @torch.no_grad()
    def flush(self) -> bool:
        """Apply the open accumulation window, if any; True when it did."""
        if self.acc is None or self.mini_step == 0:
            return False
        self._apply([a.clone() for a in self.acc])
        self.reset_window()
        return True

    def _apply(self, grads: List[torch.Tensor]) -> None:
        if self.clip is not None:
            norm = global_norm(grads)
            if not bool(norm < self.clip):
                grads = [g / norm.to(g.dtype) * self.clip for g in grads]
        if self.lr_schedule is not None:
            lr = float(self.lr_schedule(self.update_count))
            for group in self.opt.param_groups:
                group["lr"] = lr
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.step()
        for p in self.leaves:
            p.grad = None
        self.update_count += 1

    # -- state -----------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "optimizer": self.opt.state_dict(),
            "mini_step": self.mini_step,
            "update_count": self.update_count,
            "acc": self.acc,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if (state.get("acc") is None) != (self.acc is None):
            raise RuntimeError(
                "checkpointed optimizer state does not match the current "
                "optimizer: accumulate_grad_batches changed since the "
                "checkpoint was written. Resume with the same optimizer "
                "options, or load params only via validate/test/predict("
                "ckpt_path=...)"
            )
        self.opt.load_state_dict(state["optimizer"])
        self.mini_step = int(state["mini_step"])
        self.update_count = int(state["update_count"])
        if self.acc is not None:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)

    def reset_window(self) -> None:
        """Drop a partial accumulation window (a mid-epoch resume re-runs
        the epoch from its first batch, whose gradients it already holds)."""
        if self.acc is not None:
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
