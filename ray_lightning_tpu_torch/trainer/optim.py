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

import contextlib
import math
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

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


_TINY = float(torch.finfo(torch.float32).tiny)


def _step_is_graph_safe(opt: torch.optim.Optimizer, scheduled: bool) -> bool:
    """Whether ``opt.step()`` reads nothing back to the host once every
    group that has torch's ``capturable`` option has it on (its step
    counter and bias corrections then stay on the device, and it takes a
    learning rate that is a device tensor), or, for SGD, which has no such
    option, when its lr is a constant (its first step, which makes the
    momentum buffers, runs before any capture)."""
    if all("capturable" in g for g in opt.param_groups):
        return True
    return type(opt) is torch.optim.SGD and not scheduled


class TrainOptimizer:
    """One update rule over the parameter leaves: accumulation, clipping,
    the schedule, then the module's optimizer.

    A micro-batch's device work reads nothing back to the host: its
    position in the accumulation window is a host value known before the
    step (:meth:`plan`), the learning rates of the planned updates are
    computed on the host ahead of it (:meth:`lrs`), and clipping selects
    on the device. With ``capturable`` (the default for leaves on a CUDA
    device) every group that has torch's ``capturable`` option gets it;
    when the step is then graph-safe (:attr:`step_in_graph`), the
    update runs inside :meth:`take`, with a scheduled lr passed as a 0-d
    device tensor, so a CUDA graph holds the whole micro-batch. Any other
    optimizer (Adagrad, or SGD with a schedule: their steps read a value
    back) keeps the window's gradients in fixed buffers and steps after
    the graph, through :meth:`update`, with the lr as a host float, as it
    does everywhere on the CPU."""

    def __init__(
        self,
        factory: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
        leaves: List[torch.Tensor],
        lr_schedule: Optional[Callable[[int], float]] = None,
        clip: Optional[float] = None,
        accumulate: int = 1,
        capturable: Optional[bool] = None,
    ) -> None:
        self.leaves = leaves
        self.opt = factory(leaves)
        self.lr_schedule = lr_schedule
        self.clip = float(clip) if clip else None
        self.accumulate = int(accumulate)
        self.mini_step = 0  # micro-batches in the open window
        self.update_count = 0  # updates applied (windows + flushes)
        if capturable is None:
            capturable = leaves[0].device.type == "cuda"
        #: Groups in torch's capturable mode (their steps divide by the lr).
        self.capturable = bool(capturable) and any(
            "capturable" in g for g in self.opt.param_groups)
        if self.capturable:
            for group in self.opt.param_groups:
                if "capturable" in group:
                    group["capturable"] = True
        #: The update runs inside :meth:`take` (and so inside a graph).
        self.step_in_graph = bool(capturable) and _step_is_graph_safe(
            self.opt, lr_schedule is not None)
        self.acc: Optional[List[torch.Tensor]] = (
            [torch.zeros_like(p) for p in leaves]
            if self.accumulate > 1 or not self.step_in_graph else None
        )

    # -- host planning -----------------------------------------------------
    def plan(self, n: int) -> List[Tuple[int, bool]]:
        """The next ``n`` micro-batches as ``(window position, updates)``:
        position 1.. within the accumulation window, and whether the
        micro-batch closes it (always, without accumulation)."""
        out, mini = [], self.mini_step
        for _ in range(n):
            mini += 1
            out.append((mini, mini == self.accumulate))
            mini %= self.accumulate
        return out

    def lrs(self, plan: List[Tuple[int, bool]]) -> List[float]:
        """The learning rate of each planned micro-batch's update (0.0
        where it does not update, or without a schedule)."""
        out, count = [], self.update_count
        for _, updates in plan:
            lr = 0.0
            if updates:
                lr = (float(self.lr_schedule(count))
                      if self.lr_schedule is not None else 0.0)
                count += 1
            out.append(lr)
        return out

    def commit(self, plan: List[Tuple[int, bool]]) -> None:
        """Advance the host counters past ``plan``."""
        for pos, updates in plan:
            self.mini_step = 0 if updates else pos
            self.update_count += int(updates)

    # -- device work -------------------------------------------------------
    @torch.no_grad()
    def take(self, grads: List[torch.Tensor], pos: int, updates: bool,
             lr: torch.Tensor) -> None:
        """One micro-batch's gradients at window position ``pos``: into
        the window's running mean, then, when ``updates`` and the step runs
        in the graph, the update at learning rate ``lr`` (a 0-d device
        tensor; read only under a schedule)."""
        if self.acc is None:
            self._apply(grads, lr)
            return
        for a, g in zip(self.acc, grads):
            if pos == 1:
                a.copy_(g)
            else:
                a.add_((g - a) / pos)
        if updates and self.step_in_graph:
            self._apply(self.acc, lr)

    @torch.no_grad()
    def update(self, lr: float) -> None:
        """The update from the window :meth:`take` filled, at host
        learning rate ``lr``, for a step that does not run in the graph."""
        self._apply(self.acc, lr)

    @torch.no_grad()
    def flush(self) -> bool:
        """Apply the open accumulation window, if any; True when it did."""
        if self.accumulate == 1 or self.mini_step == 0:
            return False
        self._apply(self.acc, self.lrs([(self.mini_step, True)])[0])
        self.update_count += 1
        self.reset_window()
        return True

    def _apply(self, grads: List[torch.Tensor], lr: Any) -> None:
        if self.clip is not None:
            norm = global_norm(grads)
            grads = [torch.where(norm < self.clip, g,
                                 g / norm.to(g.dtype) * self.clip)
                     for g in grads]
        self._set_lr(lr)
        self._step(grads)

    def _set_lr(self, lr: Any) -> None:
        if self.lr_schedule is not None:
            if self.capturable:
                # A capturable step computes eps / (-lr / bias_correction):
                # at an lr of exactly 0 (a warmup's first update, a decay's
                # end) an element whose gradient and second moment are 0
                # becomes 0/0. The smallest normal fp32 in its place moves
                # no parameter larger than about 1e-30 in magnitude.
                lr = (lr.clamp_min(_TINY) if isinstance(lr, torch.Tensor)
                      else max(lr, _TINY))
            for group in self.opt.param_groups:
                group["lr"] = lr

    def _step(self, grads: List[torch.Tensor]) -> None:
        """The module's optimizer step on the (clipped) gradients of
        :attr:`leaves`."""
        for p, g in zip(self.leaves, grads):
            p.grad = g
        self.opt.step()
        for p in self.leaves:
            p.grad = None

    # -- sharded state (no-ops here; see strategies/sharded.py) ------------
    def gather_params(self) -> None:
        """Make the full parameter tensors whole (collective where the
        ranks hold slices of them at rest)."""

    def release_params(self, in_use: Sequence[torch.Tensor] = ()) -> None:
        """Free the full parameter tensors, where slices hold the values at
        rest, except those sharing storage with a tensor of ``in_use``."""

    @contextlib.contextmanager
    def full_params(self) -> Iterator[None]:
        """The full parameter tensors, whole while the block runs."""
        yield

    def gathered_state_dict(self) -> Dict[str, Any]:
        """:meth:`state_dict` with every tensor whole: the checkpoint
        form, whatever the ranks hold."""
        return self.state_dict()

    # -- state -----------------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        opt = self.opt.state_dict()
        for group in opt["param_groups"]:
            if isinstance(group["lr"], torch.Tensor):  # a graph's lr buffer
                group["lr"] = float(group["lr"])
        return {
            "optimizer": opt,
            "mini_step": self.mini_step,
            "update_count": self.update_count,
            "acc": self.acc if self.accumulate > 1 else None,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if (state.get("acc") is None) != (self.accumulate == 1):
            raise RuntimeError(
                "checkpointed optimizer state does not match the current "
                "optimizer: accumulate_grad_batches changed since the "
                "checkpoint was written. Resume with the same optimizer "
                "options, or load params only via validate/test/predict("
                "ckpt_path=...)"
            )
        opt = dict(state["optimizer"])
        # The live ``capturable`` choice, not the writer's: it decides
        # where the step counters are loaded.
        opt["param_groups"] = [
            {**saved, **({"capturable": live["capturable"]}
                         if "capturable" in live else {})}
            for saved, live in zip(opt["param_groups"], self.opt.param_groups)
        ]
        self.opt.load_state_dict(opt)
        self.mini_step = int(state["mini_step"])
        self.update_count = int(state["update_count"])
        if self.accumulate > 1:
            for a, s in zip(self.acc, state["acc"]):
                a.copy_(s)

    def reset_window(self) -> None:
        """Drop a partial accumulation window (a mid-epoch resume re-runs
        the epoch from its first batch, whose gradients it already holds)."""
        if self.accumulate > 1:
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
