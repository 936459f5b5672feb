"""TorchModule: the user-facing model abstraction of the port.

Counterpart of the JAX package's ``TPUModule``
(``ray_lightning_tpu/trainer/module.py:74``), with its contract kept:
parameters are a tree (nested dicts) of tensors that the training loop
owns, and the steps are functions of them —
``training_step(params, batch, generator) -> (loss, logs)``,
``validation_step(params, batch) -> logs``. Keeping the tree instead of an
``nn.Module`` keeps the weight bridge to the JAX package a plain copy.

``configure_optimizers()`` returns ``{"optimizer": factory, "lr_schedule":
step -> lr}``: ``factory(leaves)`` builds a ``torch.optim.Optimizer`` over
the parameter leaves (the loop sets each group's ``lr`` from the schedule
before every update, the way an optax transform embeds its schedule). A
bare factory, or ``(factory, schedule)``, is accepted too.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch


def unpack_optimizers(opt: Any) -> Tuple[Any, Optional[Any]]:
    """Normalize ``configure_optimizers()`` return forms to
    ``(factory, lr_schedule_or_None)``."""
    if isinstance(opt, dict):
        sched = opt.get("lr_schedule", opt.get("lr_scheduler"))
        return opt["optimizer"], sched if callable(sched) else None
    if type(opt) is tuple and len(opt) == 2:
        if callable(opt[1]):
            return opt
        raise TypeError(
            "configure_optimizers returned a 2-tuple whose second element "
            "is not a step->lr callable. Accepted forms: an optimizer "
            "factory, {'optimizer': factory, 'lr_schedule': fn}, or "
            "(factory, fn)."
        )
    return opt, None


def schedule_lr(
    sched: Any,
    *,
    global_step: int,
    update_count: Optional[int] = None,
    accumulate_grad_batches: int = 1,
) -> Optional[float]:
    """Evaluate a declared lr schedule at the next-update index: the exact
    update count when known, else ``global_step // accumulate_grad_batches``."""
    if sched is None:
        return None
    if update_count is not None:
        return float(sched(update_count))
    k = max(1, int(accumulate_grad_batches))
    return float(sched(global_step // k))


class TorchModule:
    """Base class for user models (the JAX package's ``TPUModule``).

    Required overrides:
      - ``init_params(generator, batch) -> params``: the initial tree of
        tensors (the loop moves it to the device).
      - ``training_step(params, batch, generator) -> (loss, logs)``: the
        loss is the mean over the batch; ``logs`` a flat dict of scalars.
      - ``configure_optimizers()`` (see the module docstring).
      - ``train_dataloader() -> DataLoader``

    Optional: ``validation_step``, ``test_step``, ``predict_step``, their
    data loaders, and the host hooks ``on_fit_start``,
    ``on_train_epoch_start``, ``on_train_epoch_end``,
    ``on_validation_epoch_end`` and ``on_fit_end``. A module whose eval
    metrics are not per-sample means sets ``supports_per_sample_eval =
    False``.
    """

    def __init__(self) -> None:
        self.params: Any = None  # populated after fit()/restore
        self.opt_state: Any = None  # optimizer state after fit()
        self.trainer: Any = None  # back-reference set by Trainer

    # -- required --------------------------------------------------------
    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        raise NotImplementedError

    def training_step(
        self, params: Any, batch: Any, generator: torch.Generator
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def configure_optimizers(self) -> Any:
        raise NotImplementedError

    def train_dataloader(self) -> Any:
        raise NotImplementedError

    # -- optional steps --------------------------------------------------
    def validation_step(self, params: Any, batch: Any) -> Dict[str, Any]:
        raise NotImplementedError

    def test_step(self, params: Any, batch: Any) -> Dict[str, Any]:
        return self.validation_step(params, batch)

    def predict_step(self, params: Any, batch: Any) -> Any:
        raise NotImplementedError

    def val_dataloader(self) -> Optional[Any]:
        return None

    def test_dataloader(self) -> Optional[Any]:
        return None

    def predict_dataloader(self) -> Optional[Any]:
        return None

    # -- host-side hooks -------------------------------------------------
    def on_fit_start(self) -> None: ...

    def on_fit_end(self) -> None: ...

    def on_train_epoch_start(self, epoch: int) -> None: ...

    def on_train_epoch_end(self, epoch: int, metrics: Dict[str, float]) -> None: ...

    def on_validation_epoch_end(self, metrics: Dict[str, float]) -> None: ...


class DataModule:
    """Optional container bundling dataloaders."""

    def prepare_data(self) -> None:
        """Called once before the dataloaders are built."""

    def setup(self, stage: Optional[str] = None) -> None: ...

    def train_dataloader(self) -> Any:
        raise NotImplementedError

    def val_dataloader(self) -> Optional[Any]:
        return None

    def test_dataloader(self) -> Optional[Any]:
        return None

    def predict_dataloader(self) -> Optional[Any]:
        return None
