"""Callbacks: host-side hooks at step, validation and epoch boundaries
(subset of ``ray_lightning_tpu/trainer/callbacks.py``: ``Callback``,
``ModelCheckpoint``, ``EarlyStopping``). The stats and profiler callbacks
are ROADMAP queue 1 item 14.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional


class Callback:
    def on_fit_start(self, trainer: Any, module: Any) -> None: ...

    def on_train_epoch_start(self, trainer: Any, module: Any) -> None: ...

    def on_train_batch_end(
        self, trainer: Any, module: Any, logs: Dict[str, float], batch_idx: int
    ) -> None: ...

    def on_train_epoch_end(self, trainer: Any, module: Any) -> None: ...

    def on_validation_end(self, trainer: Any, module: Any) -> None: ...

    def on_fit_end(self, trainer: Any, module: Any) -> None: ...

    def on_predict_batch_end(
        self, trainer: Any, module: Any, prediction: Any, batch_idx: int
    ) -> None: ...

    def on_predict_end(
        self, trainer: Any, module: Any, predictions: Any
    ) -> None: ...

    def state_dict(self) -> Dict[str, Any]:
        return {}

    def load_state_dict(self, state: Dict[str, Any]) -> None: ...


def _metric_value(trainer: Any, monitor: str) -> Optional[float]:
    val = trainer.callback_metrics.get(monitor)
    return None if val is None else float(val)


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


class ModelCheckpoint(Callback):
    """Save the training state at each validation end (or epoch end when
    there is no validation loop) and track the best file.

    Files are state streams (``utils/state_stream.py``) holding params,
    optimizer state and the loop's counters, so a fit resumes exactly.
    """

    def __init__(
        self,
        dirpath: Optional[str] = None,
        filename: str = "epoch={epoch}-step={step}",
        monitor: Optional[str] = None,
        mode: str = "min",
        save_top_k: int = 1,
        save_last: bool = False,
        save_sharded: bool = False,
    ) -> None:
        assert mode in ("min", "max")
        if save_sharded:
            raise NotImplementedError(
                "sharded checkpoints are not ported yet (ROADMAP queue 1 "
                "item 11b)"
            )
        self.dirpath = dirpath
        self.filename = filename
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.best_model_path: str = ""
        self.best_model_score: Optional[float] = None
        self.last_model_path: str = ""
        self._saved: list[tuple[float, str]] = []

    def _is_better(self, score: float) -> bool:
        if self.best_model_score is None:
            return True
        if self.mode == "min":
            return score < self.best_model_score
        return score > self.best_model_score

    def on_validation_end(self, trainer: Any, module: Any) -> None:
        # The sanity pass's metrics are discarded: no checkpoint from them.
        if getattr(trainer, "sanity_checking", False):
            return
        self._save(trainer)

    def on_train_epoch_end(self, trainer: Any, module: Any) -> None:
        if not trainer.has_validation:
            self._save(trainer)

    def _save(self, trainer: Any) -> None:
        if self.save_top_k == 0:
            return
        rank = getattr(trainer, "global_rank", 0)
        if rank != 0 and not getattr(trainer, "gather_is_collective", False):
            # Only rank 0 writes; the other ranks have no gather to join.
            return
        dirpath = self.dirpath or os.path.join(
            trainer.default_root_dir, "checkpoints"
        )
        os.makedirs(dirpath, exist_ok=True)
        name = self.filename.format(
            epoch=trainer.current_epoch, step=trainer.global_step
        )
        path = os.path.join(dirpath, name + ".ckpt")
        # Every rank that got here enters save_checkpoint: its gather is a
        # collective; rank 0 alone writes and keeps the bookkeeping.
        trainer.save_checkpoint(path)
        last = None
        if self.save_last:
            last = os.path.join(dirpath, "last.ckpt")
            trainer.save_checkpoint(last)
        if rank != 0:
            return
        if last:
            self.last_model_path = last
        score = _metric_value(trainer, self.monitor) if self.monitor else None
        if self.monitor is None:
            # No monitor: the latest checkpoint is "best" and the previous
            # one is pruned.
            prev = self.best_model_path
            self.best_model_path = path
            if (
                self.save_top_k == 1
                and prev
                and prev != path
                and os.path.exists(prev)
            ):
                _remove(prev)
        elif score is not None and not math.isnan(score):
            if self._is_better(score):
                self.best_model_score = score
                self.best_model_path = path
            self._saved.append((score, path))
            self._prune()

    def _prune(self) -> None:
        if self.save_top_k < 0:
            return
        self._saved.sort(key=lambda t: t[0], reverse=self.mode == "max")
        while len(self._saved) > self.save_top_k:
            _, path = self._saved.pop()
            if path != self.best_model_path and os.path.exists(path):
                _remove(path)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "best_model_path": self.best_model_path,
            "best_model_score": self.best_model_score,
            "last_model_path": self.last_model_path,
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_model_path = state.get("best_model_path", "")
        self.best_model_score = state.get("best_model_score")
        self.last_model_path = state.get("last_model_path", "")


class EarlyStopping(Callback):
    """Stop training when a monitored metric stops improving; also on
    reaching ``stopping_threshold``, on passing ``divergence_threshold``
    and, with ``check_finite``, on a non-finite reading."""

    def __init__(
        self,
        monitor: str = "val_loss",
        patience: int = 3,
        mode: str = "min",
        min_delta: float = 0.0,
        stopping_threshold: Optional[float] = None,
        divergence_threshold: Optional[float] = None,
        check_finite: bool = False,
    ) -> None:
        assert mode in ("min", "max")
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = abs(min_delta)
        self.stopping_threshold = stopping_threshold
        self.divergence_threshold = divergence_threshold
        self.check_finite = check_finite
        self.wait = 0
        self.best: Optional[float] = None

    def _improved(self, score: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return score < self.best - self.min_delta
        return score > self.best + self.min_delta

    def _beats(self, score: float, threshold: float) -> bool:
        return score <= threshold if self.mode == "min" else score >= threshold

    def on_validation_end(self, trainer: Any, module: Any) -> None:
        if getattr(trainer, "sanity_checking", False):
            return
        score = _metric_value(trainer, self.monitor)
        if score is None:
            return
        if not math.isfinite(score):
            if self.check_finite:
                trainer.should_stop = True
            return
        if self.stopping_threshold is not None and self._beats(
            score, self.stopping_threshold
        ):
            trainer.should_stop = True
            return
        if self.divergence_threshold is not None and not self._beats(
            score, self.divergence_threshold
        ):
            trainer.should_stop = True
            return
        if self._improved(score):
            self.best = score
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.should_stop = True

    def state_dict(self) -> Dict[str, Any]:
        return {"wait": self.wait, "best": self.best}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.wait = state.get("wait", 0)
        self.best = state.get("best")
