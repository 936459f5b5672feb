"""Trainer: the user entry point of the port's training path.

``Trainer(max_steps=N).fit(module)`` runs the in-process path of the JAX
package's ``Trainer`` (``ray_lightning_tpu/trainer/trainer.py:62``,
``_run_in_process`` :392) on one device through ``SingleDeviceStrategy``:
on the card unless ``device="cpu"`` is asked for.
``Trainer(strategy=RayStrategy(num_workers=N)).fit(module)`` launches N
workers on the fabric, one card each, joins them into one
``torch.distributed`` group, trains with averaged gradients and recovers
rank 0's parameters, metrics and checkpoint paths here
(``_recover_results_in_main_process``). ``max_restarts`` relaunches a fit
whose worker died, or that answered a preemption notice, from the newest
loadable checkpoint it wrote. The options the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item; none is silently
ignored.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from ray_lightning_tpu_torch.trainer.loop import (
    TrainerSpec,
    TrainingLoop,
    TrainingPreempted,
)
from ray_lightning_tpu_torch.trainer.module import schedule_lr, unpack_optimizers
from ray_lightning_tpu_torch.utils.seed import seed_everything
from ray_lightning_tpu_torch.utils.state_stream import (
    state_stream_to_file,
    to_state_stream,
)


def _parse_max_time(value: Any) -> Optional[float]:
    """Normalize a max_time spec to seconds: seconds, a timedelta, a
    timedelta kwargs dict, or a 'DD:HH:MM:SS' / 'HH:MM:SS' string."""
    if value is None:
        return None
    if isinstance(value, datetime.timedelta):
        seconds = value.total_seconds()
    elif isinstance(value, dict):
        seconds = datetime.timedelta(**value).total_seconds()
    elif isinstance(value, str):
        parts = value.split(":")
        if len(parts) not in (3, 4) or not all(
            p.strip().isdigit() for p in parts
        ):
            raise ValueError(
                "max_time string must be 'DD:HH:MM:SS' or 'HH:MM:SS', "
                f"got {value!r}"
            )
        nums = [int(p) for p in parts]
        if len(nums) == 3:
            nums = [0] + nums
        d, h, m, s = nums
        seconds = float(((d * 24 + h) * 60 + m) * 60 + s)
    elif isinstance(value, (int, float)) and not isinstance(value, bool):
        seconds = float(value)
    else:
        raise ValueError(
            "max_time must be seconds, a timedelta, a timedelta kwargs "
            f"dict, or a 'DD:HH:MM:SS' string, got {type(value).__name__}"
        )
    if seconds <= 0:
        raise ValueError(f"max_time must be positive, got {seconds}s")
    return seconds


def _not_ported(option: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{option} is not ported yet (ROADMAP queue 1 item {item})"
    )


class Trainer:
    def __init__(
        self,
        max_epochs: int = 1,
        max_steps: Optional[int] = None,
        max_time: Optional[Any] = None,
        fast_dev_run: Any = False,
        strategy: Optional[Strategy] = None,
        callbacks: Optional[List[Any]] = None,
        limit_train_batches: Optional[Any] = None,
        limit_val_batches: Optional[Any] = None,
        limit_test_batches: Optional[Any] = None,
        limit_predict_batches: Optional[Any] = None,
        num_sanity_val_steps: int = 2,
        check_val_every_n_epoch: int = 1,
        overfit_batches: Optional[Any] = None,
        detect_anomaly: bool = False,
        val_check_interval: Optional[Any] = None,
        accumulate_grad_batches: int = 1,
        gradient_clip_val: Optional[float] = None,
        steps_per_execution: int = 1,
        log_every_n_steps: int = 50,
        enable_checkpointing: bool = True,
        enable_model_summary: bool = True,
        default_root_dir: Optional[str] = None,
        seed: Optional[int] = None,
        precision: str = "fp32",
        max_restarts: int = 0,
        ema_decay: Optional[float] = None,
        eval_ema: bool = False,
        async_checkpointing: bool = False,
        log_grad_norm: bool = False,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        # strategies/ imports the optimizer rule of this package: imported
        # here, not at the top, so either package may be imported first.
        from ray_lightning_tpu_torch.strategies.base import (
            SingleDeviceStrategy,
            Strategy,
        )

        if strategy is not None and not isinstance(strategy, Strategy):
            raise TypeError(
                f"strategy must be a Strategy, got {type(strategy).__name__}")
        if int(steps_per_execution) < 1:
            raise ValueError(
                f"steps_per_execution must be >= 1, got {steps_per_execution}"
            )
        if ema_decay is not None or eval_ema:
            raise _not_ported("ema_decay / eval_ema", "15")
        if int(max_restarts) < 0:
            raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
        if detect_anomaly:
            raise _not_ported("detect_anomaly", "15")
        if overfit_batches is not None:
            raise _not_ported("overfit_batches", "15")
        if fast_dev_run:
            raise _not_ported("fast_dev_run", "15")
        self.strategy = strategy or SingleDeviceStrategy(device)
        self.max_epochs = max_epochs
        self.max_steps = max_steps
        self.max_time = _parse_max_time(max_time)
        self.callbacks = list(callbacks or [])
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.limit_predict_batches = limit_predict_batches
        self.num_sanity_val_steps = num_sanity_val_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        if val_check_interval is not None:
            import math

            v = float(val_check_interval)
            is_float = isinstance(val_check_interval, float)
            if (
                not math.isfinite(v)
                or v <= 0
                or (is_float and v > 1)
                or (not is_float and v != int(v))
            ):
                raise ValueError(
                    "val_check_interval must be a positive int (batches) or "
                    "a float in (0, 1] (epoch fraction; 1.0 = epoch end), "
                    f"got {val_check_interval!r}"
                )
        self.val_check_interval = val_check_interval
        self.accumulate_grad_batches = accumulate_grad_batches
        self.gradient_clip_val = gradient_clip_val
        self.steps_per_execution = int(steps_per_execution)
        self.log_every_n_steps = log_every_n_steps
        self.enable_checkpointing = enable_checkpointing
        self.enable_model_summary = bool(enable_model_summary)
        self.default_root_dir = default_root_dir or os.path.join(
            tempfile.gettempdir(), "rlt_runs"
        )
        self.log_grad_norm = bool(log_grad_norm)
        if enable_checkpointing and not any(
            hasattr(cb, "best_model_path") for cb in self.callbacks
        ):
            from ray_lightning_tpu_torch.trainer.callbacks import ModelCheckpoint

            self.callbacks.append(ModelCheckpoint())
        self.seed = seed_everything(seed)
        self.precision = precision
        self.max_restarts = int(max_restarts)
        #: Sharded saves (``ModelCheckpoint(save_sharded=True)``) write
        #: from a background thread; their meta follows at the next save
        #: or the fit's end (``trainer/checkpoint_io.py``).
        self.async_checkpointing = bool(async_checkpointing)
        # State after a run
        self.callback_metrics: Dict[str, float] = {}
        self.logged_metrics: Dict[str, float] = {}
        self.state: Dict[str, Any] = {"status": "initialized", "stage": None}
        self.current_epoch = 0
        self.global_step = 0
        self._mid_epoch = False
        self._update_count: Optional[int] = None
        self._module: Any = None
        self._return_predictions = True

    def _make_spec(self) -> TrainerSpec:
        return TrainerSpec(
            max_epochs=self.max_epochs,
            max_steps=self.max_steps,
            max_time=self.max_time,
            limit_train_batches=self.limit_train_batches,
            limit_val_batches=self.limit_val_batches,
            limit_test_batches=self.limit_test_batches,
            limit_predict_batches=self.limit_predict_batches,
            num_sanity_val_steps=self.num_sanity_val_steps,
            check_val_every_n_epoch=self.check_val_every_n_epoch,
            val_check_interval=self.val_check_interval,
            accumulate_grad_batches=self.accumulate_grad_batches,
            gradient_clip_val=self.gradient_clip_val,
            steps_per_execution=self.steps_per_execution,
            log_every_n_steps=self.log_every_n_steps,
            enable_model_summary=self.enable_model_summary,
            default_root_dir=self.default_root_dir,
            seed=self.seed,
            precision=self.precision,
            log_grad_norm=self.log_grad_norm,
            return_predictions=self._return_predictions,
            async_checkpointing=self.async_checkpointing,
            callbacks=self.callbacks,
        )

    @property
    def lightning_module(self) -> Any:
        return self._module

    @property
    def checkpoint_callback(self) -> Optional[Any]:
        for cb in self.callbacks:
            if hasattr(cb, "best_model_path"):
                return cb
        return None

    @property
    def current_lr(self) -> Optional[float]:
        """The learning rate the next update would use, from the module's
        declared ``lr_schedule`` (None when none is declared)."""
        if self._module is None:
            return None
        _, sched = unpack_optimizers(self._module.configure_optimizers())
        return schedule_lr(
            sched,
            global_step=self.global_step,
            update_count=self._update_count,
            accumulate_grad_batches=self.accumulate_grad_batches,
        )

    # ------------------------------------------------------------------
    def _run(
        self, stage: str, module: Any, datamodule: Any = None,
        ckpt_path: Optional[str] = None, ckpt_stream: Optional[bytes] = None,
    ) -> Any:
        self._module = module
        module.trainer = self
        if ckpt_path == "last":
            ckpt_path = self._resolve_last_ckpt()
        elif ckpt_path == "best":
            ckpt_path = self._resolve_best_ckpt()
        if ckpt_stream is None and ckpt_path is not None:
            ckpt_stream = self._read_ckpt(ckpt_path)
        from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy

        if isinstance(self.strategy, SingleDeviceStrategy):
            return self._run_in_process(stage, module, datamodule, ckpt_stream)
        prev_opt_state = module.opt_state
        launcher = self.strategy._configure_launcher(self)
        output = launcher.launch(stage, module, datamodule=datamodule,
                                 ckpt_stream=ckpt_stream)
        result = self._recover_results_in_main_process(output, module)
        if stage != "fit" and ckpt_stream is None:
            # An eval without a checkpoint leaves the fit's params, so the
            # fit's optimizer state still belongs to them.
            module.opt_state = prev_opt_state
        return result

    def _run_in_process(self, stage: str, module: Any, datamodule: Any,
                        ckpt_stream: Optional[bytes]) -> Any:
        loop = TrainingLoop(
            self._make_spec(), module, self.strategy, datamodule=datamodule
        )
        if stage == "fit":
            try:
                loop.run_fit(ckpt_stream)
            except TrainingPreempted:
                # Checkpoint-on-notice: the checkpoint is written and
                # validated; the restart loop (or fit(ckpt_path=exc.
                # ckpt_path)) resumes it.
                self.state = dict(loop.state)
                raise
            result = None
            self.current_epoch = loop.current_epoch
            self.global_step = loop.global_step
            self._update_count = loop.update_count
            self._mid_epoch = not loop._epoch_complete
            #: The fit's training programs: (K-step, single-step).
            self.train_programs = loop.train_programs
        elif stage in ("validate", "test"):
            result = loop.run_evaluate(stage, ckpt_stream)
        else:
            result = loop.run_predict(ckpt_stream)
        self.state = dict(loop.state)
        self.callback_metrics = {
            k: float(v) for k, v in loop.callback_metrics.items()
        }
        self.logged_metrics = {k: float(v) for k, v in loop.logged_metrics.items()}
        return result

    def _recover_results_in_main_process(self, output: Any, module: Any) -> Any:
        """Restore rank 0's results into this process (the reference's
        ``_recover_results_in_main_process``, ``ray_launcher.py:351-379``):
        the module's params (and, after a fit, its optimizer state) as CPU
        tensors, the counters, the metrics and the callbacks' state
        (``best_model_path``)."""
        if output is None:
            return None
        if output.state_stream is not None:
            from ray_lightning_tpu_torch.utils.state_stream import (
                load_state_stream,
            )

            state = load_state_stream(output.state_stream)
            module.params = state["params"]
            module.opt_state = state.get("opt_state")
        self.state = dict(output.trainer_state)
        epoch = int(self.state.pop("epoch", 0))
        step = int(self.state.pop("global_step", 0))
        uc = self.state.pop("update_count", None)
        mid = self.state.pop("mid_epoch", None)
        self.state.pop("current_lr", None)
        if self.state.get("stage") == "fit":
            # Only fits advance training progress.
            self.current_epoch = epoch
            self.global_step = step
            self._update_count = None if uc is None else int(uc)
            self._mid_epoch = bool(mid)
        self.callback_metrics = {
            k: float(v) for k, v in output.callback_metrics.items()}
        self.logged_metrics = {
            k: float(v) for k, v in output.logged_metrics.items()}
        for cb in self.callbacks:
            cb_state = output.callback_states.get(type(cb).__name__)
            if cb_state:
                cb.load_state_dict(cb_state)
        return output.results

    @staticmethod
    def _read_ckpt(ckpt_path: Optional[str]) -> Optional[Any]:
        """A checkpoint file's bytes, or, for a sharded checkpoint
        directory, ``{"sharded_path": path}``: each process reads the
        pieces itself, into its own mesh (the directory must be reachable
        from every worker)."""
        if ckpt_path is None:
            return None
        from ray_lightning_tpu_torch.trainer.checkpoint_io import (
            is_sharded_checkpoint,
        )

        if is_sharded_checkpoint(ckpt_path):
            return {"sharded_path": os.path.abspath(ckpt_path)}
        with open(ckpt_path, "rb") as f:
            return f.read()

    def _resolve_best_ckpt(self) -> str:
        cb = self.checkpoint_callback
        best = getattr(cb, "best_model_path", "") if cb is not None else ""
        if best and os.path.exists(best):
            return best
        raise FileNotFoundError(
            'ckpt_path="best" needs a ModelCheckpoint with a recorded '
            "best_model_path (fit with a monitored metric first)"
        )

    def _resolve_last_ckpt(self) -> str:
        cb = self.checkpoint_callback
        last = getattr(cb, "last_model_path", "") if cb is not None else ""
        if last and os.path.exists(last):
            return last
        found = [p for d in self._ckpt_search_dirs()
                 for p, _ in self._ckpt_candidates(d)]
        if not found:
            raise FileNotFoundError(
                f"ckpt_path='last': no checkpoint found in "
                f"{self._ckpt_search_dirs()} (fit with checkpointing enabled "
                "first)"
            )
        return max(found, key=os.path.getmtime)

    def _ckpt_search_dirs(self) -> List[str]:
        cb = self.checkpoint_callback
        dirs = []
        if cb is not None and getattr(cb, "dirpath", None):
            dirs.append(cb.dirpath)
        dirs.append(os.path.join(self.default_root_dir, "checkpoints"))
        return dirs

    @staticmethod
    def _ckpt_candidates(d: str) -> List[Tuple[str, float]]:
        """(path, mtime) of the checkpoints in a directory, files and
        sharded directories; one that vanishes between the listing and the
        stat is skipped."""
        from ray_lightning_tpu_torch.trainer.checkpoint_io import (
            is_sharded_checkpoint,
        )

        out = []
        if not os.path.isdir(d):
            return out
        for name in os.listdir(d):
            p = os.path.join(d, name)
            if not (name.endswith(".ckpt") or is_sharded_checkpoint(p)):
                continue
            try:
                out.append((p, os.path.getmtime(p)))
            except OSError:
                continue
        return out

    def _restart_checkpoint(
        self, fit_started: float
    ) -> Tuple[Optional[str], Optional[bytes]]:
        """The newest LOADABLE checkpoint this fit wrote (modified after
        it started: a shared directory may hold other runs' files), the
        rolling ``last*`` files first; an unreadable candidate (a save cut
        by the crash) falls through to the next newest. Returns ``(path,
        bytes)``, so the resume reads the file once (a sharded directory:
        ``(path, its marker)``)."""
        from ray_lightning_tpu_torch.trainer.checkpoint_io import _META_FILE
        from ray_lightning_tpu_torch.utils.state_stream import (
            load_state_stream,
        )

        min_mtime = fit_started - 1.0
        for d in self._ckpt_search_dirs():
            cands = [(p, m) for p, m in self._ckpt_candidates(d)
                     if m >= min_mtime]
            last = [c for c in cands if os.path.basename(c[0]).startswith("last")]
            rest = [c for c in cands if c not in last]
            ordered = (sorted(last, key=lambda t: t[1], reverse=True)
                       + sorted(rest, key=lambda t: t[1], reverse=True))
            for path, _ in ordered:
                try:
                    data = self._read_ckpt(path)
                    if isinstance(data, bytes):
                        load_state_stream(data)
                    else:
                        # A sharded directory is finished once its meta,
                        # written after every rank's pieces, loads.
                        with open(os.path.join(path, _META_FILE), "rb") as f:
                            load_state_stream(f.read())
                except Exception as exc:  # noqa: BLE001 - try an older one
                    warnings.warn(
                        f"skipping unreadable checkpoint {path}: {exc}",
                        RuntimeWarning, stacklevel=2,
                    )
                    continue
                return path, data
        return None, None

    # ------------------------------------------------------------------
    def fit(
        self, module: Any, datamodule: Any = None, ckpt_path: Optional[str] = None
    ) -> "Trainer":
        """Run the fit. With ``max_restarts > 0``, a worker that dies
        mid-fit (``ActorDiedError``) relaunches the group, and a fit that
        answered a preemption notice (``TrainingPreempted``: its validated
        checkpoint-on-notice is written) resumes; either from the newest
        loadable checkpoint this fit wrote, else from ``ckpt_path`` or
        scratch (JAX ``trainer/trainer.py:427-481``). Every restart is
        recorded: the ``rlt_train_fit_restarts_total{cause=}`` counter and
        the ``fit_restarting`` / ``fit_resume`` events. With
        ``max_restarts=0`` the error surfaces."""
        from ray_lightning_tpu_torch.fabric.core import ActorDiedError

        fit_started = time.time()
        attempts = self.max_restarts
        ckpt_data: Optional[bytes] = None
        while True:
            try:
                self._run("fit", module, datamodule, ckpt_path, ckpt_data)
                return self
            except (ActorDiedError, TrainingPreempted) as exc:
                if attempts <= 0:
                    raise
                attempts -= 1
                preempted = isinstance(exc, TrainingPreempted)
                cause = "preempted" if preempted else "actor_died"
                self._record_fit_restart(cause, exc, attempts)
                resume, resume_data = self._restart_checkpoint(fit_started)
                warnings.warn(
                    ("fit preempted (checkpoint-on-notice saved); "
                     if preempted else f"worker died mid-fit ({exc}); ")
                    + f"restarting ({attempts} restart(s) left) from "
                    f"{resume or ckpt_path or 'scratch'}",
                    RuntimeWarning, stacklevel=2,
                )
                if preempted:
                    # The notice is consumed: this retry stands in for the
                    # replacement process.
                    from ray_lightning_tpu_torch.serve.preempt import (
                        reset_monitor,
                    )

                    reset_monitor()
                if resume is not None:
                    ckpt_path, ckpt_data = resume, resume_data
                else:
                    ckpt_data = None
                self._record_fit_resume(cause, resume or ckpt_path or "scratch")

    def _record_fit_restart(self, cause: str, exc: BaseException,
                            restarts_left: int) -> None:
        from ray_lightning_tpu_torch.obs.events import get_event_log
        from ray_lightning_tpu_torch.obs.registry import get_registry

        get_registry().counter(
            "rlt_train_fit_restarts_total",
            "Mid-fit restarts performed by the Trainer.fit retry loop",
        ).inc(1, cause=cause)
        get_event_log().record(
            "trainer", "fit_restarting", level="warn", cause=cause,
            error=f"{type(exc).__name__}: {exc}"[:300],
            restarts_left=restarts_left,
        )

    @staticmethod
    def _record_fit_resume(cause: str, ckpt: str) -> None:
        from ray_lightning_tpu_torch.obs.events import get_event_log

        get_event_log().record("trainer", "fit_resume", cause=cause,
                               ckpt=str(ckpt))

    def validate(
        self, module: Any, datamodule: Any = None, ckpt_path: Optional[str] = None
    ) -> List[Dict[str, float]]:
        return self._run("validate", module, datamodule, ckpt_path)

    def test(
        self, module: Any, datamodule: Any = None, ckpt_path: Optional[str] = None
    ) -> List[Dict[str, float]]:
        return self._run("test", module, datamodule, ckpt_path)

    def predict(
        self,
        module: Any,
        datamodule: Any = None,
        ckpt_path: Optional[str] = None,
        return_predictions: bool = True,
    ) -> Optional[List[Any]]:
        self._return_predictions = return_predictions
        try:
            return self._run("predict", module, datamodule, ckpt_path)
        finally:
            self._return_predictions = True

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Save the module's params, optimizer state and the fit's
        counters (a resumable file)."""
        from ray_lightning_tpu_torch.strategies.base import to_host

        if self._module is None or self._module.params is None:
            raise RuntimeError("nothing to checkpoint: fit first")
        state = {
            "params": to_host(self._module.params),
            "opt_state": self._module.opt_state,
            "epoch": self.current_epoch,
            "global_step": self.global_step,
            "mid_epoch": self._mid_epoch,
            "callbacks": {
                type(cb).__name__: cb.state_dict() for cb in self.callbacks
            },
        }
        state_stream_to_file(to_state_stream(state), path)


def lr_find(*args: Any, **kwargs: Any) -> Any:
    """The learning-rate finder (``trainer/lr_finder.py``): not ported."""
    raise _not_ported("lr_find (the learning-rate finder)", "14")


def scale_batch_size(*args: Any, **kwargs: Any) -> Any:
    """The batch-size finder (``trainer/batch_finder.py``): not ported."""
    raise _not_ported("scale_batch_size (the batch-size finder)", "14")
