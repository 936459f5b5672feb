"""The training engine: fit, validate, test and predict in one process,
which is the whole run or one rank of a launched group.

Port of ``ray_lightning_tpu/trainer/loop.py`` (``TrainerSpec`` :32,
``TrainingLoop`` :143). The loop owns the parameter
tree and the optimizer, iterates epochs with callbacks at step, validation
and epoch boundaries, and keeps the JAX loop's semantics: the sampler is
always attached (its shuffle order is the JAX one), ``global_step`` counts
micro-batches while the schedule counts updates, a partial accumulation
window is flushed at the end of an epoch that ran all its batches,
checkpoints saved mid-epoch resume by re-running that epoch, and eval
metrics count real rows only.

``steps_per_execution=K`` folds K optimizer steps into one dispatch (one
CUDA graph of K steps on the card, ``strategies/base.py:TrainProgram``)
with the JAX loop's semantics (``loop.py:843-861``, ``:995-1025`` of the
JAX package): K host batches leave as one stacked copy; logs, callbacks,
``val_check_interval`` and stop checks happen at chunk boundaries (an
unaligned int interval raises, a fraction quantizes); epoch and
``max_steps`` tails shorter than K run through the single-step program,
so budgets are exact. Evaluation is not folded.

Checkpoint-on-notice (JAX ``loop.py:617-687``, ``:833-838``): after every
dispatched chunk the loop reads this process's preemption monitor
(``serve/preempt.py:peek_state``). On a notice it writes
``last-preempt-step{N:08d}.ckpt`` carrying ``resume_batch`` (the batches
of the epoch already trained), loads it back to validate it and raises
:class:`TrainingPreempted`. A fit from that checkpoint continues the
same epoch at the next batch with the partial accumulation window kept,
so it ends on the uninterrupted fit's parameters.

In a launched group (``strategies/``, ``launchers/``) every rank runs
this loop on its sampler shard: rank and world come from the strategy's
``DistEnv``; only rank 0 writes checkpoints and prints the summary (every
rank enters the state gathers when they are collectives, as under ZeRO);
``max_time`` and preemption notices stop the group at consensus points
(mid-epoch validation and epoch ends, a MAX all-reduce of a flag: the JAX
loop's ``process_allgather``); predictions are gathered in rank order and
each rank's callbacks see the rows it owns (:meth:`TrainingLoop.
_owner_rows`); :meth:`TrainingLoop.collect_rank_zero_results` packs what
the driver recovers.

Sharded checkpoints (``save_checkpoint(path, sharded=True)``,
``trainer/checkpoint_io.py``): every rank writes its own slices, no
gather; with ``async_checkpointing`` a background thread writes them and
the meta marker follows at the next save or the fit's end. A resume
reads whole leaves from the pieces of any mesh.

Not here (raised by ``Trainer``): EMA, the telemetry and the watchdog.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import sys
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_lightning_tpu_torch.trainer.module import schedule_lr, unpack_optimizers
from ray_lightning_tpu_torch.trainer.optim import TrainOptimizer
from ray_lightning_tpu_torch.utils.seed import reset_seed
from ray_lightning_tpu_torch.utils.state_stream import (
    load_state_stream,
    state_stream_to_file,
    to_state_stream,
)
from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map


@dataclass
class TrainerSpec:
    """The trainer's configuration as the loop reads it."""

    max_epochs: int = 1
    max_steps: Optional[int] = None
    max_time: Optional[float] = None  # seconds
    limit_train_batches: Optional[Any] = None  # int or float fraction
    limit_val_batches: Optional[Any] = None
    limit_test_batches: Optional[Any] = None
    limit_predict_batches: Optional[Any] = None
    num_sanity_val_steps: int = 2
    check_val_every_n_epoch: int = 1
    # Mid-epoch validation: int = every N train batches, float in (0, 1) =
    # that fraction of an epoch. None = epoch end only.
    val_check_interval: Optional[Any] = None
    accumulate_grad_batches: int = 1
    gradient_clip_val: Optional[float] = None
    # Optimizer steps per dispatch (one CUDA graph of K steps on the card).
    steps_per_execution: int = 1
    log_every_n_steps: int = 50
    default_root_dir: str = "."
    seed: Optional[int] = None
    precision: str = "fp32"
    log_grad_norm: bool = False
    enable_model_summary: bool = True
    return_predictions: bool = True
    # Sharded saves write from a background thread (checkpoint_io.py).
    async_checkpointing: bool = False
    callbacks: List[Any] = field(default_factory=list)


class TrainingPreempted(RuntimeError):
    """The fit answered a preemption notice (``serve/preempt.py``) with
    checkpoint-on-notice: a validated checkpoint was written at the step
    boundary the notice caught, and the loop exited. ``fit(ckpt_path=
    ckpt_path)`` resumes from it, losing at most the chunk in flight.
    Picklable with its attributes."""

    def __init__(self, ckpt_path: str, global_step: int = 0) -> None:
        super().__init__(
            f"fit preempted: checkpoint-on-notice written to {ckpt_path} "
            f"at step {global_step}"
        )
        self.ckpt_path = ckpt_path
        self.global_step = int(global_step)

    def __reduce__(self):
        return (type(self), (self.ckpt_path, self.global_step))


def _chunks(batches, k: int):
    """Consecutive groups of ``k`` batches, then the tail shorter than
    ``k`` as groups of one (what the single-step program runs)."""
    group: list = []
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield group
            group = []
    for b in group:
        yield [b]


def _load_checkpoint(ckpt: Any, params_only: bool = False) -> Dict[str, Any]:
    """A checkpoint's whole state: a state stream's bytes, or a sharded
    directory's ``{"sharded_path": path}`` (``Trainer._read_ckpt``), its
    pieces assembled whole and its meta merged in."""
    if isinstance(ckpt, dict) and "sharded_path" in ckpt:
        from ray_lightning_tpu_torch.trainer.checkpoint_io import (
            ShardedCheckpointIO,
        )

        restored, meta = ShardedCheckpointIO().restore(
            ckpt["sharded_path"], partial=params_only)
        return dict(meta, **restored)
    return load_state_stream(ckpt)


def _limit(n_batches: int, limit: Any) -> int:
    if limit is None:
        return n_batches
    if isinstance(limit, float):
        return max(1, int(n_batches * limit))
    return min(n_batches, int(limit))


class TrainingLoop:
    """Executes fit/validate/test/predict in this process."""

    def __init__(
        self, spec: TrainerSpec, module: Any, strategy: Any, datamodule: Any = None
    ) -> None:
        self.spec = spec
        self.module = module
        self.strategy = strategy
        self.datamodule = datamodule
        # Trainer-facade state visible to callbacks
        self.current_epoch = 0
        self.global_step = 0
        self.should_stop = False
        self.callback_metrics: Dict[str, Any] = {}
        self.logged_metrics: Dict[str, Any] = {}
        self.state: Dict[str, Any] = {"status": "initializing", "stage": None}
        self.callbacks = list(spec.callbacks)
        self.sanity_checking = False
        self.params: Any = None
        self.optimizer: Optional[TrainOptimizer] = None
        self._lr_schedule = None
        self._epoch_complete = True
        self._resumed_mid_epoch = False
        #: Batches of the resumed epoch a checkpoint-on-notice already
        #: trained (skipped at the resume), and the value the next
        #: checkpoint records (set only while it is written).
        self._resume_batch = 0
        self._preempt_resume_batch: Optional[int] = None
        self._fit_deadline: Optional[float] = None
        self._val_loader = None
        self._train_loader = None
        self._sharded_io: Any = None

    # -- facade properties used by callbacks ---------------------------
    @property
    def global_rank(self) -> int:
        return self.strategy.global_rank if self.strategy.grouped else 0

    @property
    def world_size(self) -> int:
        env = self.strategy.dist_env
        return env.world_size if self.strategy.grouped else 1

    @property
    def gather_is_collective(self) -> bool:
        """Do checkpoint-state gathers need every rank (see Strategy)?"""
        return bool(self.strategy.gather_is_collective)

    @property
    def default_root_dir(self) -> str:
        return self.spec.default_root_dir

    @property
    def has_validation(self) -> bool:
        return self._val_loader is not None

    @property
    def lightning_module(self) -> Any:
        return self.module

    @property
    def update_count(self) -> Optional[int]:
        """Updates applied under accumulation (windows + flushes); None
        when every micro-batch is an update."""
        if self.optimizer is None or self.spec.accumulate_grad_batches <= 1:
            return None
        return self.optimizer.update_count

    @property
    def current_lr(self) -> Optional[float]:
        """The learning rate of the NEXT update, from the module's declared
        schedule (None when none is declared)."""
        return schedule_lr(
            self._lr_schedule,
            global_step=self.global_step,
            update_count=self.update_count,
        )

    # ------------------------------------------------------------------
    def _call_callbacks(self, hook: str, *args: Any) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, self.module, *args)

    def _seed(self) -> int:
        return self.spec.seed if self.spec.seed is not None else 0

    def _setup_common(self) -> None:
        reset_seed()
        self.module.trainer = self
        self.module.precision = self.spec.precision
        seed = self._seed()
        source = self.module
        if self.datamodule is not None:
            self.datamodule.prepare_data()
            self.datamodule.setup()
            source = self.datamodule
        skw = self.strategy.sampler_kwargs()
        try:
            loader = source.train_dataloader()
        except NotImplementedError:
            loader = None
        # The sampler is attached even on one device: its shuffle order
        # (default_rng(seed + epoch)) is the JAX loop's.
        if loader is not None:
            loader = loader.with_sampler(seed=seed, **skw)
        self._train_loader = loader
        val = source.val_dataloader()
        if val is not None:
            val = val.with_sampler(seed=seed, **skw)
        self._val_loader = val

    def _init_state(self, ckpt_stream: Optional[bytes]) -> None:
        sample_batch = next(iter(self._train_loader.iter_batches(1)))
        generator = torch.Generator(device=self.strategy.device)
        generator.manual_seed(self._seed())
        params = self.module.init_params(generator, sample_batch)
        state = None
        if ckpt_stream is not None:
            state = _load_checkpoint(ckpt_stream)
            params = state["params"]
        self.strategy.bind_module(self.module)
        self.params = self.strategy.place_params(params)
        factory, self._lr_schedule = unpack_optimizers(
            self.module.configure_optimizers()
        )
        self.optimizer = self.strategy.make_optimizer(
            factory,
            tree_leaves(self.params),
            self._lr_schedule,
            self.spec.gradient_clip_val,
            self.spec.accumulate_grad_batches,
        )
        if state is None:
            return
        if state.get("opt_state") is not None:
            self.optimizer.load_state_dict(
                tree_map(
                    lambda x: x.to(self.strategy.device)
                    if isinstance(x, torch.Tensor) else x,
                    state["opt_state"],
                )
            )
        elif int(state.get("global_step", 0) or 0) > 0:
            warnings.warn(
                "resuming fit from a checkpoint that carries training "
                f"progress (global_step={state['global_step']}) but no "
                "optimizer state — Adam moments and the LR schedule restart "
                "from scratch.",
                RuntimeWarning,
                stacklevel=2,
            )
        self._restore_progress(state)
        if self._resumed_mid_epoch:
            # A mid-epoch resume re-runs the epoch from batch 0: keeping the
            # restored partial window would count those batches twice.
            self.optimizer.reset_window()

    def _restore_progress(self, state: Dict[str, Any]) -> None:
        # A checkpoint saved mid-epoch resumes by re-running that epoch.
        self._resumed_mid_epoch = bool(state.get("mid_epoch"))
        bump = 0 if self._resumed_mid_epoch else 1
        rb = int(state.get("resume_batch") or 0)
        self._resume_batch = 0
        if rb and self._resumed_mid_epoch:
            # Checkpoint-on-notice: continue the same epoch at the next
            # batch (the loader's order is a function of the seed and the
            # epoch), keeping the partial accumulation window.
            self._resume_batch = rb
            self._resumed_mid_epoch = False
        self.current_epoch = int(state.get("epoch", -1)) + bump
        self.global_step = int(state.get("global_step", 0))
        for cb in self.callbacks:
            cb_state = state.get("callbacks", {}).get(type(cb).__name__)
            if cb_state:
                cb.load_state_dict(cb_state)

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str, sharded: bool = False) -> None:
        """Write the full training state as a state-stream file: rank 0
        writes; the other ranks enter only a collective gather.
        ``sharded=True``: a checkpoint directory where every rank writes
        the slices it holds, with no gather (call from every rank)."""
        if sharded:
            self._save_sharded(path)
            return
        if self.global_rank != 0 and not self.gather_is_collective:
            return
        state = self.checkpoint_state()
        if self.global_rank != 0:
            return
        state_stream_to_file(to_state_stream(state), path)

    def _save_sharded(self, path: str) -> None:
        from ray_lightning_tpu_torch.trainer.checkpoint_io import (
            AsyncShardedCheckpointIO,
            ShardedCheckpointIO,
        )

        meta = {
            "epoch": self.current_epoch,
            "mid_epoch": not self._epoch_complete,
            "global_step": self.global_step,
            "callbacks": {
                type(cb).__name__: cb.state_dict() for cb in self.callbacks
            },
        }
        if self._preempt_resume_batch:
            meta["resume_batch"] = int(self._preempt_resume_batch)
        if self._sharded_io is None:
            self._sharded_io = (AsyncShardedCheckpointIO()
                                if self.spec.async_checkpointing
                                else ShardedCheckpointIO())
        skeleton, pieces = self.optimizer.sharded_state()
        refs = iter(skeleton["params"])
        skeleton["params"] = tree_map(lambda _: next(refs), self.params)
        self._sharded_io.save(
            path, skeleton, pieces, self.strategy.ckpt_layout(), meta,
            is_rank_zero=self.global_rank == 0,
            barrier=lambda: self.strategy.barrier("sharded_checkpoint"))

    def finalize_checkpoints(self) -> None:
        """Every rank's checkpoint work is done once this returns on any
        rank: an async sharded save in flight is drained and its meta
        written, then a barrier (callbacks that delete checkpoints rely on
        the ordering this call gives, not on the writes' own)."""
        if self._sharded_io is not None:
            self._sharded_io.finalize(
                lambda: self.strategy.barrier("sharded_checkpoint"))
        self.strategy.barrier("finalize_checkpoints")

    def full_params(self) -> Any:
        """A context in which :attr:`params` are whole. ZeRO-3 holds only
        the rank's slices between steps, so a callback that reads the
        parameters during a fit does so inside it, on every rank (it is a
        collective there); elsewhere it does nothing."""
        if self.optimizer is None:
            return contextlib.nullcontext()
        return self.optimizer.full_params()

    def checkpoint_state(self) -> Dict[str, Any]:
        """The full state (collective under ZeRO: the slices are
        gathered)."""
        gather = self.strategy.gather_state
        with self.full_params():
            params = gather(self.params)
        return {
            "params": params,
            "opt_state": (
                gather(self.optimizer.gathered_state_dict())
                if self.optimizer is not None else None
            ),
            "epoch": self.current_epoch,
            "mid_epoch": not self._epoch_complete,
            "global_step": self.global_step,
            "callbacks": {
                type(cb).__name__: cb.state_dict() for cb in self.callbacks
            },
            # Checkpoint-on-notice only: the epoch position to continue at.
            **(
                {"resume_batch": int(self._preempt_resume_batch)}
                if self._preempt_resume_batch else {}
            ),
        }

    def _preempt_pending(self, synced: bool) -> bool:
        """Has a preemption notice landed on this process? ``synced``
        reaches a cross-rank consensus (any preempted rank stops everyone:
        the group checkpoints and exits as a unit) and is a collective,
        like :meth:`_out_of_time`."""
        from ray_lightning_tpu_torch.serve.preempt import peek_state

        st = peek_state()
        local = bool(st and st.get("pending"))
        return self.strategy.any_rank(local) if synced else local

    def _preempt_exit(self, resume_batch: Optional[int]) -> None:
        """Checkpoint-on-notice: write a resume checkpoint at this step
        boundary, load it back (an unreadable file raises here, never
        later at the resume) and raise :class:`TrainingPreempted`.
        ``resume_batch`` (batches of this epoch already trained) rides the
        checkpoint; None means the epoch just completed. The name sorts
        into the ``last*`` group that ``ckpt_path="last"`` scans."""
        from ray_lightning_tpu_torch.obs.events import get_event_log

        cb = next(
            (c for c in self.callbacks if hasattr(c, "best_model_path")),
            None,
        )
        d = getattr(cb, "dirpath", None) if cb is not None else None
        if not d:
            d = os.path.join(self.spec.default_root_dir, "checkpoints")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"last-preempt-step{self.global_step:08d}.ckpt")
        get_event_log().record(
            "trainer", "fit_preempt_checkpoint", level="warn", path=path,
            step=self.global_step, epoch=self.current_epoch,
            resume_batch=int(resume_batch or 0),
        )
        self._preempt_resume_batch = int(resume_batch) if resume_batch else None
        try:
            self.save_checkpoint(path)
        finally:
            self._preempt_resume_batch = None
        if self.global_rank == 0:
            with open(path, "rb") as f:
                load_state_stream(f.read())
        self.state = {"status": "preempted", "stage": "fit"}
        raise TrainingPreempted(path, self.global_step)

    def _out_of_time(self, synced: bool) -> bool:
        """Has the fit's wall-clock budget expired? ``synced`` reaches a
        cross-rank consensus (any rank out of time stops everyone) and may
        only be called where every rank is at once: it is a collective."""
        if self._fit_deadline is None:
            return False
        local = time.monotonic() >= self._fit_deadline
        return self.strategy.any_rank(local) if synced else local

    # ------------------------------------------------------------------
    def run_fit(self, ckpt_stream: Optional[bytes] = None) -> None:
        self.state = {"status": "running", "stage": "fit"}
        if self.spec.max_time is not None:
            self._fit_deadline = time.monotonic() + self.spec.max_time
        self._setup_common()
        if self._train_loader is None:
            raise RuntimeError("fit requires train_dataloader()")
        self._init_state(ckpt_stream)
        # One process in all answers notices and budgets at every chunk; a
        # group only where every rank is at once (validation, epoch ends).
        solo = self.world_size == 1
        time_per_step = self._fit_deadline is not None and solo
        fold = max(1, int(self.spec.steps_per_execution))
        train_step = self.strategy.compile_train_step(
            self.module, self.optimizer, self._seed(),
            log_grad_norm=self.spec.log_grad_norm, fold_steps=fold,
        )
        # Tails shorter than the fold (an epoch's remainder, the max_steps
        # cap) run through the single-step program.
        single_step = (
            train_step if fold == 1 else self.strategy.compile_train_step(
                self.module, self.optimizer, self._seed(),
                log_grad_norm=self.spec.log_grad_norm,
            )
        )
        self.train_programs = (train_step, single_step)
        val_step = (
            self.strategy.compile_eval_step(self.module, "val")
            if self._val_loader is not None
            else None
        )
        if self.spec.enable_model_summary and self.global_rank == 0:
            from ray_lightning_tpu_torch.utils.summary import summarize_params

            # stderr: stdout carries the results of scripts.
            print(summarize_params(self.params), file=sys.stderr, flush=True)
        self.module.on_fit_start()
        self._call_callbacks("on_fit_start")
        mult = self.strategy.batch_multiplier

        # Sanity validation before training (skipped on resume).
        if (
            val_step is not None
            and self.spec.num_sanity_val_steps
            and self.current_epoch == 0
            and self.global_step == 0
        ):
            self.sanity_checking = True
            saved_cb = dict(self.callback_metrics)
            saved_logged = dict(self.logged_metrics)
            try:
                self._run_eval_epoch(
                    val_step, self._val_loader, "sanity",
                    max_batches=(
                        None if self.spec.num_sanity_val_steps < 0
                        else self.spec.num_sanity_val_steps
                    ),
                )
                self._call_callbacks("on_validation_end")
            finally:
                self.callback_metrics = saved_cb
                self.logged_metrics = saved_logged
                self.sanity_checking = False

        stop = False
        start_epoch = self.current_epoch
        for epoch in range(start_epoch, self.spec.max_epochs):
            if stop or self.should_stop:
                break
            self.current_epoch = epoch
            self._epoch_complete = False
            self._train_loader.set_epoch(epoch)
            self.module.on_train_epoch_start(epoch)
            self._call_callbacks("on_train_epoch_start")
            n_batches = _limit(
                self._train_loader.num_batches(mult), self.spec.limit_train_batches
            )
            vci = self._val_interval(n_batches, fold)
            if fold > n_batches > 0 and not getattr(self, "_fold_warned",
                                                    False):
                self._fold_warned = True  # epoch-invariant; warn once
                warnings.warn(
                    f"steps_per_execution ({fold}) exceeds the batches per "
                    f"epoch ({n_batches}); every chunk is an epoch tail, so "
                    "no dispatch is ever folded — lower it to at most the "
                    "epoch length to get the amortization",
                    UserWarning, stacklevel=2,
                )
            val_epoch = (epoch + 1) % self.spec.check_val_every_n_epoch == 0
            last_val_step = -1
            pending: List[Dict[str, torch.Tensor]] = []
            epoch_vals: Dict[str, List[float]] = {}

            def drain() -> Dict[str, float]:
                """Fetch the buffered per-step logs (a (n,) tensor per key
                and dispatch) to the host; return the latest step's
                values."""
                last: Dict[str, float] = {}
                for logs in pending:
                    for k, v in logs.items():
                        vals = [float(x) for x in v.reshape(-1).tolist()]
                        epoch_vals.setdefault(k, []).extend(vals)
                        last[k] = vals[-1]
                pending.clear()
                return last

            # A resume from a checkpoint-on-notice skips the batches the
            # preempted fit trained (batch_idx stays epoch-absolute).
            skip = 0
            if epoch == start_epoch:
                skip, self._resume_batch = self._resume_batch, 0
            n_iter = max(0, n_batches - skip)
            if self.spec.max_steps is not None:
                remaining = max(0, self.spec.max_steps - self.global_step)
                n_iter = min(n_iter, remaining)
                if remaining == 0:
                    stop = True
            batch_idx = skip - 1
            for chunk in _chunks(
                itertools.islice(
                    self._train_loader.iter_batches(mult), skip, skip + n_iter
                ),
                fold,
            ):
                start_step = self.global_step
                step = train_step if len(chunk) == fold else single_step
                logs = step(self.params, chunk, start_step)
                pending.append(logs)  # device values; no sync here
                self.global_step += len(chunk)
                batch_idx += len(chunk)
                if (
                    self.global_step // self.spec.log_every_n_steps
                    != start_step // self.spec.log_every_n_steps
                    or batch_idx == n_batches - 1
                ):
                    host_logs = drain()
                    self.logged_metrics.update(host_logs)
                    self._call_callbacks("on_train_batch_end", host_logs, batch_idx)
                if (
                    val_step is not None
                    and vci
                    and val_epoch
                    and (batch_idx + 1) % vci == 0
                ):
                    if batch_idx == n_batches - 1 and self.optimizer.mini_step == 0:
                        # Final batch, nothing left to flush: a checkpoint
                        # this val writes is epoch-complete.
                        self._epoch_complete = True
                    self._run_eval_epoch(val_step, self._val_loader, "val")
                    self._call_callbacks("on_validation_end")
                    last_val_step = self.global_step
                    # Every rank just ran the same validation: a point
                    # for the consensus checks.
                    if self._out_of_time(synced=True):
                        self.should_stop = True
                    if not solo and self._preempt_pending(synced=True):
                        self._preempt_exit(batch_idx + 1)
                if solo and self._preempt_pending(synced=False):
                    # Answer the notice at this chunk boundary.
                    self._preempt_exit(batch_idx + 1)
                if (
                    (
                        self.spec.max_steps is not None
                        and self.global_step >= self.spec.max_steps
                    )
                    or self.should_stop
                    or (time_per_step and self._out_of_time(synced=False))
                ):
                    stop = True
                    break

            # Flush a partial accumulation window only when the epoch ran
            # all its batches (a max_steps stop on the final batch too).
            flushed = False
            if not stop or batch_idx == n_batches - 1:
                flushed = self.optimizer.flush()
                self._epoch_complete = True

            drain()
            if epoch_vals:
                means = {k: sum(v) / len(v) for k, v in epoch_vals.items()}
                self.callback_metrics.update(means)
                self.callback_metrics.update(
                    {f"{k}_epoch": v for k, v in means.items()}
                )
            if (
                val_step is not None
                and val_epoch
                and (last_val_step != self.global_step or flushed)
                and not self.should_stop
            ):
                self._run_eval_epoch(val_step, self._val_loader, "val")
                self._call_callbacks("on_validation_end")
            self.module.on_train_epoch_end(epoch, dict(self.callback_metrics))
            self._call_callbacks("on_train_epoch_end")
            if self._out_of_time(synced=True):
                self.should_stop = True
            if not solo and self._preempt_pending(synced=True):
                # An epoch-complete exit: the resume starts the next epoch.
                self._preempt_exit(None)

        self.state = {"status": "finished", "stage": "fit"}
        self.optimizer.gather_params()  # ZeRO-3: whole from here on
        self.module.params = tree_map(lambda x: x.detach(), self.params)
        if not self.strategy.grouped:
            # A launched fit ships its optimizer state in the rank-0
            # result (collect_rank_zero_results) instead.
            self.module.opt_state = self.strategy.gather_state(
                self.optimizer.gathered_state_dict()
            )
        self.module.on_fit_end()
        self._call_callbacks("on_fit_end")
        self.finalize_checkpoints()

    def _val_interval(self, n_batches: int, fold: int = 1) -> Optional[int]:
        """Mid-epoch validation cadence in batches (None = epoch end). With
        a fold of K steps per dispatch the host sees only chunk
        boundaries: a fraction quantizes to the nearest multiple of K
        (within the epoch), an int that is not a multiple raises."""
        vci = self.spec.val_check_interval
        if isinstance(vci, float) and vci == 1.0:
            return None
        from_float = vci is not None and 0 < float(vci) < 1
        if from_float:
            vci = max(1, int(n_batches * float(vci)))
        elif vci is not None:
            vci = int(vci)
            if vci > n_batches > 0:
                raise ValueError(
                    f"val_check_interval ({vci}) exceeds the number of "
                    f"training batches per epoch ({n_batches}); use a "
                    "smaller interval or a float epoch fraction"
                )
        if vci is not None and fold > 1 and vci % fold:
            if not from_float:
                raise ValueError(
                    f"val_check_interval ({vci}) must be a multiple of "
                    f"steps_per_execution ({fold}): the host only sees "
                    "chunk boundaries, so an unaligned int interval would "
                    "silently validate late (float fractions quantize "
                    "instead)"
                )
            vci = max(fold, round(vci / fold) * fold)
            if vci > n_batches >= fold:
                vci = (n_batches // fold) * fold
        return vci

    def _run_eval_epoch(
        self, eval_step, loader, prefix: str, max_batches: Optional[int] = None
    ) -> Dict[str, float]:
        mult = self.strategy.batch_multiplier
        limit = (
            self.spec.limit_test_batches
            if prefix == "test"
            else self.spec.limit_val_batches
        )
        n_batches = _limit(loader.num_batches(mult), limit)
        if max_batches is not None:
            n_batches = min(n_batches, max_batches)
        # Per-key sums over real rows and the real-row count per batch; the
        # weighted combine keeps epoch metrics exact on a wrap-around tail.
        sums: Dict[str, torch.Tensor] = {}
        total = 0.0
        with self.full_params():
            for batch, mask in itertools.islice(
                loader.iter_batches(mult, with_mask=True), n_batches
            ):
                s, count = eval_step(self.params,
                                     self.strategy.place_batch(batch), mask)
                total += count
                for k, v in s.items():
                    sums[k] = sums[k] + v if k in sums else v
        if not sums:
            return {}
        means = {k: float(v) / max(total, 1.0) for k, v in sums.items()}
        self.callback_metrics.update(means)
        self.logged_metrics.update(means)
        if prefix in ("val", "validate"):
            self.module.on_validation_epoch_end(means)
        return means

    def run_evaluate(
        self, stage: str, ckpt_stream: Optional[bytes] = None
    ) -> List[Dict[str, float]]:
        self.state = {"status": "running", "stage": stage}
        self._setup_common()
        source = self.datamodule if self.datamodule is not None else self.module
        if stage in ("val", "validate"):
            loader = self._val_loader
        else:
            loader = source.test_dataloader()
            if loader is not None:
                loader = loader.with_sampler(
                    seed=0, **self.strategy.sampler_kwargs()
                )
        if loader is None:
            raise RuntimeError(f"{stage} requires a dataloader")
        self._restore_or_adopt(ckpt_stream)
        eval_step = self.strategy.compile_eval_step(self.module, stage)
        metrics = self._run_eval_epoch(eval_step, loader, stage)
        self.state = {"status": "finished", "stage": stage}
        return [metrics]

    def run_predict(self, ckpt_stream: Optional[bytes] = None) -> Optional[List[Any]]:
        self.state = {"status": "running", "stage": "predict"}
        self._setup_common()
        source = self.datamodule if self.datamodule is not None else self.module
        loader = source.predict_dataloader()
        if loader is None:
            raise RuntimeError("predict requires predict_dataloader()")
        loader = loader.with_sampler(seed=0, **self.strategy.sampler_kwargs())
        self._restore_or_adopt(ckpt_stream)
        predict_step = self.strategy.compile_eval_step(self.module, "predict")
        mult = self.strategy.batch_multiplier
        n_batches = _limit(
            loader.num_batches(mult), self.spec.limit_predict_batches
        )
        preds, local_preds = [], []
        for bi, (host_batch, host_mask) in enumerate(
            itertools.islice(loader.iter_batches(mult, with_mask=True), n_batches)
        ):
            out, mask = predict_step(
                self.params, self.strategy.place_batch(host_batch), host_mask
            )
            # The global batch in rank order (every rank's rows), and the
            # rows of it this rank owns.
            out, gmask = self.strategy.gather_predictions(out, mask)
            gmask = np.asarray(gmask, dtype=bool)
            own = self._owner_rows(len(gmask))
            # Trim wrap-around padding rows: predictions line up 1:1 with
            # the dataset.
            local = tree_map(
                lambda p: p[torch.as_tensor(own & gmask).to(p.device)].cpu(),
                out)
            self._call_callbacks("on_predict_batch_end", local, bi)
            local_preds.append(local)
            preds.append(local if own.all() else tree_map(
                lambda p: p[torch.as_tensor(gmask).to(p.device)].cpu(), out))
        self._call_callbacks("on_predict_end", local_preds)
        self.state = {"status": "finished", "stage": "predict"}
        return preds if self.spec.return_predictions else None

    def _owner_rows(self, n: int) -> np.ndarray:
        """Boolean mask of the global batch's rows THIS rank owns: its own
        block of the rank-ordered concatenation. The ranks' masks
        partition [0, n), so each row reaches exactly one rank's
        callbacks (PredictionWriter shards are disjoint and complete)."""
        block, blocks = self.strategy.prediction_owner()
        own = np.zeros(n, dtype=bool)
        per = n // blocks
        if block is not None:
            own[block * per:(block + 1) * per] = True
        return own

    # ------------------------------------------------------------------
    def _gathered_module_state_stream(self) -> Optional[bytes]:
        """Gather the module state on every rank that must (all of them
        when the gathers are collectives); serialize on rank 0 only."""
        if self.params is None:
            return None
        if self.global_rank != 0 and not self.gather_is_collective:
            return None
        with self.full_params():
            state: Dict[str, Any] = {
                "params": self.strategy.gather_state(self.params)}
        if self.optimizer is not None and self.state.get("stage") == "fit":
            # The optimizer state too, so the driver's save_checkpoint()
            # writes a resumable file.
            state["opt_state"] = self.strategy.gather_state(
                self.optimizer.gathered_state_dict())
        if self.global_rank != 0:
            return None
        return to_state_stream(state)

    def collect_rank_zero_results(self, results: Any) -> Any:
        """Rank 0's state for the driver (the reference's
        ``_collect_rank_zero_results``, ``ray_launcher.py:312-349``): a
        ``WorkerOutput`` on rank 0, None elsewhere. The state gathers run
        on every rank first when they are collectives."""
        from ray_lightning_tpu_torch.launchers.utils import WorkerOutput

        state_stream = self._gathered_module_state_stream()
        if self.global_rank != 0:
            return None
        best_model_path = None
        callback_states: Dict[str, Any] = {}
        for cb in self.callbacks:
            callback_states[type(cb).__name__] = cb.state_dict()
            if getattr(cb, "best_model_path", None):
                best_model_path = cb.best_model_path
        trainer_state = dict(
            self.state,
            epoch=self.current_epoch,
            global_step=self.global_step,
            update_count=self.update_count,
            current_lr=self.current_lr,
        )
        if self.state.get("stage") == "fit":
            trainer_state["mid_epoch"] = not self._epoch_complete
        return WorkerOutput(
            best_model_path=best_model_path,
            state_stream=state_stream,
            trainer_state=trainer_state,
            results=results,
            callback_metrics={k: float(v)
                              for k, v in self.callback_metrics.items()},
            logged_metrics={k: float(v)
                            for k, v in self.logged_metrics.items()},
            callback_states=callback_states,
        )

    def _restore_or_adopt(self, ckpt_stream: Optional[Any]) -> None:
        """Load params from a checkpoint (a state stream, or a sharded
        directory's marker: its parameters only) or adopt the module's
        own."""
        if ckpt_stream is not None:
            state = _load_checkpoint(ckpt_stream, params_only=True)
            params = state["params"] if "params" in state else state
        elif self.module.params is not None:
            params = self.module.params
        else:
            raise RuntimeError(
                "no parameters available: fit first, or pass ckpt_path"
            )
        self.strategy.bind_module(self.module)
        self.params = self.strategy.place_params(params)
