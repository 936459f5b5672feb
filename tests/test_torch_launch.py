"""The port's launcher end to end on fabric actors, on the CPU (gloo):
``Trainer(strategy=RayStrategy(num_workers=2, use_gpu=False)).fit`` of a
tiny GPT held against the JAX package's in-process fit of the same global
batches; a ZeRO-3 checkpoint resumed at another world size; ``init_hook``;
``max_restarts`` over a crashed rank; the restart checkpoint picker.

Six launched fits in all. The port's modules and callbacks the workers
run live in ``tests/_torch_dist_worker.py``, which imports no JAX. Both
packages train at ``precision="fp32"`` from the same numpy weights; the
JAX fit's ``batch_size`` (1) times its 8 virtual devices equals the
port's (4) times its 2 ranks, on 16 rows, so no epoch pads. Bar: 1e-4 on
losses and parameters (the model bar); 1e-6 between a restarted fit and
the uninterrupted one (both in single-threaded workers).
"""
import dataclasses
import glob
import os
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu.trainer import Callback as JCallback
from ray_lightning_tpu.trainer import Trainer as JTrainer
from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.strategies import RayShardedStrategy, RayStrategy
from ray_lightning_tpu_torch.trainer import ModelCheckpoint, Trainer
from ray_lightning_tpu_torch.utils.state_stream import (
    load_state_stream,
    state_stream_to_file,
    to_state_stream,
)
from tests import _torch_dist_worker as W

TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = jgpt.GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                      max_seq=64, attn_impl="reference")
CFG = dataclasses.asdict(JCFG)
GPT = dict(n_train=16, warmup_steps=2)
EPOCHS = 3  # 2 steps each


class _JRecord(JCallback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(float(logs["loss"]))


class _JGPTShared(jgpt.GPTLM):
    def init_params(self, rng, batch):
        return jax.tree_util.tree_map(jnp.asarray, W.gpt_numpy_params(CFG))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach().cpu() if torch.is_tensor(v)
                                         else v)
    return out


def _assert_close(got, want, tol, what=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=what + k, **tol)


@pytest.fixture(scope="module")
def port_fabric():
    mp = pytest.MonkeyPatch()
    mp.setenv("RLT_NUM_GPUS", "0")
    mp.delenv("RLT_REQUIRE_GPU", raising=False)
    fabric.init(num_cpus=4)
    yield fabric
    fabric.shutdown()
    mp.undo()


def _trainer(root, strategy, record, **kw):
    kw.setdefault("callbacks", [])
    kw.setdefault("max_epochs", EPOCHS)
    return Trainer(strategy=strategy, seed=0,
                   log_every_n_steps=1, limit_val_batches=2,
                   enable_model_summary=False, default_root_dir=str(root),
                   callbacks=[record] + kw.pop("callbacks"), **kw)


@pytest.fixture(scope="module")
def uninterrupted(port_fabric, tmp_path_factory):
    """The launched 2-rank fit every later case is held against, with an
    ``init_hook`` that stamps each worker process once."""
    tmp = tmp_path_factory.mktemp("launch")
    stamps = tmp / "stamps"
    stamps.mkdir()
    stamp_dir = str(stamps)

    def init_hook():
        import os
        import time

        with open(os.path.join(stamp_dir, f"{os.getpid()}.hook"), "a") as f:
            f.write(f"{time.monotonic()}\n")

    record = W.Record()
    ckpt = ModelCheckpoint(dirpath=str(tmp / "ckpts"), monitor="val_loss")
    trainer = _trainer(tmp, RayStrategy(num_workers=2, use_gpu=False,
                                        init_hook=init_hook),
                       record, callbacks=[ckpt])
    module = W.SharedGPT(CFG, stamp_dir=stamp_dir, batch_size=4, **GPT)
    trainer.fit(module)
    return {"trainer": trainer, "module": module, "record": record,
            "ckpt": ckpt, "stamps": stamp_dir}


def test_launched_gpt_fit_matches_the_jax_fit(uninterrupted, tmp_path):
    """Every logged loss and the driver's recovered parameters against
    the JAX in-process fit of the same global batches; the driver's
    metrics are rank 0's; the best checkpoint's path comes back."""
    jrec = _JRecord()
    jt = JTrainer(max_epochs=EPOCHS, seed=0, log_every_n_steps=1,
                  limit_val_batches=2, enable_checkpointing=False,
                  enable_model_summary=False, callbacks=[jrec],
                  default_root_dir=str(tmp_path))
    jm = _JGPTShared(JCFG, batch_size=1, **GPT)
    jt.fit(jm)

    t, rec = uninterrupted["trainer"], uninterrupted["record"]
    assert len(rec.losses) == len(jrec.losses) == 2 * EPOCHS
    np.testing.assert_allclose(rec.losses, jrec.losses, **TOL)
    _assert_close(uninterrupted["module"].params, jm.params, TOL)
    assert all(v.device.type == "cpu" for v in
               _flat_tensors(uninterrupted["module"].params))
    assert t.global_step == jt.global_step == 2 * EPOCHS
    assert t.current_epoch == jt.current_epoch == EPOCHS - 1
    np.testing.assert_allclose(t.callback_metrics["val_loss"],
                               jt.callback_metrics["val_loss"], **TOL)
    assert t.callback_metrics == rec.metrics  # rank 0's, exactly
    assert t.state["status"] == "finished"
    best = uninterrupted["ckpt"].best_model_path
    assert best and os.path.exists(best) and best.endswith(".ckpt")
    assert uninterrupted["module"].opt_state is not None


def _flat_tensors(tree):
    out = []
    for v in tree.values():
        out.extend(_flat_tensors(v) if isinstance(v, dict) else [v])
    return out


def test_init_hook_runs_once_per_worker_before_its_fit(uninterrupted):
    """``init_hook`` ran exactly once in each worker process, before the
    fit started there (JAX ``tests/test_ddp.py:140-185``)."""
    d = uninterrupted["stamps"]
    hooks = sorted(glob.glob(os.path.join(d, "*.hook")))
    fits = sorted(glob.glob(os.path.join(d, "*.fit")))
    assert len(hooks) == 2
    assert ({os.path.basename(p).split(".")[0] for p in hooks}
            == {os.path.basename(p).split(".")[0] for p in fits})
    for path in hooks:
        lines = open(path).read().splitlines()
        assert len(lines) == 1
        first_fit = open(path.replace(".hook", ".fit")).read().splitlines()[0]
        assert float(lines[0]) < float(first_fit)


def test_max_restarts_survives_a_crashed_rank(uninterrupted, tmp_path):
    """A rank exits at the start of epoch 1: the group relaunches from the
    epoch-0 checkpoint and ends where the uninterrupted fit ends."""
    record = W.Record()
    ckpt = ModelCheckpoint(dirpath=str(tmp_path / "ckpts"), save_last=True)
    trainer = _trainer(tmp_path, RayStrategy(num_workers=2, use_gpu=False),
                       record, callbacks=[ckpt], max_restarts=1)
    module = W.SharedGPT(CFG, batch_size=4, crash_at=1,
                         marker=str(tmp_path / "crashed"), **GPT)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        trainer.fit(module)
    assert any("restarting" in str(w.message) for w in caught)
    assert os.path.exists(tmp_path / "crashed")
    assert trainer.state["status"] == "finished"
    assert trainer.current_epoch == EPOCHS - 1
    assert trainer.global_step == uninterrupted["trainer"].global_step
    # The checkpoint carried the recorder's epoch-0 losses across.
    np.testing.assert_allclose(record.losses,
                               uninterrupted["record"].losses, rtol=0,
                               atol=1e-6)
    _assert_close(module.params, uninterrupted["module"].params,
                  dict(rtol=0, atol=1e-6), "restarted vs uninterrupted: ")


def test_max_restarts_zero_surfaces_the_dead_actor(port_fabric, tmp_path):
    trainer = _trainer(tmp_path, RayStrategy(num_workers=2, use_gpu=False),
                       W.Record(), enable_checkpointing=False)
    with pytest.raises(fabric.ActorDiedError):
        trainer.fit(W.SharedGPT(CFG, batch_size=4, crash_at=0, **GPT))


def test_zero3_checkpoint_resumes_at_another_world_size(port_fabric,
                                                       tmp_path):
    """A 2-rank ZeRO-3 fit writes a plain full checkpoint (the data-
    parallel format: full params, full optimizer state); a single-device
    fit and a 1-worker launched fit both resume it, to the same end."""
    ckpt = ModelCheckpoint(dirpath=str(tmp_path / "z3"))
    first = _trainer(tmp_path / "a",
                     RayShardedStrategy(num_workers=2, use_gpu=False,
                                        zero_stage=3),
                     W.Record(), callbacks=[ckpt], max_epochs=1)
    first.fit(W.SharedGPT(CFG, batch_size=4, **GPT))
    path = ckpt.best_model_path
    assert path and os.path.exists(path)
    with open(path, "rb") as f:
        state = load_state_stream(f.read())
    shapes = {k: v.shape for k, v in _flat(W.gpt_numpy_params(CFG)).items()}
    assert {k: v.shape for k, v in _flat(state["params"]).items()} == shapes
    full = set(shapes.values())
    opt = state["opt_state"]["optimizer"]["state"]
    moments = {tuple(v.shape) for st in opt.values() for v in st.values()
               if torch.is_tensor(v) and v.dim() > 0}
    assert moments == full  # whole leaves, not a rank's slices
    assert state["epoch"] == 0 and state["global_step"] == 2

    resumed = {}
    for name, strategy, kw in (
        ("single", None, dict(device="cpu")),
        ("one_worker", RayStrategy(num_workers=1, use_gpu=False), {}),
    ):
        t = _trainer(tmp_path / name, strategy, W.Record(),
                     enable_checkpointing=False, max_epochs=2, **kw)
        m = W.SharedGPT(CFG, batch_size=8, **GPT)
        t.fit(m, ckpt_path=path)
        assert t.current_epoch == 1 and t.global_step == 4
        resumed[name] = m.params
    # The model bar: the driver's process and the worker run their CPU
    # products on different thread counts, so the two round differently.
    _assert_close(resumed["one_worker"], resumed["single"], TOL)


def test_restart_picker_skips_stale_and_corrupt_checkpoints(tmp_path):
    """``_restart_checkpoint`` takes the newest loadable checkpoint
    written since the fit started, ``last*`` first: a file from before
    the fit and an unreadable newer one are skipped (JAX
    ``tests/test_ddp.py:404-449``, as a unit)."""
    d = tmp_path / "ckpts"
    d.mkdir()
    good = {"params": {"w": torch.ones(2)}, "epoch": 0, "global_step": 2}
    stale = d / "last-old.ckpt"
    state_stream_to_file(to_state_stream(good), str(stale))
    old = time.time() - 3600
    os.utime(stale, (old, old))
    started = time.time()
    state_stream_to_file(to_state_stream(good), str(d / "epoch=0-step=2.ckpt"))
    state_stream_to_file(to_state_stream(dict(good, global_step=4)),
                         str(d / "last.ckpt"))
    (d / "last.ckpt.bak.ckpt").write_bytes(b"\x80corrupt")
    future = time.time() + 3600
    os.utime(d / "last.ckpt.bak.ckpt", (future, future))
    trainer = Trainer(callbacks=[ModelCheckpoint(dirpath=str(d))],
                      default_root_dir=str(tmp_path), device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        path, data = trainer._restart_checkpoint(started)
    assert path == str(d / "last.ckpt")
    assert load_state_stream(data)["global_step"] == 4
    assert any("unreadable" in str(w.message) for w in caught)
    os.remove(d / "last.ckpt")
    os.remove(d / "last.ckpt.bak.ckpt")
    path, _ = trainer._restart_checkpoint(started)
    assert path == str(d / "epoch=0-step=2.ckpt")  # not the stale last-old
    os.remove(path)
    assert trainer._restart_checkpoint(started) == (None, None)
