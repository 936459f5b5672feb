"""PyTorch port, training slice: ``gpt_forward`` and the losses, the
optimizer rule, and ``Trainer.fit`` / ``validate`` / checkpoint resume held
against the JAX package on the CPU.

Weights and data are made with numpy and shared: both ``init_params`` are
overridden to return the same numpy tree, and both loaders draw the same
rows (the port's sampler copies the JAX shuffle order). fp32 throughout.
Tolerances: 1e-4 on logits, losses and final parameters (the reference's
bar for model outputs); 5e-5 on gradients (its bar for grads).

Parity traps, pinned here:

- Batch multiplier: under tests/conftest.py JAX has 8 virtual CPU
  devices, so its in-process strategy trains on ``batch_size * 8`` rows
  per step; the port's module takes that product as its ``batch_size``.
- ``fit`` always calls ``init_params``: both sides override it.
- The first update has lr 0 (warmup starts at 0), so GPT fits take 6 steps.
- Clipping is optax's ``g / norm * max`` without epsilon; AdamW is
  optax's with every leaf decayed (``test_adamw_matches_optax``).
- Accumulation keeps the running mean and flushes a partial window at the
  end of an epoch; ``global_step`` counts micro-batches.
- Flash and reference attention round differently: exact comparisons of
  the trainer use ``attn_impl="reference"``; flash is held at fp32.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu.models.boring import BoringModule as JBoring
from ray_lightning_tpu.trainer import Callback as JCallback
from ray_lightning_tpu.trainer import EarlyStopping as JEarlyStopping
from ray_lightning_tpu.trainer import Trainer as JTrainer
from ray_lightning_tpu.trainer.data import DataLoader as JDataLoader
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.boring import BoringModule as TBoring
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.trainer import Callback as TCallback
from ray_lightning_tpu_torch.trainer import EarlyStopping as TEarlyStopping
from ray_lightning_tpu_torch.trainer import Trainer as TTrainer
from ray_lightning_tpu_torch.trainer import lr_find, scale_batch_size
from ray_lightning_tpu_torch.trainer.data import ArrayDataset, DataLoader
from ray_lightning_tpu_torch.trainer.optim import (
    TrainOptimizer,
    warmup_cosine_decay_schedule,
)
from ray_lightning_tpu_torch.utils.state_stream import (
    load_state_stream,
    to_state_stream,
)

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
MULT = len(jax.local_devices())  # the JAX trainer's batch multiplier

#: A gpt2_small()-shaped tiny config (learned positions, gelu, layernorm,
#: MHA, tied head) and a llama()-shaped one (rope, rmsnorm, swiglu, GQA,
#: untied head) with a sliding window and sinks.
CONFIGS = {
    "gpt2": jgpt.GPTConfig(
        vocab_size=64, n_layer=2, n_head=4, d_model=32, max_seq=32
    ),
    "llama_gqa_window_sinks": jgpt.GPTConfig.llama(
        vocab_size=64, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
        max_seq=32, attn_window=6, attn_sinks=2,
    ),
}


def _torch_cfg(cfg):
    return tgpt.GPTConfig(**dataclasses.asdict(cfg))


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return 1.0 + 0.1 * x if name.endswith("_g") else 0.05 * x

    return {
        k: (
            {n: leaf(n, s) for n, s in v.items()}
            if isinstance(v, dict)
            else leaf(k, v)
        )
        for k, v in tgpt.param_shapes(_torch_cfg(cfg)).items()
    }


def _tokens(cfg, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq + 1)).astype(
        np.int32
    )


def _assert_tree_close(t_tree, j_tree, tol):
    t_np = params_to_numpy(t_tree)
    for k, v in j_tree.items():
        if isinstance(v, dict):
            _assert_tree_close(t_tree[k], v, tol)
        else:
            np.testing.assert_allclose(t_np[k], np.asarray(v), err_msg=k, **tol)


# -- the model -----------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gpt_forward_and_loss_grads_match_jax(name):
    """Logits at 1e-4 and the grads of lm_loss at 5e-5 against jax.grad on
    shared weights, through the flash path (plain versions on the CPU, the
    JAX kernels in interpret mode)."""
    cfg = CONFIGS[name]
    np_params = _numpy_params(cfg)
    toks = _tokens(cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)

    def j_loss(p):
        logits = jgpt.gpt_forward(p, jnp.asarray(toks[:, :-1]), cfg)
        return jgpt.lm_loss(logits, jnp.asarray(toks[:, 1:]))[0], logits

    (j_val, j_logits), j_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True)
    )(j_params)

    t_cfg = _torch_cfg(cfg)
    t_params = params_from_jax(np_params, t_cfg, "cpu")
    for leaf in jax.tree_util.tree_leaves(t_params):
        leaf.requires_grad_(True)
    t_toks = torch.from_numpy(toks).long()
    logits = tgpt.gpt_forward(t_params, t_toks[:, :-1], t_cfg)
    loss, _ = tgpt.lm_loss(logits, t_toks[:, 1:])
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(j_val), **TOL)
    # Leaves the forward never reads (RMSNorm's bias) get no torch grad;
    # JAX gives them zeros.
    t_grads = jax.tree_util.tree_map(
        lambda x: torch.zeros_like(x) if x.grad is None else x.grad, t_params
    )
    _assert_tree_close(t_grads, j_grads, GRAD_TOL)


def _loss_and_grads(t_cfg, np_params, toks, chunk=0):
    params = params_from_jax(np_params, t_cfg, "cpu")
    leaves = jax.tree_util.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    t = torch.from_numpy(toks).long()
    if chunk:
        h = tgpt.gpt_forward(params, t[:, :-1], t_cfg, return_hidden=True)
        loss, acc = tgpt.chunked_lm_loss(
            h, tgpt._head_weight(params, t_cfg), t[:, 1:], chunk
        )
    else:
        loss, acc = tgpt.lm_loss(tgpt.gpt_forward(params, t[:, :-1], t_cfg),
                                 t[:, 1:])
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), float(acc), [
        np.zeros(1) if g is None else g.numpy() for g in grads
    ]


@pytest.mark.parametrize("variant", ["chunked_loss", "remat"])
def test_chunked_loss_and_remat_keep_value_and_grads(variant):
    """chunked_lm_loss (a chunk that does not divide S, so the padded tail
    is exercised) and remat give lm_loss's value and grads."""
    cfg = _torch_cfg(CONFIGS["gpt2"])
    np_params = _numpy_params(cfg)
    toks = _tokens(cfg, seed=1)
    base = _loss_and_grads(cfg, np_params, toks)
    if variant == "chunked_loss":
        other = _loss_and_grads(cfg, np_params, toks, chunk=12)
    else:
        other = _loss_and_grads(
            dataclasses.replace(cfg, remat=True), np_params, toks
        )
    np.testing.assert_allclose(other[0], base[0], rtol=1e-6)
    np.testing.assert_allclose(other[1], base[1], rtol=1e-6)
    for a, b in zip(other[2], base[2]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


def test_chunked_loss_ignores_negative_targets_like_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 10, 8)).astype(np.float32)
    wte = rng.standard_normal((16, 8)).astype(np.float32)
    tgt = rng.integers(0, 16, (2, 10)).astype(np.int32)
    tgt[0, 3] = tgt[1, 7] = -1
    j = jgpt.chunked_lm_loss(jnp.asarray(x), jnp.asarray(wte), jnp.asarray(tgt), 4)
    t = tgpt.chunked_lm_loss(
        torch.from_numpy(x), torch.from_numpy(wte), torch.from_numpy(tgt), 4
    )
    for a, b in zip(t, j):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_make_fake_text_is_the_jax_corpus():
    j = jgpt.make_fake_text(8, seq_len=16, vocab=64, seed=3)
    t = tgpt.make_fake_text(8, seq_len=16, vocab=64, seed=3)
    np.testing.assert_array_equal(t.arrays[0], j.arrays[0])


# -- the optimizer rule --------------------------------------------------


def test_schedule_matches_optax():
    j = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 40)
    t = warmup_cosine_decay_schedule(0.0, 3e-4, 5, 40)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6, atol=1e-12)


def _adamw_against_optax(capturable):
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((5, 3)).astype(np.float32)
    grads = [rng.standard_normal((5, 3)).astype(np.float32) for _ in range(4)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100)
    tx = optax.adamw(sched, weight_decay=0.1)
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = torch.tensor(p0, requires_grad=True)
    opt = TrainOptimizer(
        lambda ls: torch.optim.AdamW(ls, lr=0.0, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=0.1),
        [tp], warmup_cosine_decay_schedule(0.0, 1e-2, 2, 100),
        capturable=capturable)
    assert opt.step_in_graph == capturable
    for g in grads:
        plan = opt.plan(1)
        (lr,) = opt.lrs(plan)
        opt.take([torch.from_numpy(g)], *plan[0], torch.tensor(lr))
        if not opt.step_in_graph:
            opt.update(lr)
        opt.commit(plan)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), atol=1e-6)


def test_adamw_matches_optax():
    """torch.optim.AdamW in one group, stepped by the trainer's
    TrainOptimizer on the CPU (its lr set from the schedule before each
    step), is optax.adamw: decay on every leaf scaled by the scheduled
    lr, eps outside the square root."""
    _adamw_against_optax(capturable=False)


def test_capturable_adamw_matches_optax(monkeypatch):
    """The card's update: the same AdamW in torch's capturable mode, the
    scheduled lr a device tensor, inside TrainOptimizer.take (capturable
    Adam accepts only accelerators; its arithmetic is plain tensor ops, so
    the CPU may run it here)."""
    monkeypatch.setattr(importlib.import_module("torch.optim.adam"),
                        "_get_capturable_supported_devices",
                        lambda *a, **k: ["cpu"])
    _adamw_against_optax(capturable=True)


# -- the trainer against the JAX Trainer ---------------------------------


class _JRecord(JCallback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(logs["loss"])


class _TRecord(TCallback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(logs["loss"])


def _boring_weights():
    rng = np.random.default_rng(5)
    return {
        "w": (0.1 * rng.standard_normal((32, 2))).astype(np.float32),
        "b": np.zeros((2,), np.float32),
    }


class _JBoringShared(JBoring):
    def init_params(self, rng, batch):
        return jax.tree_util.tree_map(jnp.asarray, _boring_weights())


class _TBoringShared(TBoring):
    def init_params(self, generator, batch):
        return {k: torch.from_numpy(v) for k, v in _boring_weights().items()}


def _trainers(tmp_path, early_stop_patience=None, **kw):
    common = dict(
        log_every_n_steps=1, seed=0, enable_checkpointing=False,
        enable_model_summary=False,
    )
    common.update(kw)
    jrec, trec = _JRecord(), _TRecord()
    jcb, tcb = [jrec], [trec]
    if early_stop_patience is not None:
        jcb.append(JEarlyStopping(monitor="val_loss", patience=early_stop_patience,
                                  min_delta=0.02))
        tcb.append(TEarlyStopping(monitor="val_loss", patience=early_stop_patience,
                                  min_delta=0.02))
    jt = JTrainer(callbacks=jcb, default_root_dir=str(tmp_path / "jax"), **common)
    tt = TTrainer(callbacks=tcb, default_root_dir=str(tmp_path / "torch"),
                  device="cpu", **common)
    return jt, jrec, tt, trec


# Options per case: plain; accumulation over 3 with a 5-batch epoch, so each
# epoch ends on a partial window of 2 that the flush applies; clipping with
# a limit the grads exceed; limits and the grad-norm log; validation every
# 2 batches (mid-epoch) and every 2nd epoch; max_steps stopping mid-epoch;
# EarlyStopping ending the fit on a mid-epoch validation.
BORING_CASES = {
    "plain": dict(max_epochs=2),
    "accumulate_3_flush": dict(max_epochs=2, accumulate_grad_batches=3),
    "gradient_clip": dict(max_epochs=2, gradient_clip_val=0.05),
    "limits_and_grad_norm": dict(
        max_epochs=3, limit_train_batches=3, log_grad_norm=True,
        limit_val_batches=2,
    ),
    "val_check_interval_2": dict(max_epochs=2, val_check_interval=2),
    "check_val_every_2nd_epoch": dict(max_epochs=3, check_val_every_n_epoch=2),
    "max_steps_mid_epoch": dict(max_epochs=3, max_steps=7),
    "early_stopping": dict(max_epochs=6, val_check_interval=1,
                           early_stop_patience=1),
}


@pytest.mark.parametrize("case", list(BORING_CASES))
def test_boring_fit_matches_jax_trainer(case, tmp_path):
    """Per-step losses and final params at 1e-4; the epoch-end val loss;
    the step counters."""
    kw = BORING_CASES[case]
    jt, jrec, tt, trec = _trainers(tmp_path, **kw)
    # 80 rows at 16 per step: 5 batches per epoch.
    jm = _JBoringShared(dataset_length=80)
    tm = _TBoringShared(dataset_length=80, batch_size=2 * MULT)
    jt.fit(jm)
    tt.fit(tm)
    assert len(trec.losses) == len(jrec.losses) > 0
    np.testing.assert_allclose(trec.losses, jrec.losses, **TOL)
    _assert_tree_close(tm.params, jm.params, TOL)
    assert tt.global_step == jt.global_step
    assert tt.current_epoch == jt.current_epoch
    if case == "early_stopping":
        assert tt.global_step < 6 * 5  # stopped early, where JAX stopped
    np.testing.assert_allclose(
        tt.callback_metrics["val_loss"], jt.callback_metrics["val_loss"], **TOL
    )
    if case == "limits_and_grad_norm":
        np.testing.assert_allclose(
            tt.logged_metrics["grad_norm"], jt.logged_metrics["grad_norm"], **TOL
        )
    if case == "accumulate_3_flush":
        # 2 epochs x (one full window + one flushed partial window).
        assert tt._update_count == jt._update_count == 4


def test_bf16_mixed_precision_casts_like_the_jax_trainer(tmp_path):
    """precision="bf16-mixed": params and batch cast to bf16 inside the
    step, fp32 masters updated with grads that come back through the cast.
    Tolerance: one bf16 unit in the last place (2^-8 relative) on the
    losses; 1e-3 on the params, whose grads carry that rounding."""
    jt, jrec, tt, trec = _trainers(tmp_path, max_epochs=2, precision="bf16-mixed")
    jm = _JBoringShared(dataset_length=80)
    tm = _TBoringShared(dataset_length=80, batch_size=2 * MULT)
    jt.fit(jm)
    tt.fit(tm)
    assert len(trec.losses) == len(jrec.losses) == 10
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=2**-8, atol=1e-6)
    _assert_tree_close(tm.params, jm.params, dict(atol=1e-3, rtol=0))
    assert all(v.dtype == torch.float32 for v in tm.params.values())


def test_validate_counts_real_rows_of_a_wrap_around_tail(tmp_path):
    """72 rows in batches of 16: the last batch holds 8 real rows and 8
    wrap-around rows; the metric is the mean over the 72 real rows, as in
    the JAX Trainer; test() likewise, and predict() trims the padding."""
    jt, _, tt, _ = _trainers(tmp_path)
    jm = _JBoringShared(dataset_length=72)
    tm = _TBoringShared(dataset_length=72, batch_size=2 * MULT)
    jm.params = jax.tree_util.tree_map(jnp.asarray, _boring_weights())
    tm.params = {k: torch.from_numpy(v) for k, v in _boring_weights().items()}
    j = jt.validate(jm)[0]["val_loss"]
    t = tt.validate(tm)[0]["val_loss"]
    x = np.random.default_rng(1).standard_normal((72, 32), dtype=np.float32)
    w = _boring_weights()
    want = float(np.mean(np.mean((x @ w["w"] + w["b"]) ** 2, axis=1)))
    np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(t, want, rtol=1e-5)
    j_test = jt.test(jm)[0]["test_loss"]
    np.testing.assert_allclose(tt.test(tm)[0]["test_loss"], j_test, **TOL)
    preds, j_preds = tt.predict(tm), jt.predict(jm)
    assert sum(p.shape[0] for p in preds) == 72
    np.testing.assert_allclose(
        torch.cat(preds).numpy(), np.concatenate([np.asarray(p) for p in j_preds]),
        **TOL,
    )


def _gpt_cfg():
    return jgpt.GPTConfig(
        vocab_size=64, n_layer=2, n_head=2, d_model=32, max_seq=32,
        attn_impl="reference",
    )


class _JGPTShared(jgpt.GPTLM):
    def init_params(self, rng, batch):
        return jax.tree_util.tree_map(jnp.asarray, _numpy_params(self.config))


class _TGPTShared(tgpt.GPTLM):
    def init_params(self, generator, batch):
        return params_from_jax(_numpy_params(self.config), self.config, "cpu")


@pytest.fixture(scope="module")
def jax_gpt_fit(tmp_path_factory):
    """One JAX GPTLM fit: 3 epochs of 2 steps (16 rows, 8 per step)."""
    tmp = tmp_path_factory.mktemp("jax_gpt")
    jrec = _JRecord()
    jt = JTrainer(
        max_epochs=3, log_every_n_steps=1, seed=0, enable_checkpointing=False,
        enable_model_summary=False, limit_val_batches=2, callbacks=[jrec],
        default_root_dir=str(tmp),
    )
    jm = _JGPTShared(_gpt_cfg(), batch_size=1, n_train=16, warmup_steps=2)
    jt.fit(jm)
    return jt, jm, jrec.losses


def _torch_gpt_trainer(tmp_path, max_epochs, rec):
    return TTrainer(
        max_epochs=max_epochs, log_every_n_steps=1, seed=0,
        enable_checkpointing=False, enable_model_summary=False,
        limit_val_batches=2, callbacks=[rec], default_root_dir=str(tmp_path),
        device="cpu",
    )


def _torch_gpt():
    return _TGPTShared(_torch_cfg(_gpt_cfg()), batch_size=MULT, n_train=16,
                       warmup_steps=2)


def test_gptlm_fit_matches_jax_trainer(jax_gpt_fit, tmp_path):
    jt, jm, j_losses = jax_gpt_fit
    rec = _TRecord()
    tt = _torch_gpt_trainer(tmp_path, 3, rec)
    tm = _torch_gpt()
    tt.fit(tm)
    assert len(rec.losses) == len(j_losses) == 6
    np.testing.assert_allclose(rec.losses, j_losses, **TOL)
    _assert_tree_close(tm.params, jm.params, TOL)
    np.testing.assert_allclose(
        tt.callback_metrics["val_loss"], jt.callback_metrics["val_loss"], **TOL
    )
    np.testing.assert_allclose(tt.current_lr, jt.current_lr, rtol=1e-6)
    # The fitted params serve through the port's gpt_generate.
    out = tm.generate([[1, 2, 3]], max_new_tokens=4)
    assert out.shape == (1, 7)


def test_save_checkpoint_then_resume_reproduces_the_run(jax_gpt_fit, tmp_path):
    """Fit one epoch, save from the Trainer, resume in a new Trainer for
    two more: the losses are the uninterrupted JAX run's (Adam moments and
    the schedule's count come back with the checkpoint)."""
    _, jm, j_losses = jax_gpt_fit
    rec = _TRecord()
    first = _torch_gpt_trainer(tmp_path, 1, rec)
    first.fit(_torch_gpt())
    path = str(tmp_path / "epoch0.ckpt")
    first.save_checkpoint(path)
    second = _torch_gpt_trainer(tmp_path, 3, rec)
    tm = _torch_gpt()
    second.fit(tm, ckpt_path=path)
    assert second.global_step == 6
    np.testing.assert_allclose(rec.losses, j_losses, **TOL)
    _assert_tree_close(tm.params, jm.params, TOL)


def test_model_checkpoint_files_resume(tmp_path):
    """The default ModelCheckpoint writes a resumable file at each
    validation end; ckpt_path='last' finds it."""
    tt = TTrainer(max_epochs=1, seed=0, default_root_dir=str(tmp_path),
                  device="cpu", enable_model_summary=False)
    tm = _TBoringShared(dataset_length=32, batch_size=16)
    tt.fit(tm)
    best = tt.checkpoint_callback.best_model_path
    assert os.path.exists(best)
    with open(best, "rb") as f:
        state = load_state_stream(f.read())
    assert state["global_step"] == 2 and state["opt_state"] is not None
    tt2 = TTrainer(max_epochs=2, seed=0, default_root_dir=str(tmp_path),
                   device="cpu", enable_model_summary=False)
    tt2.fit(_TBoringShared(dataset_length=32, batch_size=16), ckpt_path="last")
    assert tt2.global_step == 4


# -- data, state, entry points --------------------------------------------


@pytest.mark.parametrize("n,bs,shuffle", [(10, 4, True), (12, 4, False), (3, 8, True)])
def test_loader_rows_and_masks_match_jax(n, bs, shuffle):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    j = JDataLoader(ArrayDataset(x), batch_size=bs, shuffle=shuffle).with_sampler(
        num_replicas=1, rank=0, seed=3
    )
    t = DataLoader(ArrayDataset(x), batch_size=bs, shuffle=shuffle).with_sampler(
        num_replicas=1, rank=0, seed=3
    )
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        jb = list(j.iter_batches(1, prefetch=0, with_mask=True))
        tb = list(t.iter_batches(1, with_mask=True))
        assert t.num_batches() == j.num_batches() == len(tb) == len(jb)
        for (tx, tm), (jx, jmask) in zip(tb, jb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(tm, jmask)


def test_state_stream_round_trips_a_training_state():
    state = {
        "params": {"w": torch.randn(3, 2), "h": torch.randn(4).bfloat16()},
        "opt_state": {"state": {0: {"step": torch.tensor(3.0)}},
                      "param_groups": [{"lr": 0.1, "params": [0]}]},
        "epoch": 2, "mid_epoch": False, "tags": ("a", None),
        "table": np.arange(6).reshape(2, 3),
    }
    back = load_state_stream(to_state_stream(state))
    assert back["params"]["w"].equal(state["params"]["w"])
    assert back["params"]["h"].dtype == torch.bfloat16
    assert back["params"]["h"].equal(state["params"]["h"])
    assert back["opt_state"]["state"][0]["step"].item() == 3.0
    assert back["opt_state"]["param_groups"] == state["opt_state"]["param_groups"]
    assert back["epoch"] == 2 and back["tags"] == ("a", None)
    np.testing.assert_array_equal(back["table"], state["table"])


class _JNoticeAt(JCallback):
    """Records a preemption notice on this process once ``global_step``
    reaches ``at`` (tests/test_preempt.py:787)."""

    def __init__(self, at):
        self.at, self.fired = at, False

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        from ray_lightning_tpu.serve.preempt import get_monitor

        if not self.fired and trainer.global_step >= self.at:
            self.fired = True
            get_monitor().notice(grace_s=3600.0, source="test")


class _TNoticeAt(TCallback):
    def __init__(self, at):
        self.at, self.fired = at, False

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        from ray_lightning_tpu_torch.serve.preempt import get_monitor

        if not self.fired and trainer.global_step >= self.at:
            self.fired = True
            get_monitor().notice(grace_s=3600.0, source="test")


@pytest.mark.parametrize("fold", [1, 2])
def test_preempt_notice_checkpoints_and_resumes_exact(tmp_path, fold):
    """Checkpoint-on-notice (tests/test_preempt.py:827-908): a notice at
    step 2 raises TrainingPreempted with a validated checkpoint that
    carries the epoch position; a fresh fit from it continues the epoch
    with the partial accumulation window kept and ends on the
    uninterrupted fit's parameters, bit for bit, and on the JAX package's
    preempted-and-resumed fit's within 1e-4. With ``steps_per_execution``
    the notice is answered at the next chunk boundary."""
    from ray_lightning_tpu.serve.preempt import reset_monitor as j_reset
    from ray_lightning_tpu.trainer.loop import TrainingPreempted as JPreempted
    from ray_lightning_tpu_torch.serve.preempt import reset_monitor as t_reset
    from ray_lightning_tpu_torch.trainer import TrainingPreempted

    kw = dict(max_epochs=2, seed=0, num_sanity_val_steps=0,
              check_val_every_n_epoch=10 ** 9, log_every_n_steps=1,
              accumulate_grad_batches=2, enable_model_summary=False,
              steps_per_execution=fold)

    def t_fit(root, cbs=(), ckpt=None):
        tt = TTrainer(callbacks=list(cbs), default_root_dir=str(root),
                      device="cpu", **kw)
        tm = _TBoringShared(dataset_length=80, batch_size=2 * MULT)
        tt.fit(tm, ckpt_path=ckpt)
        return tt, tm

    _, base = t_fit(tmp_path / "base")
    t_reset()
    try:
        with pytest.raises(TrainingPreempted) as exc:
            t_fit(tmp_path / "pre", [_TNoticeAt(2)])
    finally:
        t_reset()
    path = exc.value.ckpt_path
    assert os.path.basename(path) == (
        f"last-preempt-step{exc.value.global_step:08d}.ckpt")
    assert exc.value.global_step == 2
    with open(path, "rb") as f:
        state = load_state_stream(f.read())
    assert state["resume_batch"] == exc.value.global_step
    assert state["mid_epoch"] is True
    tt, resumed = t_fit(tmp_path / "resume", ckpt=path)
    assert tt.global_step == 10
    for k in ("w", "b"):
        assert torch.equal(resumed.params[k], base.params[k]), k
    if fold > 1:
        return  # the JAX loop folds through stacked batches; held above
    jkw = {k: v for k, v in kw.items() if k != "steps_per_execution"}
    j_reset()
    try:
        jt = JTrainer(callbacks=[_JNoticeAt(2)],
                      default_root_dir=str(tmp_path / "jax"), **jkw)
        with pytest.raises(JPreempted) as jexc:
            jt.fit(_JBoringShared(dataset_length=80))
    finally:
        j_reset()
    assert jexc.value.global_step == exc.value.global_step
    jm = _JBoringShared(dataset_length=80)
    JTrainer(default_root_dir=str(tmp_path / "jax2"), **jkw).fit(
        jm, ckpt_path=jexc.value.ckpt_path)
    _assert_tree_close(resumed.params, jm.params, TOL)


@pytest.mark.parametrize(
    "kwargs,item",
    [
        (dict(ema_decay=0.9), "item 15"),
        (dict(eval_ema=True), "item 15"),
        (dict(detect_anomaly=True), "item 15"),
        (dict(overfit_batches=2), "item 15"),
        (dict(fast_dev_run=True), "item 15"),
    ],
)
def test_unported_trainer_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        TTrainer(device="cpu", **kwargs)


def test_async_checkpointing_and_sharded_saves_construct():
    """``async_checkpointing`` and ``ModelCheckpoint(save_sharded=True)``
    are ported (their fits: tests/test_torch_checkpoint_io.py): both
    construct and reach the loop's spec."""
    from ray_lightning_tpu_torch.trainer import ModelCheckpoint

    ck = ModelCheckpoint(save_sharded=True)
    t = TTrainer(device="cpu", async_checkpointing=True, callbacks=[ck])
    assert ck.save_sharded and t.async_checkpointing
    assert t._make_spec().async_checkpointing


def test_unported_strategies_and_finders_raise():
    """The four launched strategies construct a Trainer (their fits are
    held in tests/test_torch_strategies.py, tests/test_torch_gspmd.py and
    tests/test_torch_launch.py); the mesh axes the port does not run (seq,
    ep, pp, sequence parallelism) still raise, naming item 13."""
    from ray_lightning_tpu_torch.strategies import (
        GSPMDStrategy,
        HorovodRayStrategy,
        RayShardedStrategy,
        RayStrategy,
        SingleDeviceStrategy,
    )

    for strategy in (
        RayStrategy(num_workers=2, use_gpu=False),
        HorovodRayStrategy(num_workers=2, use_gpu=False),
        RayShardedStrategy(num_workers=2, use_gpu=False, zero_stage=3),
        GSPMDStrategy(num_workers=2, use_gpu=False,
                      mesh_shape={"model": 2}),
    ):
        assert TTrainer(strategy=strategy).strategy is strategy
    for kw in (dict(mesh_shape={"pp": 2}), dict(mesh_shape={"ep": 2}),
               dict(mesh_shape={"seq": 2}, sequence_parallel=True)):
        with pytest.raises(NotImplementedError, match="item 13"):
            GSPMDStrategy(num_workers=2, use_gpu=False, **kw)
    TTrainer(strategy=SingleDeviceStrategy("cpu"))
    with pytest.raises(NotImplementedError, match="item 14"):
        lr_find(TTrainer(device="cpu"), TBoring())
    with pytest.raises(NotImplementedError, match="item 14"):
        scale_batch_size(TTrainer(device="cpu"), TBoring())


def test_trainer_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TTrainer()
