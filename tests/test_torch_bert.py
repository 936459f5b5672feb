"""PyTorch port, model zoo: BERT masked-LM pretraining (``models/bert.py``)
held against the JAX package's ``models/bert.py`` on the CPU
(``tests/test_bert.py`` is the bar).

Weights are made with numpy and moved to both sides through the bridge
(``models/weights.py``). JAX's threefry draws cannot be reproduced, so the
forward and the loss are held on (inputs, targets) made with numpy, and the
port's masking is held to its contract. Tolerances: 1e-4 on logits and
losses, 5e-5 on gradients (the ROADMAP bars); the chunked loss against the
dense one at the JAX test's own bars.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.bert as jbert
from ray_lightning_tpu_torch.models import bert as tbert
from ray_lightning_tpu_torch.models.gpt import chunked_lm_loss
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.trainer import Callback, Trainer

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
TINY = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_seq=32,
            attn_impl="reference")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    oversubscribed the cores (an in-process fit ran ~50x slower than
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    args = dict(TINY, **kw)
    return jbert.BERTConfig(**args), tbert.BERTConfig(**args)


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return 1.0 + 0.1 * x if name.endswith("_g") else 0.05 * x

    return {
        k: ({n: leaf(n, s) for n, s in v.items()} if isinstance(v, dict)
            else leaf(k, v))
        for k, v in tbert.bert_param_shapes(cfg).items()
    }


def _masked(cfg, batch=3, seed=1):
    """Numpy-made (inputs, targets) with the masking's layout: 15% of the
    positions selected, their inputs [MASK], their targets the tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.mask_id, (batch, cfg.max_seq)).astype(np.int32)
    sel = rng.random(toks.shape) < 0.15
    sel[:, 0] = True  # every row has a target
    inputs = np.where(sel, cfg.mask_id, toks).astype(np.int32)
    targets = np.where(sel, toks, -1).astype(np.int32)
    return inputs, targets


def _assert_tree_close(t_tree, j_tree, tol):
    t_np = params_to_numpy(t_tree)
    for path, want in jax.tree_util.tree_leaves_with_path(j_tree):
        node = t_np
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(want),
                                   err_msg=jax.tree_util.keystr(path), **tol)


def _port_loss_grads(t_cfg, np_params, inputs, targets, chunk=0):
    params = params_from_jax(np_params, t_cfg, "cpu")
    for leaf in jax.tree_util.tree_leaves(params):
        leaf.requires_grad_(True)
    x, t = torch.from_numpy(inputs), torch.from_numpy(targets).long()
    if chunk:
        hidden = tbert.bert_forward(params, x, t_cfg, return_hidden=True)
        loss, acc = chunked_lm_loss(hidden, params["wte"], t, chunk)
        logits = None
    else:
        logits = tbert.bert_forward(params, x, t_cfg)
        loss, acc = tbert.masked_lm_loss(logits, t)
    loss.backward()
    grads = jax.tree_util.tree_map(lambda p: p.grad, params)
    return loss.detach(), acc, logits, grads


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_forward_and_mlm_loss_grads_match_jax(attn_impl):
    """Logits at 1e-4 and masked_lm_loss's value and grads at 5e-5 against
    the JAX forward and jax.grad on shared weights, through the reference
    and the flash path (the plain versions here, the JAX kernels in
    interpret mode)."""
    j_cfg, t_cfg = _cfgs(attn_impl=attn_impl)
    np_params = _numpy_params(t_cfg)
    inputs, targets = _masked(t_cfg)

    def j_loss(p):
        logits = jbert.bert_forward(p, jnp.asarray(inputs), j_cfg)
        loss, acc = jbert.masked_lm_loss(logits, jnp.asarray(targets))
        return loss, (acc, logits)

    (j_val, (j_acc, j_logits)), j_grads = jax.jit(
        jax.value_and_grad(j_loss, has_aux=True)
    )(jax.tree_util.tree_map(jnp.asarray, np_params))
    loss, acc, logits, grads = _port_loss_grads(t_cfg, np_params, inputs,
                                                targets)
    assert logits.shape == (3, t_cfg.max_seq, t_cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               **TOL)
    np.testing.assert_allclose(float(loss), float(j_val), **TOL)
    np.testing.assert_allclose(float(acc), float(j_acc), **TOL)
    _assert_tree_close(grads, j_grads, GRAD_TOL)


def test_flash_matches_reference_like_jax():
    """``test_bert.py:21``: the flash path within 2e-2 of the reference on
    the JAX init (the port's flash runs its plain version here)."""
    j_cfg, t_cfg = _cfgs()
    tree = jax.tree_util.tree_map(
        np.asarray, jbert.init_bert_params(jax.random.PRNGKey(0), j_cfg))
    params = params_from_jax(tree, t_cfg, "cpu")
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 64, (2, 32)).astype(np.int32))
    ref = tbert.bert_forward(params, toks, t_cfg)
    flash = tbert.bert_forward(params, toks,
                               dataclasses.replace(t_cfg, attn_impl="flash"))
    assert ref.shape == (2, 32, 64) and torch.isfinite(ref).all()
    np.testing.assert_allclose(flash.detach().numpy(), ref.detach().numpy(),
                               atol=2e-2)


@pytest.mark.parametrize("variant", ["chunked", "remat"])
def test_chunked_loss_and_remat_keep_value_and_grads(variant):
    """``test_bert.py:139``: chunked_lm_loss on ignore-labelled targets
    equals the dense masked_lm_loss (value rtol 1e-5, accuracy 1e-6, grads
    2e-4), with a chunk that does not divide S; remat keeps both."""
    _, t_cfg = _cfgs()
    np_params = _numpy_params(t_cfg, seed=2)
    inputs, targets = _masked(t_cfg, seed=3)
    base = _port_loss_grads(t_cfg, np_params, inputs, targets)
    if variant == "chunked":
        other = _port_loss_grads(t_cfg, np_params, inputs, targets, chunk=12)
    else:
        other = _port_loss_grads(dataclasses.replace(t_cfg, remat=True),
                                 np_params, inputs, targets)
    np.testing.assert_allclose(float(other[0]), float(base[0]), rtol=1e-5)
    np.testing.assert_allclose(float(other[1]), float(base[1]), rtol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(other[3]),
                    jax.tree_util.tree_leaves(base[3])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4, atol=1e-6)


def test_forward_is_bidirectional():
    """Perturbing the LAST token changes the FIRST position's logits (a
    causal forward would keep them bit-identical)."""
    _, t_cfg = _cfgs()
    params = params_from_jax(_numpy_params(t_cfg), t_cfg, "cpu")
    toks = np.random.default_rng(1).integers(0, 64, (1, 32)).astype(np.int32)
    toks2 = toks.copy()
    toks2[0, -1] = (toks2[0, -1] + 1) % t_cfg.vocab_size
    a = tbert.bert_forward(params, torch.from_numpy(toks), t_cfg)[0, 0]
    b = tbert.bert_forward(params, torch.from_numpy(toks2), t_cfg)[0, 0]
    assert float((a - b).abs().max()) > 1e-6


def test_mlm_masking_contract():
    """``test_bert.py:52``: selected positions carry the original token as
    target, unselected inputs pass through, ~15% selected, 70-90% of the
    selected inputs [MASK]."""
    _, t_cfg = _cfgs()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, t_cfg.mask_id, (8, 128)).astype(np.int32))
    gen = torch.Generator().manual_seed(0)
    inputs, targets = tbert.apply_mlm_masking(gen, toks, t_cfg)
    assert inputs.dtype == targets.dtype == toks.dtype
    sel = targets >= 0
    assert torch.equal(targets[sel], toks[sel])
    assert torch.equal(inputs[~sel], toks[~sel])
    assert torch.equal(targets[~sel], torch.full_like(targets[~sel], -1))
    rate = float(sel.float().mean())
    assert 0.10 < rate < 0.20, rate
    mask_frac = float((inputs[sel] == t_cfg.mask_id).float().mean())
    assert 0.7 < mask_frac < 0.9, mask_frac


def test_mlm_random_branch_never_emits_mask_token():
    """``test_bert.py:77``: with vocab 2 and [MASK] = 0 a mask-contaminated
    random branch lifts the [MASK] share of selected inputs from 0.80 to
    0.85 (~30 sigma at n~65k); with an interior [MASK] id the random
    tokens cover both sides of it and never it."""
    _, t_cfg = _cfgs()
    cfg = dataclasses.replace(t_cfg, vocab_size=2, mask_token_id=0,
                              mask_prob=1.0)
    toks = torch.ones((16, 4096), dtype=torch.int32)
    inputs, targets = tbert.apply_mlm_masking(
        torch.Generator().manual_seed(2), toks, cfg)
    sel = targets >= 0
    assert bool(sel.all())
    mask_frac = float((inputs[sel] == cfg.mask_id).float().mean())
    assert 0.78 < mask_frac < 0.82, mask_frac

    cfg = dataclasses.replace(t_cfg, vocab_size=8, mask_token_id=3,
                              mask_prob=1.0)
    toks = torch.full((16, 4096), 5, dtype=torch.int32)
    inputs, _ = tbert.apply_mlm_masking(torch.Generator().manual_seed(3),
                                        toks, cfg)
    randomized = inputs[(inputs != cfg.mask_id) & (inputs != 5)]
    assert randomized.numel() > 0
    seen = set(torch.unique(randomized).tolist())
    assert cfg.mask_id not in seen
    assert seen & {0, 1, 2} and seen & {4, 6, 7}, seen


def test_generator_states_give_different_masks():
    """Two seeds draw different masks; one seed draws the same masks
    again (the training step's generator is reseeded from (seed, step))."""
    _, t_cfg = _cfgs()
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, t_cfg.mask_id, (4, 32)).astype(np.int32))

    def draw(seed):
        return tbert.apply_mlm_masking(torch.Generator().manual_seed(seed),
                                       toks, t_cfg)

    a, b, again = draw(0), draw(1), draw(0)
    assert not torch.equal(a[1], b[1])
    assert torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])


class _Record(Callback):
    def __init__(self):
        self.losses = []

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(logs["loss"])


def _fit(cfg, epochs, **kw):
    module = tbert.BERTEncoder(config=cfg, **kw)
    rec = _Record()
    trainer = Trainer(max_epochs=epochs, enable_checkpointing=False,
                      enable_model_summary=False, seed=0,
                      num_sanity_val_steps=0, log_every_n_steps=1,
                      check_val_every_n_epoch=8, callbacks=[rec],
                      device="cpu")
    trainer.fit(module)
    return module, trainer, rec.losses


def test_fit_beats_the_causal_bound_and_fills_masks():
    """``test_bert.py:189``, in process: an MLM fit with the chunked loss
    brings the masked-token CE well below the uniform ln(V) floor (a masked
    token is recoverable from its neighbours); every step re-masks from
    its per-step seed (a second fit's first epoch gives the same losses,
    up to the CPU's threaded sums, 1e-5; other masks would move them by
    far more); ``fill_mask`` keeps unmasked positions and never emits
    [MASK]."""
    _, t_cfg = _cfgs(max_seq=64, loss_chunk=16)
    kw = dict(batch_size=32, n_train=512, lr=1e-3, warmup_steps=20)
    module, trainer, losses = _fit(t_cfg, 8, **kw)
    _, _, again = _fit(t_cfg, 1, **kw)
    assert len(losses) == 8 * 16 and len(again) == 16
    np.testing.assert_allclose(again, losses[:16], rtol=1e-5)
    loss = float(trainer.callback_metrics["loss"])
    assert math.isfinite(loss)
    assert loss < 0.85 * math.log(t_cfg.mask_id), loss
    assert math.isfinite(trainer.callback_metrics["val_loss"])

    toks = tbert.make_fake_text(4, seq_len=63, vocab=t_cfg.mask_id,
                                seed=11).arrays[0]
    masked = toks.copy()
    holes = np.random.default_rng(0).random(toks.shape) < 0.15
    masked[holes] = t_cfg.mask_id
    filled = module.fill_mask(masked).numpy()
    np.testing.assert_array_equal(filled[~holes], toks[~holes])
    assert not (filled == t_cfg.mask_id).any()
