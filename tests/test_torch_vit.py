"""PyTorch port, model zoo: the Vision Transformer (``models/vit.py``) held
against the JAX package's ``models/vit.py`` on the CPU
(``tests/test_vit.py`` is the bar), and the image classifiers' shared
size guard.

Weights are made with numpy and moved to both sides through the bridge.
Tolerances: 1e-4 on logits, 5e-5 on gradients (the ROADMAP bars).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.vit as jvit
from ray_lightning_tpu_torch.models import vit as tvit
from ray_lightning_tpu_torch.models.resnet import CIFARResNet, make_fake_cifar
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.ops import attention_reference
from ray_lightning_tpu_torch.ops.flash_attention import counters, flash_attention
from ray_lightning_tpu_torch.trainer import Trainer

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
TINY = dict(image_size=16, patch_size=4, n_layer=2, n_head=2, d_model=32,
            d_ff=64, attn_impl="reference")


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


def _numpy_params(cfg, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return 1.0 + 0.1 * x if name.endswith("_g") else 0.1 * x

    return {
        k: ({n: leaf(n, s) for n, s in v.items()} if isinstance(v, dict)
            else leaf(k, v))
        for k, v in tvit.vit_param_shapes(cfg).items()
    }


def test_patchify_is_exact_reshape():
    """``test_vit.py:20``: patch (i, j) is image[i*ps:(i+1)*ps, ...]
    flattened row-major, and the port's patches equal the JAX package's."""
    cfg = tvit.ViTConfig(**TINY)
    img = np.arange(16 * 16 * 3, dtype=np.float32).reshape(1, 16, 16, 3)
    out = tvit.patchify(torch.from_numpy(img), cfg).numpy()
    assert out.shape == (1, 16, 4 * 4 * 3)
    np.testing.assert_array_equal(out[0, 0].reshape(4, 4, 3), img[0, :4, :4])
    np.testing.assert_array_equal(out[0, 5].reshape(4, 4, 3), img[0, 4:8, 4:8])
    np.testing.assert_array_equal(
        out, np.asarray(jvit.patchify(jnp.asarray(img), jvit.ViTConfig(**TINY))))


@pytest.mark.parametrize("attn_impl", ["reference", "flash"])
def test_logits_and_grads_match_jax(attn_impl):
    """Logits at 1e-4 and the cross entropy's grads at 5e-5 against the
    JAX forward and jax.grad on shared weights (17 rows: both packages'
    flash wrappers take the reference path)."""
    kw = dict(TINY, attn_impl=attn_impl)
    j_cfg, t_cfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    np_params = _numpy_params(t_cfg)
    x = np.random.default_rng(1).normal(size=(3, 16, 16, 3)).astype(np.float32)
    y = np.array([1, 4, 7], np.int32)

    def j_loss(p):
        logits = jvit.vit_forward(p, jnp.asarray(x), j_cfg)
        ce = -jax.nn.log_softmax(logits)[jnp.arange(3), y].mean()
        return ce, logits

    (j_val, j_logits), j_grads = jax.jit(jax.value_and_grad(
        j_loss, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, np_params))
    params = params_from_jax(np_params, t_cfg, "cpu")
    for leaf in jax.tree_util.tree_leaves(params):
        leaf.requires_grad_(True)
    logits = tvit.vit_forward(params, torch.from_numpy(x), t_cfg)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y).long())
    loss.backward()
    assert logits.shape == (3, t_cfg.num_classes)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits),
                               **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(j_val), **TOL)
    got = params_to_numpy(jax.tree_util.tree_map(lambda p: p.grad, params))
    for path, want in jax.tree_util.tree_leaves_with_path(j_grads):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, np.asarray(want), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_config_validation():
    """``test_vit.py:49``: the JAX package's ``__post_init__`` errors."""
    with pytest.raises(ValueError, match="patch_size"):
        tvit.ViTConfig(image_size=30, patch_size=4)
    with pytest.raises(ValueError, match="n_head"):
        tvit.ViTConfig(d_model=30, n_head=4)


def test_image_size_guard_and_agnostic_resnet():
    """``test_vit.py:56``: ViT (positional embeddings) rejects a dataset of
    another image size, naming ``image_size``; ResNet (global pool) trains
    on any size."""
    bad = make_fake_cifar(32, size=16)
    vit = tvit.ViTClassifier(
        config=tvit.ViTConfig(**dict(TINY, image_size=32)), batch_size=8,
        dataset=bad,
    )
    with pytest.raises(ValueError, match="image_size"):
        vit.train_dataloader()
    resnet = CIFARResNet(batch_size=8, n_train=32, width=8,
                         dataset=make_fake_cifar(32, size=48))
    t = Trainer(max_epochs=1, enable_checkpointing=False, seed=0,
                num_sanity_val_steps=0, limit_val_batches=1, device="cpu")
    t.fit(resnet)
    assert math.isfinite(t.callback_metrics["loss_epoch"])


def test_65_rows_take_the_reference_path():
    """``test_vit.py:85``: 65 = 8x8 patches + 1 is not 8-aligned, so the
    flash wrapper takes the reference path (counted) and gives its values
    exactly."""
    g = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(g.standard_normal((2, 65, 2, 8)).astype(
        np.float32)) for _ in range(3))
    counters.reset()
    out = flash_attention(q, k, v, causal=False)
    assert counters.reference == 1 and counters.launches == 0
    assert torch.equal(out, attention_reference(q, k, v, causal=False))
    counters.reset()


def test_vit_trains_in_process():
    """``test_vit.py:99``: an in-process fit on the separable fake CIFAR
    brings the epoch loss under ln(10) and the validation accuracy over
    0.5; every attention call took the counted reference path."""
    module = tvit.ViTClassifier(
        config=tvit.ViTConfig(**dict(TINY, image_size=32, attn_impl="flash")),
        lr=3e-3, batch_size=16, n_train=128,
    )
    trainer = Trainer(max_epochs=3, enable_checkpointing=False, seed=0,
                      num_sanity_val_steps=0, device="cpu")
    counters.reset()
    trainer.fit(module)
    assert counters.launches == 0 and counters.reference > 0
    counters.reset()
    assert trainer.callback_metrics["loss_epoch"] < np.log(10)
    assert trainer.callback_metrics["val_accuracy"] > 0.5


def test_optimizer_is_optax_adamw():
    """``optax.adamw(lr)`` decays by 1e-4 (torch's default is 0.01); with
    warmup the schedule is optax's warmup-cosine."""
    import optax

    module = tvit.ViTClassifier(config=tvit.ViTConfig(**TINY), lr=2e-3)
    opt = module.configure_optimizers()([torch.zeros(2, requires_grad=True)])
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["lr"] == 2e-3
    warm = tvit.ViTClassifier(config=tvit.ViTConfig(**TINY), lr=2e-3,
                              warmup_steps=5).configure_optimizers()
    want = optax.warmup_cosine_decay_schedule(0.0, 2e-3, 5, 100)
    for step in (0, 3, 5, 40, 99):
        np.testing.assert_allclose(warm["lr_schedule"](step),
                                   float(want(step)), rtol=1e-5, atol=1e-9)
    assert dataclasses.asdict(module.config) == dataclasses.asdict(
        jvit.ViTConfig(**TINY))
