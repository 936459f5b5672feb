"""PyTorch port, model zoo: ResNet-18/CIFAR (``models/resnet.py``) held
against the JAX package's flax ``ResNet18`` on the CPU
(``tests/test_resnet.py`` is the bar).

The flax module's own initialised tree crosses over through the bridge
(``models/weights.py``) as a copy: the port keeps flax's tree and HWIO
kernels. Tolerances: 1e-4 on logits (the ROADMAP bar), 1e-6 on the
optimizer's elementwise update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_lightning_tpu.models import resnet as jresnet
from ray_lightning_tpu_torch.models import resnet as tresnet
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.strategies.base import SingleDeviceStrategy

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    oversubscribed the cores (see tests/test_torch_bert.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_tree():
    """The flax module's own initialised tree (width 8; a tree fits any
    image size) as numpy."""
    model = jresnet.ResNet18(num_classes=10, width=8)
    tree = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return model, jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("size", [32, 33])
def test_flax_tree_gives_flax_logits(flax_tree, size):
    """The flax-initialised tree, bridged, gives flax's logits at 1e-4:
    the stride-2 first blocks of stages 1-3 included (flax's SAME pads an
    even input 0 before and 1 after, an odd one 1 and 1)."""
    model, tree = flax_tree
    t_model = tresnet.ResNet18(num_classes=10, width=8)
    params = params_from_jax(tree, t_model.param_shapes(3), "cpu")
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(model.apply)(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x)))
    got = t_model.apply(params, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, **TOL)


def test_param_tree_and_count_equal_flax():
    """``test_resnet.py:14``: the port's init has flax's tree, shapes and
    parameter count (CIFAR ResNet-18 at width 64, ~11.2M; flax's shapes by
    ``jax.eval_shape``), and gives finite logits on normalised uint8
    images."""
    flax_shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(jresnet.ResNet18(num_classes=10, width=64).init,
                       jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    module = tresnet.CIFARResNet(width=64)
    data = tresnet.make_fake_cifar(4)
    x, y = data.arrays[0][:2], data.arrays[1][:2]
    params = module.init_params(torch.Generator().manual_seed(0), (x, y))
    shapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert shapes == flax_shapes
    n_params = sum(int(v.numel()) for v in jax.tree_util.tree_leaves(params))
    assert n_params == sum(int(np.prod(s)) for s in jax.tree_util.tree_leaves(
        flax_shapes, is_leaf=lambda s: isinstance(s, tuple)))
    assert 10_500_000 < n_params < 12_000_000, n_params
    with torch.no_grad():
        logits = module._forward(params, module._prep(torch.from_numpy(x)))
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()


def test_fake_cifar_equals_jax_and_uint8_stays_uint8():
    """The same numpy draws as the JAX fixture; the loader hands uint8
    batches through and the strategy places them as uint8 (4x fewer bytes
    than fp32): the module normalises on the device."""
    j, t = jresnet.make_fake_cifar(64, seed=3), tresnet.make_fake_cifar(64, seed=3)
    for a, b in zip(j.arrays, t.arrays):
        np.testing.assert_array_equal(a, b)
    module = tresnet.CIFARResNet(batch_size=8, n_train=64, width=8)
    batch = next(iter(module.train_dataloader().iter_batches(1)))
    assert batch[0].dtype == np.uint8
    placed = SingleDeviceStrategy("cpu").place_batch(batch)
    assert placed[0].dtype == torch.uint8
    x = module._prep(placed[0])
    assert x.dtype == torch.float32
    np.testing.assert_allclose(
        x.numpy(), np.asarray(jresnet.ImageClassifierModule._prep(
            jnp.asarray(batch[0]))), rtol=1e-6, atol=1e-6)


def test_sgd_with_weight_decay_matches_the_optax_chain(flax_tree):
    """Three steps of ``configure_optimizers``'s SGD (momentum 0.9, weight
    decay 5e-4) against the JAX module's ``chain(add_decayed_weights,
    sgd)`` on the same parameters and the same gradients (numpy-made: at
    ResNet's initialisation the fp32 gradients of either package are only
    good to ~1e-3, its one-channel GroupNorm groups being ill-conditioned),
    parameters at 1e-6 after each step."""
    _, tree = flax_tree
    jm = jresnet.CIFARResNet(width=8, lr=0.05)
    tm = tresnet.CIFARResNet(width=8, lr=0.05)
    tx = jm.configure_optimizers()
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(j_params)
    t_params = params_from_jax(tree, tm.model.param_shapes(3), "cpu")
    leaves = jax.tree_util.tree_leaves(t_params)
    opt = tm.configure_optimizers()(leaves)
    rng = np.random.default_rng(6)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        upd, opt_state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, j_params)
        j_params = optax.apply_updates(j_params, upd)
        for leaf, g in zip(leaves, jax.tree_util.tree_leaves(
                params_from_jax(grads, tm.model.param_shapes(3), "cpu"))):
            leaf.grad = g
        opt.step()
        got = params_to_numpy(t_params)
        for path, want in jax.tree_util.tree_leaves_with_path(j_params):
            node = got
            for key in path:
                node = node[key.key]
            np.testing.assert_allclose(node, np.asarray(want), rtol=1e-6,
                                       atol=1e-6,
                                       err_msg=jax.tree_util.keystr(path))
