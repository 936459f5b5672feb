"""PyTorch port, model zoo: the XOR and MNIST fixtures (``models/xor.py``,
``models/mnist.py``) held against the JAX package's on the CPU.

The datasets are the same numpy draws. Fits share numpy weights (both
``init_params`` overridden) and rows (the port's sampler copies the JAX
shuffle order); under tests/conftest.py the JAX trainer has 8 virtual
devices, so the port's ``batch_size`` is the JAX one x 8. Both optimizers
are Adam (``torch.optim.Adam`` against ``optax.adam``). Tolerance: 1e-4 on
per-step losses, final parameters and validation metrics.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.models import mnist as jmnist
from ray_lightning_tpu.models import xor as jxor
from ray_lightning_tpu.trainer import Callback as JCallback
from ray_lightning_tpu.trainer import Trainer as JTrainer
from ray_lightning_tpu_torch.models import mnist as tmnist
from ray_lightning_tpu_torch.models import xor as txor
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.trainer import Callback as TCallback
from ray_lightning_tpu_torch.trainer import Trainer as TTrainer

TOL = dict(atol=1e-4, rtol=1e-4)
MULT = len(jax.local_devices())  # the JAX trainer's batch multiplier


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    oversubscribed the cores (see tests/test_torch_bert.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(shapes, seed):
    """Fan-in-scaled normal weights (He's scale, as both fixtures draw)
    and small random biases."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * (np.sqrt(2.0 / s[0]) if len(s) == 2
                                          else 0.05)).astype(np.float32)
            for k, s in shapes.items()}


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


def _shared(cls, tree, jax_side):
    """``cls`` with ``init_params`` returning ``tree`` on its side."""

    class Shared(cls):
        def init_params(self, *args):
            if jax_side:
                return jax.tree_util.tree_map(jnp.asarray, tree)
            return params_from_jax(tree, tree_shapes, "cpu")

    tree_shapes = {k: v.shape for k, v in tree.items()}
    return Shared


def _fit_both(j_module, t_module, **kw):
    common = dict(log_every_n_steps=1, seed=0, enable_checkpointing=False,
                  enable_model_summary=False, num_sanity_val_steps=0, **kw)
    jrec, trec = _JRecord(), _TRecord()
    jt = JTrainer(callbacks=[jrec], **common)
    tt = TTrainer(callbacks=[trec], device="cpu", **common)
    jt.fit(j_module)
    tt.fit(t_module)
    assert len(trec.losses) == len(jrec.losses) > 0
    np.testing.assert_allclose(trec.losses, jrec.losses, **TOL)
    got = params_to_numpy(t_module.params)
    for k, v in j_module.params.items():
        np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k, **TOL)
    assert tt.global_step == jt.global_step
    return jt, tt


@pytest.mark.parametrize("name", ["xor", "mnist"])
def test_datasets_equal_jax(name):
    """The same rows and labels from the same seeds."""
    if name == "xor":
        pairs = [(jxor.xor_dataset(3), txor.xor_dataset(3))]
    else:
        pairs = [(jmnist.make_fake_mnist(64, seed=s),
                  tmnist.make_fake_mnist(64, seed=s)) for s in (0, 7)]
    for j, t in pairs:
        for a, b in zip(j.arrays, t.arrays):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_xor_fit_matches_the_jax_trainer():
    """The exact-metric fixture: 8 rows per step, per-step losses, final
    parameters and the validation metrics equal the JAX Trainer's; the
    DataModule's loaders give the same rows."""
    tree = _weights(txor.XORModule().param_shapes(), seed=1)
    jm = _shared(jxor.XORModule, tree, True)(lr=0.1, batch_size=1)
    tm = _shared(txor.XORModule, tree, False)(lr=0.1, batch_size=MULT)
    jt, tt = _fit_both(jm, tm, max_epochs=6)
    for key in ("val_loss", "val_acc"):
        np.testing.assert_allclose(tt.callback_metrics[key],
                                   jt.callback_metrics[key], **TOL)
    dm = txor.XORDataModule(batch_size=4, repeat=2)
    rows = [b for b in dm.train_dataloader()]
    assert len(rows) == 2 and rows[0][0].shape == (4, 2)
    np.testing.assert_array_equal(np.concatenate([r[1] for r in rows]),
                                  np.tile([0, 1, 1, 0], 2))


def test_mnist_fit_matches_the_jax_trainer():
    """The accuracy-bound fixture: two shuffled steps per epoch, per-step
    losses, final parameters and ``ptl/val_*`` equal the JAX Trainer's, and
    the fit clears the 0.5 accuracy bound."""
    tree = _weights(tmnist.MNISTClassifier(hidden=32).param_shapes(), seed=2)
    jm = _shared(jmnist.MNISTClassifier, tree, True)(hidden=32, batch_size=32)
    tm = _shared(tmnist.MNISTClassifier, tree, False)(hidden=32,
                                                      batch_size=32 * MULT)
    jt, tt = _fit_both(jm, tm, max_epochs=4)
    for key in ("ptl/val_loss", "ptl/val_accuracy"):
        np.testing.assert_allclose(tt.callback_metrics[key],
                                   jt.callback_metrics[key], **TOL)
    assert tt.callback_metrics["ptl/val_accuracy"] > 0.5
    preds = torch.cat(tt.predict(tm))
    assert preds.shape == (128,)


def test_fixture_inits_have_the_jax_shapes():
    """The port's own initialisers draw the JAX trees' shapes (other
    draws) on the generator's device."""
    batch = tmnist.make_fake_mnist(4).arrays
    for t, j, b in ((txor.XORModule(), jxor.XORModule(), (txor._X, txor._Y)),
                    (tmnist.MNISTClassifier(), jmnist.MNISTClassifier(), batch)):
        got = t.init_params(torch.Generator().manual_seed(0), b)
        want = j.init_params(jax.random.PRNGKey(0), b)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(np.shape(v)) for k, v in want.items()}
