"""PyTorch port, attention ops: the flash plain version and the reference
held against the JAX package on the CPU, on inputs made with numpy.

The JAX flash kernel runs in Pallas interpret mode (its own CPU path); the
port's flash wrapper takes the plain version for CPU tensors. Tolerance
2e-5 in fp32, the reference's own bar (tests/test_ops.py).
"""
import importlib
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.attention import attention_reference as jax_reference
from ray_lightning_tpu_torch.ops.attention import attention_reference
from ray_lightning_tpu_torch.ops.flash_attention import (
    counters,
    flash_attention,
    flash_attention_plain,
)

# The ops packages re-export the functions under the modules' own names.
jax_fa = importlib.import_module("ray_lightning_tpu.ops.flash_attention")
torch_fa = importlib.import_module("ray_lightning_tpu_torch.ops.flash_attention")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(seq_q=32, seq_k=None, batch=2, heads=2, head_dim=16, seed=0):
    rng = np.random.default_rng(seed)
    seq_k = seq_k or seq_q
    return (
        rng.standard_normal((batch, seq_q, heads, head_dim), np.float32),
        rng.standard_normal((batch, seq_k, heads, head_dim), np.float32),
        rng.standard_normal((batch, seq_k, heads, head_dim), np.float32),
    )


# (causal, window, sinks, seq_q, seq_k, block): non-causal self and cross
# attention, causal, a window wider and one narrower than the block (rows
# fully masked inside a visited block), window + sinks (prefix loop).
FLASH_CASES = [
    (False, 0, 0, 32, 32, 16),
    (False, 0, 0, 16, 48, 16),
    (True, 0, 0, 32, 32, 16),
    (True, 12, 0, 48, 48, 16),
    (True, 5, 0, 32, 32, 16),
    (True, 12, 4, 64, 64, 16),
    (True, 5, 3, 48, 48, 16),
]


@pytest.mark.parametrize("causal,window,sinks,sq,sk,block", FLASH_CASES)
def test_flash_plain_matches_jax_kernel(causal, window, sinks, sq, sk, block):
    q, k, v = _qkv(sq, sk)
    scale = 1.0 / np.sqrt(q.shape[-1])
    j_out, j_lse = jax_fa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        block, block, True, window, sinks,
    )
    t_out, t_lse = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, scale, window, sinks,
    )
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), **TOL)


# (causal, window, sinks, seq_q, seq_k): the decode-style Sq < Sk case
# checks the mask's end alignment.
REF_CASES = [
    (False, 0, 0, 24, 24),
    (True, 0, 0, 24, 24),
    (True, 7, 0, 24, 24),
    (True, 7, 3, 24, 24),
    (True, 0, 0, 8, 24),
    (True, 5, 2, 8, 24),
]


@pytest.mark.parametrize("causal,window,sinks,sq,sk", REF_CASES)
def test_attention_reference_matches_jax(causal, window, sinks, sq, sk):
    q, k, v = _qkv(sq, sk, seed=1)
    ref = jax_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, sinks=sinks,
    )
    out = attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, sinks=sinks,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# (seq_q, seq_k, causal, block_q, block_k): divisible and aligned shapes,
# a ragged sequence, a clipped block that is not 8-aligned (65), causal
# cross attention, short sequences under the default 128 blocks.
PATH_CASES = [
    (32, 32, True, 16, 16),
    (24, 24, True, 16, 16),
    (65, 65, True, 128, 128),
    (16, 32, True, 16, 16),
    (16, 32, False, 16, 16),
    (8, 8, True, 128, 128),
    (40, 40, True, 128, 128),
    (12, 12, True, 128, 128),
]


@pytest.mark.parametrize("sq,sk,causal,bq,bk", PATH_CASES)
def test_reference_path_taken_where_jax_takes_it(
    sq, sk, causal, bq, bk, monkeypatch
):
    """The port's wrapper goes to the reference for exactly the shapes the
    JAX wrapper does, and both wrappers agree on the values."""
    q, k, v = _qkv(sq, sk, batch=1, heads=1, head_dim=8, seed=2)
    jax_calls = []
    real_ref = jax_fa.attention_reference

    def spy(*args, **kwargs):
        jax_calls.append(1)
        return real_ref(*args, **kwargs)

    monkeypatch.setattr(jax_fa, "attention_reference", spy)
    j_out = jax_fa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=bq, block_k=bk,
    )
    before = counters.reference
    t_out = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, block_q=bq, block_k=bk,
    )
    assert (counters.reference - before) == len(jax_calls)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)


def test_cpu_tensor_never_counts_a_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(32))
    before = counters.launches
    flash_attention(q, k, v, causal=True, block_q=16, block_k=16)
    flash_attention(q, k, v, causal=True, window=5, sinks=2)
    flash_attention(q, k, v, causal=False)
    assert counters.launches == before


def test_flash_argument_checks_match_jax():
    q, k, v = (torch.from_numpy(a) for a in _qkv(16))
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window must be >= 0"):
        flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="sinks only apply"):
        flash_attention(q, k, v, sinks=2)


def test_kernel_is_not_built_on_import():
    """The CUDA library is loaded only when a CUDA tensor needs it."""
    assert torch_fa._fn is None


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys; import ray_lightning_tpu_torch.serve.engine, "
        "ray_lightning_tpu_torch.serve.scheduler, "
        "ray_lightning_tpu_torch.models.weights; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ray_lightning_tpu' or m.startswith('ray_lightning_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
