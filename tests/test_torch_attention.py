"""PyTorch port, attention ops: the flash plain version and the reference
held against the JAX package on the CPU, on inputs made with numpy.

The JAX flash kernel runs in Pallas interpret mode (its own CPU path); the
port's flash wrapper takes the plain version for CPU tensors. Tolerance
2e-5 in fp32, the reference's own bar (tests/test_ops.py). Ahead of the
card, the bf16 forward kernel's arithmetic (64-key tiles, exp2 with the
scale in the exponent, P rounded to bf16 before P V) is emulated in plain
PyTorch and held at ``chip_smoke.py``'s bf16 bar; and the kernel build is
checked to follow its shared headers.
"""
import importlib
import math
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu.ops.attention import attention_reference as jax_reference
from ray_lightning_tpu_torch.ops import _build
from ray_lightning_tpu_torch.ops.attention import (
    attention_reference,
    band_allowed,
)
from ray_lightning_tpu_torch.ops.flash_attention import (
    _flash_fwd_cuda,
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


def _fwd_kernel_arithmetic(q, k, v, causal, scale, window, sinks):
    """The bf16 forward kernel's arithmetic in plain PyTorch: raw scores
    Q K^T in fp32 from the bf16 inputs, key tiles of 64 walked with the
    online softmax, the running max kept in units of s * scale * log2 e and
    p = exp2(s * scale * log2 e - m), P rounded to bf16 where it enters
    P V, l and O in fp32, out rounded once, lse in natural-log units."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if causal:
        row = torch.arange(seq_q)[:, None]
        col = torch.arange(seq_k)[None, :]
        s = s.masked_fill(~band_allowed(row, col, window, sinks), -math.inf)
    scale_log2 = scale * math.log2(math.e)
    m = torch.full(s.shape[:-1], -math.inf)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(s.shape[:-1] + (q.shape[-1],))
    for c0 in range(0, seq_k, 64):
        st = s[..., c0:c0 + 64]
        m_new = torch.maximum(m, st.amax(-1) * scale_log2)
        alpha = torch.where(m == -math.inf, 0.0, torch.exp2(m - m_new))
        p = torch.where(st == -math.inf, 0.0,
                        torch.exp2(st * scale_log2 - m_new[..., None]))
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(),
                          v[:, c0:c0 + 64].float())
        o = o * alpha[..., None] + pv
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (o / l_safe[..., None]).permute(0, 2, 1, 3).to(torch.bfloat16)
    return out, m * math.log(2.0) + torch.log(l_safe)


#: chip_smoke.py's bf16 bar for a kernel against its plain version.
BF16_ATOL, BF16_RTOL, LSE_TOL = 1e-2, 1e-2, 1e-3


@pytest.mark.parametrize("causal,window,sinks",
                         [(True, 0, 0), (False, 0, 0), (True, 1, 0),
                          (True, 1, 4)])
@pytest.mark.parametrize("seq,head_dim", [(256, 64), (40, 64), (128, 128)])
def test_bf16_fwd_kernel_arithmetic_meets_the_card_bar(
    seq, head_dim, causal, window, sinks
):
    """The bf16 forward kernel's arithmetic, emulated, stays within
    chip_smoke.py's bf16 tolerance of the fp32 plain version: causal,
    non-causal, window and window + sinks (window S // 4 at least 5, as
    chip_smoke.py), a ragged S=40 and D=128 (B=1, H=2)."""
    window = max(5, seq // 4) if window else 0
    q, k, v = (
        torch.from_numpy(a).to(torch.bfloat16)
        for a in _qkv(seq, batch=1, heads=2, head_dim=head_dim, seed=5)
    )
    scale = head_dim ** -0.5
    out, lse = _fwd_kernel_arithmetic(q, k, v, causal, scale, window, sinks)
    ref, ref_lse = flash_attention_plain(q, k, v, causal, scale, window,
                                         sinks)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    err = (out.float() - ref.float()).abs()
    assert bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all()), (
        float(err.max())
    )
    assert float((lse - ref_lse).abs().max()) <= LSE_TOL


def test_bf16_fwd_kernel_takes_a_positive_scale():
    """The bf16 kernel keeps the running max of the unscaled scores, which
    is the scaled max only for a positive scale: the wrapper raises before
    any launch otherwise (fp32 takes any scale)."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(64, batch=1, heads=1, head_dim=64))
    for bad in (0.0, -0.125, float("nan")):
        with pytest.raises(ValueError, match="sm_scale > 0"):
            _flash_fwd_cuda(q, k, v, True, bad, 0, 0)
    assert torch_fa._fn is None


def test_kernel_build_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by the hash of its source, every shared header
    and the flags: an edited header rebuilds, and nvcc is told where the
    headers are (a copy of a source elsewhere still finds them)."""
    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    headers = sorted(src.glob("*.cuh"))
    assert headers
    before = {n: _build._lib_path(n) for n in ("flash_fwd", "flash_bwd")}
    assert before == {n: _build._lib_path(n) for n in before}
    headers[0].write_bytes(headers[0].read_bytes() + b"\n")
    after = {n: _build._lib_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    cmd = _build.nvcc_command(tmp_path / "copy.cu", tmp_path / "lib.so")
    assert cmd[cmd.index("-I") + 1] == str(src)


def test_kernel_is_not_built_on_import():
    """The CUDA libraries are loaded only when a CUDA tensor needs them."""
    assert torch_fa._fn is None
    assert torch_fa._bwd_fns is None


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys; import ray_lightning_tpu_torch.serve.engine, "
        "ray_lightning_tpu_torch.serve.scheduler, "
        "ray_lightning_tpu_torch.serve.metrics, "
        "ray_lightning_tpu_torch.serve.server, "
        "ray_lightning_tpu_torch.serve.faults, "
        "ray_lightning_tpu_torch.serve.preempt, "
        "ray_lightning_tpu_torch.serve.kvfleet, "
        "ray_lightning_tpu_torch.serve.router, "
        "ray_lightning_tpu_torch.serve.client, "
        "ray_lightning_tpu_torch.serve, "
        "ray_lightning_tpu_torch.fabric, "
        "ray_lightning_tpu_torch.fabric.core, "
        "ray_lightning_tpu_torch.fabric.worker, "
        "ray_lightning_tpu_torch.fabric.queue, "
        "ray_lightning_tpu_torch.fabric.cluster_utils, "
        "ray_lightning_tpu_torch.utils.ports, "
        "ray_lightning_tpu_torch.utils.graphs, "
        "ray_lightning_tpu_torch.obs.health, "
        "ray_lightning_tpu_torch.obs.blackbox, "
        "ray_lightning_tpu_torch.obs.fleet, "
        "ray_lightning_tpu_torch.obs, "
        "ray_lightning_tpu_torch.obs.trace, "
        "ray_lightning_tpu_torch.obs.events, "
        "ray_lightning_tpu_torch.obs.registry, "
        "ray_lightning_tpu_torch.obs.anatomy, "
        "ray_lightning_tpu_torch.obs.journal, "
        "ray_lightning_tpu_torch.serve.kvstore, "
        "ray_lightning_tpu_torch.utils.quantize, "
        "ray_lightning_tpu_torch.models.weights, "
        "ray_lightning_tpu_torch.models.gpt, "
        "ray_lightning_tpu_torch.models.boring, "
        "ray_lightning_tpu_torch.trainer, "
        "ray_lightning_tpu_torch.trainer.trainer, "
        "ray_lightning_tpu_torch.trainer.loop, "
        "ray_lightning_tpu_torch.trainer.data, "
        "ray_lightning_tpu_torch.trainer.module, "
        "ray_lightning_tpu_torch.trainer.callbacks, "
        "ray_lightning_tpu_torch.trainer.optim, "
        "ray_lightning_tpu_torch.strategies, "
        "ray_lightning_tpu_torch.strategies.base, "
        "ray_lightning_tpu_torch.strategies.ddp, "
        "ray_lightning_tpu_torch.strategies.ring, "
        "ray_lightning_tpu_torch.strategies.sharded, "
        "ray_lightning_tpu_torch.launchers, "
        "ray_lightning_tpu_torch.launchers.utils, "
        "ray_lightning_tpu_torch.launchers.gpu_launcher, "
        "ray_lightning_tpu_torch.parallel, "
        "ray_lightning_tpu_torch.parallel.env, "
        "ray_lightning_tpu_torch.parallel.mesh, "
        "ray_lightning_tpu_torch.parallel.zero, "
        "ray_lightning_tpu_torch.utils.rank_zero, "
        "ray_lightning_tpu_torch.utils.seed, "
        "ray_lightning_tpu_torch.utils.state_stream, "
        "ray_lightning_tpu_torch.utils.summary, "
        "ray_lightning_tpu_torch.utils.tree; "
        "import ray_lightning_tpu_torch as p; "
        "[getattr(p, n) for n in p.__all__]; "
        "import ray_lightning_tpu_torch.serve as s; "
        "[getattr(s, n) for n in s.__all__]; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'ray_lightning_tpu' or m.startswith('ray_lightning_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: A port actor that reports its own process's modules after importing the
#: fleet's serving stack: pickled by value (defined in the driver's
#: ``__main__``), so the worker imports no test module.
_ACTOR_DRIVER = """
import sys
from ray_lightning_tpu_torch import fabric


class Probe:
    def modules(self):
        import ray_lightning_tpu_torch.serve.client
        import ray_lightning_tpu_torch.serve.server
        import ray_lightning_tpu_torch.serve.engine
        import ray_lightning_tpu_torch.serve.kvfleet
        import ray_lightning_tpu_torch.serve.kvstore
        import ray_lightning_tpu_torch.obs.health
        return [m for m in sys.modules if m == "jax" or m.startswith("jax.")
                or m == "ray_lightning_tpu"
                or m.startswith("ray_lightning_tpu.")], sys.argv


if __name__ == "__main__":
    fabric.init(num_cpus=1)
    try:
        actor = fabric.remote(Probe).options(num_cpus=1).remote()
        bad, argv = fabric.get(actor.modules.remote(), timeout=120)
    finally:
        fabric.shutdown()
    print(bad, argv)
    sys.exit(1 if bad or "fabric/worker.py" not in argv[0] else 0)
"""


def test_spawned_port_actor_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A fabric actor of the port is ``python -m
    ray_lightning_tpu_torch.fabric.worker``; with the serving stack
    imported, its own ``sys.modules`` holds neither ``jax`` nor
    ``ray_lightning_tpu``."""
    script = tmp_path / "driver.py"
    script.write_text(_ACTOR_DRIVER)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, RLT_NUM_GPUS="0")
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=180, env=env,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
