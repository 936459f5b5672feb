"""PyTorch port, flash-attention backward: the plain version of K2 + K3 and
autograd through the port's ``flash_attention`` held against ``jax.vjp``
of the JAX package's ``flash_attention`` in Pallas interpret mode (the JAX
tests' own CPU path, tests/test_ops.py), on inputs made with numpy.

fp32, tolerance 5e-5 on gradients: the reference's own bar
(tests/test_ops.py:51). On the CPU the wrapper takes the plain versions,
so the kernel counters stay at 0; the kernels themselves are held against
the plain version on the card by ``chip_smoke.py``. Two more checks run
here ahead of the card: the bf16 kernels' rounding of P and dS, emulated
in plain PyTorch, meets ``chip_smoke.py``'s bf16 bar against the fp32
plain backward; and the wrapper's 16-byte alignment rule for bf16 inputs.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch.ops.attention import band_allowed
from ray_lightning_tpu_torch.ops.flash_attention import (
    _check_cuda_inputs,
    _flash_fwd_cuda,
    counters,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
)

jax_fa = importlib.import_module("ray_lightning_tpu.ops.flash_attention")
TOL = dict(atol=5e-5, rtol=5e-5)


def _inputs(seq_q, seq_k, batch=2, heads=2, head_dim=16, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((batch, seq_q, heads, head_dim), np.float32),
        rng.standard_normal((batch, seq_k, heads, head_dim), np.float32),
        rng.standard_normal((batch, seq_k, heads, head_dim), np.float32),
        rng.standard_normal((batch, seq_q, heads, head_dim), np.float32),
    )


@functools.lru_cache(maxsize=None)
def _jax_grads_cached(sq, sk, seed, causal, window, sinks, block):
    q, k, v, do = _inputs(sq, sk, seed=seed)
    return _jax_grads(q, k, v, do, causal, window, sinks, block)


def _jax_grads(q, k, v, do, causal, window, sinks, block):
    def f(q, k, v):
        return jax_fa.flash_attention(
            q, k, v, causal=causal, block_q=block, block_k=block,
            interpret=True, window=window, sinks=sinks,
        )

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


# (causal, window, sinks, seq_q, seq_k, block): non-causal self and cross
# attention, causal, a window wider and one narrower than the block, window
# + sinks with the sinks inside one block and spanning two.
CASES = [
    (False, 0, 0, 32, 32, 16),
    (False, 0, 0, 16, 48, 16),
    (True, 0, 0, 32, 32, 16),
    (True, 12, 0, 48, 48, 16),
    (True, 5, 0, 32, 32, 16),
    (True, 12, 4, 64, 64, 16),
    (True, 5, 3, 48, 48, 16),
    (True, 6, 20, 64, 64, 16),
]


@pytest.mark.parametrize("causal,window,sinks,sq,sk,block", CASES)
def test_bwd_plain_matches_jax_vjp(causal, window, sinks, sq, sk, block):
    q, k, v, do = _inputs(sq, sk)
    scale = 1.0 / np.sqrt(q.shape[-1])
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = flash_attention_plain(tq, tk, tv, causal, scale, window, sinks)
    got = flash_attention_bwd_plain(
        tq, tk, tv, out, lse, tdo, causal, scale, window, sinks
    )
    want = _jax_grads_cached(sq, sk, 0, causal, window, sinks, block)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize("causal,window,sinks,sq,sk,block", CASES)
def test_autograd_through_flash_matches_jax(causal, window, sinks, sq, sk, block):
    q, k, v, do = _inputs(sq, sk)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = (counters.launches, counters.bwd_dkv_launches,
              counters.bwd_dq_launches, counters.reference)
    out = flash_attention(
        tq, tk, tv, causal=causal, block_q=block, block_k=block,
        window=window, sinks=sinks,
    )
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want = _jax_grads_cached(sq, sk, 0, causal, window, sinks, block)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
    # A CPU tensor takes the plain versions: no kernel counts a launch and
    # the shape rule kept the flash path.
    assert (counters.launches, counters.bwd_dkv_launches,
            counters.bwd_dq_launches, counters.reference) == before


@pytest.mark.parametrize("sq,sk,causal", [(24, 24, True), (16, 32, True)])
def test_reference_path_shapes_still_take_the_reference(sq, sk, causal):
    """Shapes the JAX rule sends to the reference (ragged, causal cross
    attention) still go there, and their grads still match JAX."""
    q, k, v, do = _inputs(sq, sk, seed=2)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    before = counters.reference
    out = flash_attention(tq, tk, tv, causal=causal, block_q=16, block_k=16)
    assert counters.reference == before + 1
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    want = _jax_grads(q, k, v, do, causal, 0, 0, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_bwd_plain_keeps_input_dtypes():
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(32, 32, seed=3))
    out, lse = flash_attention_plain(q, k, v, True, None, 0, 0)
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, do, True)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert all(torch.isfinite(g.float()).all() for g in (dq, dk, dv))


def _bwd_kernel_arithmetic(q, k, v, out, lse, do, causal, scale, window,
                           sinks):
    """The bf16 backward kernels' arithmetic in plain PyTorch: bf16 inputs,
    fp32 products and sums, P and dS rounded to bf16 where they enter the
    P^T dO, dS^T Q and dS K products, each output rounded once."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        row = torch.arange(q.shape[1])[:, None]
        col = torch.arange(k.shape[1])[None, :]
        p = torch.where(band_allowed(row, col, window, sinks), p, 0.0)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    p16 = p.to(torch.bfloat16).float()
    ds16 = ds.to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", ds16, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds16, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p16, dof)
    return tuple(g.to(torch.bfloat16) for g in (dq, dk, dv))


#: chip_smoke.py's bf16 bar for a kernel against its plain version.
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2


@pytest.mark.parametrize("window,sinks", [(0, 0), (64, 0), (64, 4)])
def test_bf16_rounding_of_p_and_ds_meets_the_card_bar(window, sinks):
    """Rounding P and dS to bf16 before their products, as the tensor-core
    kernels do, stays within chip_smoke.py's bf16 tolerance of the fp32
    plain backward (causal, B=2, S=256, H=2, D=64)."""
    q, k, v, do = (
        torch.from_numpy(x).to(torch.bfloat16)
        for x in _inputs(256, 256, head_dim=64, seed=4)
    )
    scale = 64 ** -0.5
    out, lse = flash_attention_plain(q, k, v, True, scale, window, sinks)
    got = _bwd_kernel_arithmetic(q, k, v, out, lse, do, True, scale, window,
                                 sinks)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, True, scale,
                                     window, sinks)
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs()
        assert torch.isfinite(g.float()).all()
        assert bool((err <= BF16_ATOL + BF16_RTOL * w.float().abs()).all()), (
            float(err.max())
        )
    # The rounding is visible: the two are not the same function.
    assert any(not torch.equal(g, w) for g, w in zip(got, want))


def test_bf16_kernel_inputs_must_be_16_byte_aligned():
    """The bf16 kernels copy 16-byte rows: a bf16 q/k/v whose base pointer
    or (batch, seq, head) strides are not multiples of 16 bytes raises; the
    strided views of a fused projection pass; fp32 has no such rule."""
    base = torch.zeros((2, 32, 3, 2, 64), dtype=torch.bfloat16)
    q, k, v = base.unbind(2)  # seq stride 3*2*64, offsets of 2*64 elements
    _check_cuda_inputs(q, k, v, True)
    shifted = torch.zeros(2 * 32 * 2 * 64 + 1, dtype=torch.bfloat16)[1:]
    bad_ptr = shifted.view(2, 32, 2, 64)
    with pytest.raises(ValueError, match="16-byte"):
        _check_cuda_inputs(bad_ptr, k, v, True)
    odd = torch.zeros((2, 32, 2, 68), dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        _check_cuda_inputs(q, k, odd, True)
    _check_cuda_inputs(*(x.float() for x in (bad_ptr, k, odd)), True)


@pytest.mark.cuda_hw
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,sinks", [(True, 0, 0), (False, 0, 0),
                                                 (True, 40, 0), (True, 40, 4)])
def test_kernels_match_plain_on_the_card(causal, window, sinks, dtype):
    """K1, K2 and K3 through autograd on the card against the plain
    versions: fp32 at 1e-4, bf16 at chip_smoke.py's bar (needs a CUDA card
    and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else BF16_ATOL
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((2, 128, 4, 64), generator=gen, device="cuda")
                   .to(dt) for _ in range(4))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (counters.launches, counters.bwd_dkv_launches,
              counters.bwd_dq_launches)
    out = flash_attention(*leaves, causal=causal, window=window, sinks=sinks)
    got = torch.autograd.grad(out, leaves, do)
    assert (counters.launches, counters.bwd_dkv_launches,
            counters.bwd_dq_launches) == tuple(b + 1 for b in before)
    p_out, lse = flash_attention_plain(q, k, v, causal, None, window, sinks)
    want = flash_attention_bwd_plain(q, k, v, p_out, lse, do, causal, None,
                                     window, sinks)
    torch.testing.assert_close(out, p_out, atol=tol, rtol=tol)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol)


@pytest.mark.cuda_hw
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("causal,window,sinks", [(True, 0, 0), (False, 0, 0),
                                                 (True, 40, 0), (True, 40, 4)])
def test_forward_matches_plain_at_the_training_layout_on_the_card(
    causal, window, sinks, head_dim
):
    """K1 in bf16 on q/k/v that are the strided views of a fused
    (B, S, 3, H, D) projection, the layout the training step and the
    serving prefill hand it: out and lse against the plain version at
    chip_smoke.py's bar, and a second launch bitwise equal (needs a CUDA
    card and nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    gen = torch.Generator(device="cuda").manual_seed(2)
    fused = torch.randn((2, 256, 3, 4, head_dim), generator=gen,
                        device="cuda").to(torch.bfloat16)
    q, k, v = fused.unbind(2)
    scale = head_dim ** -0.5
    before = counters.launches
    out, lse = _flash_fwd_cuda(q, k, v, causal, scale, window, sinks)
    again = _flash_fwd_cuda(q, k, v, causal, scale, window, sinks)
    assert counters.launches == before + 2
    ref, ref_lse = flash_attention_plain(q, k, v, causal, scale, window, sinks)
    torch.testing.assert_close(out.float(), ref.float(), atol=BF16_ATOL,
                               rtol=BF16_RTOL)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=0.0)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
