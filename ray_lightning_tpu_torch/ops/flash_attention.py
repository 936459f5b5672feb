"""Flash attention forward: a hand-written Hopper kernel and its plain version.

``flash_attention`` keeps the JAX wrapper's argument checks and its rule
for when the reference path is taken (``ray_lightning_tpu/ops/
flash_attention.py:421-448``), so the port takes that path for exactly the
same shapes. Past the rule, the tensor's device decides:

- a CPU tensor goes to :func:`flash_attention_plain`, a dense PyTorch
  computation of the same function (the CPU tests hold it against the JAX
  kernel in interpret mode);
- a CUDA tensor goes to the kernel in ``csrc/flash_fwd.cu``, or raises.
  There is no fallback.

Forward only: the backward kernels (the TPU package's ``_dkv_kernel`` and
``_dq_kernel``) are ROADMAP queue 2 work, and a CUDA input that requires
grad is refused.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ray_lightning_tpu_torch.ops.attention import (
    attention_reference,
    band_allowed,
)


@dataclass
class KernelCounters:
    """Plain counts of what :func:`flash_attention` did. ``launches`` goes
    up by one where the CUDA kernel is launched and nowhere else;
    ``reference`` counts calls the shape rule sent to the reference."""

    launches: int = 0
    reference: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.reference = 0


counters = KernelCounters()

#: Head dims the kernel is instantiated for (csrc/flash_fwd.cu).
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    window: int = 0,
    sinks: int = 0,
) -> torch.Tensor:
    """Flash attention on (B, S, H, D) tensors -> (B, Sq, H, D).

    ``block_q``/``block_k`` only feed the shape rule shared with the JAX
    package (the kernel's own tiles are fixed in its source). ``window=W``
    is causal sliding-window attention; ``sinks=N`` keeps the first N
    positions visible to every query.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if window and not causal:
        raise ValueError("window attention requires causal=True")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sinks and not window:
        raise ValueError("sinks only apply with a sliding window")
    if takes_reference_path(q.shape[1], k.shape[1], causal, block_q, block_k):
        counters.reference += 1
        return attention_reference(
            q, k, v, causal=causal, sm_scale=sm_scale, window=int(window),
            sinks=int(sinks),
        )
    if q.device.type == "cpu":
        out, _ = flash_attention_plain(
            q, k, v, causal, sm_scale, int(window), int(sinks)
        )
    elif q.device.type == "cuda":
        out, _ = _flash_fwd_cuda(
            q, k, v, causal, sm_scale, int(window), int(sinks)
        )
    else:
        raise ValueError(f"no flash attention for device {q.device}")
    return out


def takes_reference_path(
    seq_q: int, seq_k: int, causal: bool, block_q: int = 128,
    block_k: int = 128,
) -> bool:
    """The JAX wrapper's rule: the reference path unless both sequence
    lengths divide by their clipped block, both blocks are multiples of 8,
    and causal attention is self-attention (Sq == Sk)."""
    bq, bk = min(block_q, seq_q), min(block_k, seq_k)
    return bool(
        seq_q % bq
        or seq_k % bk
        or (causal and seq_q != seq_k)
        or bq % 8
        or bk % 8
    )


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: int = 0,
    sinks: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (out, lse fp32 (B, H, Sq)).

    Same arithmetic choices as the TPU kernel: inputs upcast to fp32, q
    scaled before the product, ``-inf`` band masking, a fully masked row
    giving output 0 and lse ``-inf``. Dense over (Sq, Sk): it is the
    yardstick of correctness, not of speed.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    seq_q, seq_k = q.shape[1], k.shape[1]
    if causal and seq_q != seq_k:
        raise ValueError("causal flash kernel requires Sq == Sk (self-attention)")
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * sm_scale, k.float())
    if causal:
        row = torch.arange(seq_q, device=q.device)[:, None]
        col = torch.arange(seq_k, device=q.device)[None, :]
        s = s.masked_fill(~band_allowed(row, col, window, sinks), float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.permute(
        0, 2, 1, 3
    )
    lse = (m + torch.log(l_safe))[..., 0]
    return out.to(q.dtype), lse


def _kernel():
    global _fn
    if _fn is None:
        from ray_lightning_tpu_torch.ops import _build

        fn = _build.load("flash_fwd").rlt_flash_fwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # Every pointer and the stream as c_void_p: ctypes would otherwise
        # pass a Python int as a 32-bit int and cut the address.
        fn.argtypes = (
            [ptr] * 5 + [i32] * 5 + [i64] * 9
            + [ctypes.c_float, i32, i32, i32, i32, i32, ptr]
        )
        fn.restype = i32
        _fn = fn
    return _fn


def _flash_fwd_cuda(q, k, v, causal, sm_scale, window, sinks):
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "the CUDA flash attention is forward-only: its backward kernels "
            "(dK/dV and dQ) are ROADMAP queue 2 items K2 and K3; run "
            "under torch.no_grad() or use attention_reference for training"
        )
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash attention takes (B, S, H, D) tensors")
    batch, seq_q, heads, head_dim = q.shape
    seq_k = k.shape[1]
    if k.shape != (batch, seq_k, heads, head_dim) or v.shape != k.shape:
        raise ValueError(
            f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q "
            f"{tuple(q.shape)} (repeat GQA kv heads before the call)"
        )
    if causal and seq_q != seq_k:
        raise ValueError("causal flash kernel requires Sq == Sk (self-attention)")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"the CUDA kernel takes float32 or bfloat16 q/k/v of one dtype, "
            f"got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the CUDA kernel is built for head_dim in {KERNEL_HEAD_DIMS}, "
            f"got {head_dim}"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must be on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last (head_dim) axis of q/k/v must be contiguous")
    if batch * heads > 65535:
        raise ValueError("batch * heads must be <= 65535 (grid y limit)")
    out = torch.empty(
        (batch, seq_q, heads, head_dim), dtype=q.dtype, device=q.device
    )
    lse = torch.empty((batch, heads, seq_q), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(),
        batch, heads, seq_q, seq_k, head_dim,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(sm_scale), int(causal), int(window), int(sinks),
        _DTYPE_CODES[q.dtype], q.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: cudaError {err}")
    counters.launches += 1
    return out, lse
