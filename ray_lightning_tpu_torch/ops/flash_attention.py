"""Flash attention: hand-written Hopper kernels and their plain versions.

``flash_attention`` keeps the JAX wrapper's argument checks and its rule
for when the reference path is taken (``ray_lightning_tpu/ops/
flash_attention.py:421-448``), so the port takes that path for exactly the
same shapes. Past the rule, the call goes through :class:`_FlashAttention`,
the counterpart of the JAX package's ``_flash`` custom VJP, and the
tensor's device decides each pass:

- a CPU tensor goes to :func:`flash_attention_plain` forward and
  :func:`flash_attention_bwd_plain` backward, dense PyTorch computations
  of the same functions (the CPU tests hold them against the JAX kernels
  in interpret mode);
- a CUDA tensor goes to the kernel in ``csrc/flash_fwd.cu`` forward (K1)
  and to the two kernels in ``csrc/flash_bwd.cu`` backward (K2: dK/dV,
  K3: dQ), or raises. There is no fallback. In bf16 all three run on the
  tensor cores (wgmma) and load their tiles by TMA, so bf16 q, k, v must
  have 16-byte aligned base pointers and (batch, seq, head) strides, and
  the forward takes sm_scale > 0; fp32 runs on the SIMT kernels and has
  no such rule.
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
    """Plain counts of what :func:`flash_attention` did. ``launches``,
    ``bwd_dkv_launches`` and ``bwd_dq_launches`` each go up by one where
    their CUDA kernel (K1, K2, K3) is launched and nowhere else;
    ``reference`` counts calls the shape rule sent to the reference."""

    launches: int = 0
    bwd_dkv_launches: int = 0
    bwd_dq_launches: int = 0
    reference: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.bwd_dkv_launches = 0
        self.bwd_dq_launches = 0
        self.reference = 0


counters = KernelCounters()

#: Head dims the kernels are instantiated for (csrc/flash_fwd.cu,
#: csrc/flash_bwd.cu).
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_bwd_fns = None


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no flash attention for device {q.device}")
    return _FlashAttention.apply(
        q, k, v, bool(causal), float(sm_scale), int(window), int(sinks)
    )


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward (the JAX package's ``_flash``
    custom VJP, ``flash_attention.py:170-186``). Forward saves (q, k, v,
    out, lse); backward forms delta = rowsum(dO * O) and runs K2 and K3 on
    CUDA, or the dense plain backward on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window, sinks):
        if q.device.type == "cuda":
            out, lse = _flash_fwd_cuda(q, k, v, causal, sm_scale, window, sinks)
        else:
            out, lse = flash_attention_plain(
                q, k, v, causal, sm_scale, window, sinks
            )
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, window, sinks)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            dq, dk, dv = _flash_bwd_cuda(q, k, v, out, lse, do, *ctx.args)
        else:
            dq, dk, dv = flash_attention_bwd_plain(
                q, k, v, out, lse, do, *ctx.args
            )
        return dq, dk, dv, None, None, None, None


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


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: int = 0,
    sinks: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' function (K2 + K3) in plain PyTorch:
    (dq, dk, dv) in the dtypes of q, k, v.

    fp32 math from the same inputs the kernels read: P is recomputed as
    exp(q k^T * scale - lse), 0 where the band masks the score;
    dS = P * (dO v^T - delta) * scale with delta = rowsum(dO * O);
    dv = P^T dO, dk = dS^T q, dq = dS k. Dense over (Sq, Sk): the
    yardstick of correctness, not of speed.
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    seq_q, seq_k = q.shape[1], k.shape[1]
    if causal and seq_q != seq_k:
        raise ValueError("causal flash kernel requires Sq == Sk (self-attention)")
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * sm_scale
    p = torch.exp(s - lse.float()[..., None])
    if causal:
        row = torch.arange(seq_q, device=q.device)[:, None]
        col = torch.arange(seq_k, device=q.device)[None, :]
        p = torch.where(band_allowed(row, col, window, sinks), p, 0.0)
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)  # (B, H, Sq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * sm_scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _check_cuda_inputs(q, k, v, causal):
    """The checks every CUDA flash kernel makes on q, k, v; raises on what
    the kernels do not take."""
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
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v)):
            if not _aligned16(x):
                raise ValueError(
                    f"bf16 {name} must have a 16-byte aligned base pointer "
                    f"and batch, seq and head strides that are multiples of "
                    f"8 elements (the kernels' TMA copies need "
                    f"them), got pointer {x.data_ptr()} strides {x.stride()}"
                )


def _aligned16(x: torch.Tensor) -> bool:
    """True when the base pointer and the (batch, seq, head) strides of a
    (B, S, H, D) tensor are multiples of 16 bytes."""
    return x.data_ptr() % 16 == 0 and all(
        x.stride(i) * x.element_size() % 16 == 0 for i in range(3)
    )


def _flash_fwd_cuda(q, k, v, causal, sm_scale, window, sinks):
    _check_cuda_inputs(q, k, v, causal)
    if q.dtype == torch.bfloat16 and not sm_scale > 0:
        raise ValueError(
            f"the bf16 forward kernel takes sm_scale > 0 (it keeps the "
            f"running max of the unscaled scores), got {sm_scale}"
        )
    batch, seq_q, heads, head_dim = q.shape
    seq_k = k.shape[1]
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


def _bwd_kernels():
    global _bwd_fns
    if _bwd_fns is None:
        from ray_lightning_tpu_torch.ops import _build

        lib = _build.load("flash_bwd")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        tail = [i32] * 5 + [ptr, ctypes.c_float] + [i32] * 5 + [ptr]
        dkv, dq = lib.rlt_flash_bwd_dkv, lib.rlt_flash_bwd_dq
        # Every pointer and the stream as c_void_p (see _kernel).
        dkv.argtypes = [ptr] * 8 + tail
        dq.argtypes = [ptr] * 7 + tail
        dkv.restype = dq.restype = i32
        _bwd_fns = (dkv, dq)
    return _bwd_fns


def _flash_bwd_cuda(q, k, v, out, lse, do, causal, sm_scale, window, sinks):
    """K2 then K3 on the card: (dq, dk, dv) in the dtypes of q, k, v."""
    args = prepare_bwd(q, k, v, out, lse, do, causal, sm_scale, window, sinks)
    batch, seq_q, heads, head_dim = q.shape
    dq = torch.empty((batch, seq_q, heads, head_dim), dtype=q.dtype,
                     device=q.device)
    dk = torch.empty((batch, k.shape[1], heads, head_dim), dtype=k.dtype,
                     device=q.device)
    dv = torch.empty_like(dk)
    launch_bwd_dkv(args, dk, dv)
    launch_bwd_dq(args, dq)
    return dq, dk, dv


def prepare_bwd(q, k, v, out, lse, do, causal, sm_scale, window, sinks):
    """Check the backward's inputs and prepare what K2 and K3 share: dO in
    q's dtype with a contiguous last axis, delta = rowsum(dO * O) as fp32
    (B, H, Sq), the strides and the scalar arguments."""
    _check_cuda_inputs(q, k, v, causal)
    batch, seq_q, heads, head_dim = q.shape
    if do.shape != q.shape or out.shape != q.shape:
        raise ValueError(
            f"do/out shapes {tuple(do.shape)}/{tuple(out.shape)} do not "
            f"match q {tuple(q.shape)}"
        )
    if lse.shape != (batch, heads, seq_q) or lse.dtype != torch.float32:
        raise ValueError("lse must be float32 (B, H, Sq), as the forward wrote it")
    if {do.device, out.device, lse.device} != {q.device}:
        raise ValueError("do, out and lse must be on q's device")
    # Autograd may hand a gradient of any layout or dtype; the kernels read
    # dO strided in q's dtype with a contiguous last axis (and in bf16 with
    # the 16-byte alignment of q, k, v).
    do = do.to(q.dtype)
    if do.stride(-1) != 1 or (
        do.dtype == torch.bfloat16 and not _aligned16(do)
    ):
        do = do.contiguous()
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    strides = (ctypes.c_longlong * 12)(
        *(x.stride(i) for x in (q, k, v, do) for i in range(3))
    )
    tail = (
        batch, heads, seq_q, k.shape[1], head_dim, strides, float(sm_scale),
        int(causal), int(window), int(sinks), _DTYPE_CODES[q.dtype],
        q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    return _BwdArgs(q, k, v, do, lse.contiguous(), delta, tail)


@dataclass
class _BwdArgs:
    """The inputs K2 and K3 share, prepared once per backward."""

    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor
    lse: torch.Tensor
    delta: torch.Tensor
    tail: tuple  # sizes, strides, scale, mask, dtype, device, stream

    def ptrs(self):
        return (self.q.data_ptr(), self.k.data_ptr(), self.v.data_ptr(),
                self.do.data_ptr(), self.lse.data_ptr(), self.delta.data_ptr())


def _check_grad_out(g: torch.Tensor, like: torch.Tensor) -> None:
    """The kernels write a gradient contiguous (B, S, H, D), in the dtype
    and on the device of the input it belongs to."""
    if (
        g.shape != like.shape or g.dtype != like.dtype
        or g.device != like.device or not g.is_contiguous()
    ):
        raise ValueError(
            f"gradient buffer {tuple(g.shape)} {g.dtype} on {g.device} must "
            f"be contiguous {tuple(like.shape)} {like.dtype} on {like.device}"
        )


def launch_bwd_dkv(args: _BwdArgs, dk: torch.Tensor, dv: torch.Tensor) -> None:
    """Launch K2 (``rlt_flash_bwd_dkv``) into ``dk``/``dv``."""
    _check_grad_out(dk, args.k)
    _check_grad_out(dv, args.v)
    err = _bwd_kernels()[0](
        *args.ptrs(), dk.data_ptr(), dv.data_ptr(), *args.tail
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd_dkv kernel launch failed: cudaError {err}")
    counters.bwd_dkv_launches += 1


def launch_bwd_dq(args: _BwdArgs, dq: torch.Tensor) -> None:
    """Launch K3 (``rlt_flash_bwd_dq``) into ``dq``."""
    _check_grad_out(dq, args.q)
    err = _bwd_kernels()[1](*args.ptrs(), dq.data_ptr(), *args.tail)
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq kernel launch failed: cudaError {err}")
    counters.bwd_dq_launches += 1
