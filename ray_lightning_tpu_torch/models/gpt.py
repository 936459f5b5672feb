"""GPT in PyTorch: the training forward, losses and ``GPTLM``; prefill
(whole, chunked, and piggybacked on a decode fold), cached decode (dense
and paged), speculative decoding's verify, drafters and fold, sampling
and generate.

Port of ``ray_lightning_tpu/models/gpt.py``'s dense paths. The parameter
tree keeps the JAX package's names and its stacked layout (every block leaf
carries a leading ``layers`` dim), so weights cross over as a copy with no
re-layout (``models/weights.py``). Mixed precision follows the reference:
params are fp32; products and attention run in ``compute_dtype``; norms,
softmax and logits reduce in fp32.

Differences that follow from PyTorch:

- Layers run in a Python loop over the stacked leaves (``lax.scan`` has no
  eager counterpart that pays).
- Decode writes the K/V cache in place (the JAX step returns a new cache
  that XLA aliases onto the old one); an in-place write keeps one cache in
  memory.
- Sampling draws are a counter-based integer hash of (seed, draw number,
  vocabulary index) computed on the device (:func:`draw_uniforms`), not
  threefry keys: the same seed gives other draws than the JAX package, by
  design. The training step's generator is a ``torch.Generator``.
- Dense configs only: ``n_experts > 0`` raises (MoE is ROADMAP queue 1 item 13).
- ``remat`` recomputes each block in the backward through
  ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``).
- Under ZeRO-3 (and ``GSPMDStrategy``'s fsdp axis) the step passes a view
  of the tree whose reads gather: :func:`_layer` gathers one layer's rows
  of the stacked leaves just before the layer runs, as XLA places the
  gathers inside the JAX package's layer scan.
- The decode step is batch-invariant on the card: its row-wise work runs
  in fixed blocks of ``DECODE_ROWS`` rows and its attention in fp64, so a
  slot's logits do not depend on its batchmates or on the cache's length.
  The prefill on the reference path is chunk-invariant the same way
  (``PREFILL_ROWS``, :func:`gpt_prefill_chunk`). The verify of
  speculative decoding is the decode step with a query axis, and the
  paged functions gather pages into the dense layout and run the dense
  functions: both give bitwise the dense step's rows.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.parallel.zero import layer_of
from ray_lightning_tpu_torch.parallel.tp import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)
from ray_lightning_tpu_torch.trainer.data import ArrayDataset, DataLoader, Dataset
from ray_lightning_tpu_torch.trainer.module import TorchModule
from ray_lightning_tpu_torch.trainer.optim import warmup_cosine_decay_schedule
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.quantize import (
    dequant,
    embed_rows,
    is_quantized,
)

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

#: Leaves of the stacked ``blocks`` tree that feed a matrix product (and
#: their biases): the leaves the compute-dtype copy casts.
_MATMUL_LEAVES = (
    "wqkv", "bqkv", "wq", "bq", "wkv", "bkv", "wo", "bo",
    "wi", "bi", "wo2", "bo2",
)


@dataclass(frozen=True)
class GPTConfig:
    """Same field names and defaults as the JAX package's ``GPTConfig``,
    so configs round-trip. Fields of paths the port does not run yet
    (sequence parallelism, MoE, pipeline) are kept for that round trip
    and read nowhere in this package."""

    vocab_size: int = 256
    n_layer: int = 2
    n_head: int = 4
    d_model: int = 128
    d_ff: int = 0  # 0 -> 4 * d_model
    max_seq: int = 128
    compute_dtype: str = "float32"  # "bfloat16" for GPU runs
    remat: bool = False
    attn_impl: str = "flash"  # "flash" | "reference"
    attn_window: int = 0
    attn_sinks: int = 0
    n_kv_head: int = 0
    pos_embed: str = "learned"
    rope_theta: float = 10000.0
    seq_impl: str = "ring"
    init_std: float = 0.02
    mlp_variant: str = "gelu"
    norm_impl: str = "layernorm"
    norm_eps: float = 1e-5
    tie_word_embeddings: bool = True
    n_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_top_k: int = 1
    moe_dispatch: str = "auto"
    num_microbatches: int = 0
    loss_chunk: int = 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def kv_head(self) -> int:
        kv = self.n_kv_head or self.n_head
        if self.n_head % kv:
            raise ValueError(
                f"n_head ({self.n_head}) must be divisible by n_kv_head ({kv})"
            )
        return kv

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    def validate_variants(self) -> None:
        if self.mlp_variant not in ("gelu", "swiglu"):
            raise ValueError(
                f"unknown mlp_variant {self.mlp_variant!r}; use 'gelu' or "
                "'swiglu'"
            )
        if self.norm_impl not in ("layernorm", "rmsnorm"):
            raise ValueError(
                f"unknown norm_impl {self.norm_impl!r}; use 'layernorm' or "
                "'rmsnorm'"
            )
        if self.n_experts > 0:
            raise NotImplementedError(
                "MoE configs (n_experts > 0) are not ported yet (ROADMAP "
                "queue 1 item 13)"
            )

    @staticmethod
    def llama(**overrides: Any) -> "GPTConfig":
        """Llama-family defaults: RoPE, RMSNorm, SwiGLU, untied head."""
        cfg = GPTConfig(
            pos_embed="rope",
            norm_impl="rmsnorm",
            norm_eps=1e-5,
            mlp_variant="swiglu",
            tie_word_embeddings=False,
        )
        return replace(cfg, **overrides) if overrides else cfg

    @staticmethod
    def gpt2_small(**overrides: Any) -> "GPTConfig":
        """GPT-2 124M: the flagship configuration."""
        cfg = GPTConfig(
            vocab_size=50257,
            n_layer=12,
            n_head=12,
            d_model=768,
            max_seq=1024,
            compute_dtype="bfloat16",
        )
        return replace(cfg, **overrides) if overrides else cfg


def compute_dtype(cfg: GPTConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def param_shapes(cfg: GPTConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (``gpt.py:171-267`` of the JAX package):
    ``{leaf: shape}`` with ``blocks`` nested."""
    cfg.validate_variants()
    L, D, H, hd, F_ = (
        cfg.n_layer, cfg.d_model, cfg.n_head, cfg.head_dim, cfg.ff_dim,
    )
    Hkv = cfg.kv_head
    if cfg.mlp_variant == "swiglu":
        mlp = {"wi": (L, D, 2, F_), "bi": (L, 2, F_)}
    else:
        mlp = {"wi": (L, D, F_), "bi": (L, F_)}
    mlp.update({"wo2": (L, F_, D), "bo2": (L, D)})
    if Hkv == H:
        attn = {"wqkv": (L, D, 3, H, hd), "bqkv": (L, 3, H, hd)}
    else:
        attn = {
            "wq": (L, D, H, hd),
            "bq": (L, H, hd),
            "wkv": (L, D, 2, Hkv, hd),
            "bkv": (L, 2, Hkv, hd),
        }
    out: Dict[str, Any] = {
        "wte": (cfg.vocab_size, D),
        "blocks": {
            "ln1_g": (L, D),
            "ln1_b": (L, D),
            **attn,
            "wo": (L, H, hd, D),
            "bo": (L, D),
            "ln2_g": (L, D),
            "ln2_b": (L, D),
            **mlp,
        },
        "lnf_g": (D,),
        "lnf_b": (D,),
    }
    if cfg.pos_embed == "learned":
        out["wpe"] = (cfg.max_seq, D)
    elif cfg.pos_embed != "rope":
        raise ValueError(
            f"unknown pos_embed {cfg.pos_embed!r}; use 'learned' or 'rope'"
        )
    if not cfg.tie_word_embeddings:
        out["lm_head"] = (cfg.vocab_size, D)
    return out


def init_gpt_params(
    generator: torch.Generator, cfg: GPTConfig
) -> Dict[str, Any]:
    """Parameter tree with stacked per-layer leaves (leading dim L), fp32,
    drawn from ``generator`` on its device. Same tree and shapes as the
    JAX package's ``init_gpt_params``: normal(0, init_std) weights, the two
    residual projections scaled by 1/sqrt(2L), zero biases, unit norm
    gains. The values differ from the JAX package's (another generator)."""
    shapes = param_shapes(cfg)
    device = generator.device
    std = cfg.init_std
    res_std = std / np.sqrt(2.0 * cfg.n_layer)

    def leaf(name: str, shape) -> torch.Tensor:
        if name.endswith("_g"):
            return torch.ones(shape, device=device)
        if name.startswith("b") or name.endswith("_b"):
            return torch.zeros(shape, device=device)
        s = res_std if name in ("wo", "wo2") else std
        return torch.randn(shape, generator=generator, device=device) * s

    return {
        k: (
            {n: leaf(n, s) for n, s in v.items()}
            if isinstance(v, dict)
            else leaf(k, v)
        )
        for k, v in shapes.items()
    }


def cast_params(params: Dict[str, Any], cfg: GPTConfig) -> Dict[str, Any]:
    """The serving form of ``params``: the block matmul leaves (and their
    biases) in the compute dtype, plus ``head_c``, the output table as
    :func:`_lm_head` reads it. Embedding tables and norm parameters stay fp32,
    as the forward reads them. The JAX package casts per step because XLA
    fuses the cast into the consuming matmul; eager PyTorch would pay a
    copy of every weight on every step, so the engine makes this copy once
    at construction and the per-step ``dequant`` then passes it through.

    Weight-only int8 nodes (``utils/quantize.py``) stay as they are: no
    compute-dtype copy of a block leaf and no ``head_c`` of an int8 table,
    since a resident float copy would undo the point of int8. They are
    dequantized where they are used (:func:`dequant` inside each product,
    :func:`_head_weight` at the head)."""
    cdt = compute_dtype(cfg)
    blocks = {
        k: (v.to(cdt) if k in _MATMUL_LEAVES and not is_quantized(v) else v)
        for k, v in params["blocks"].items()
    }
    table = params["wte"] if cfg.tie_word_embeddings else params["lm_head"]
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    if not is_quantized(table):
        out.pop("lm_head", None)
        out["head_c"] = _head_weight(params, cfg)
    return out


def _layer(blocks: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer ``li`` of the stacked block leaves (an int8 node's ``q`` and
    ``s`` both indexed). Under ZeRO-3 the step's view of the blocks
    gathers the layer's rows here, just before the layer runs
    (``parallel/zero.py:LayerGather``)."""
    gathered = layer_of(blocks, li)
    if gathered is not None:
        return gathered
    return {
        k: ({"q": v["q"][li], "s": v["s"][li]} if is_quantized(v) else v[li])
        for k, v in blocks.items()
    }


def _lm_head(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(..., D) x (V, D) -> (..., V)`` fp32 logits from the output table
    :func:`_head_weight` returns. The JAX package multiplies compute-dtype
    operands with fp32 accumulation and fp32 output; a bf16 GEMM in
    PyTorch rounds its output to bf16, which would tie near-equal logits.
    So the table holds the compute-dtype rounding of the weights in fp32
    and the product runs in fp32: the same operand values, products exact
    in fp32, fp32 sums and logits."""
    return h.float() @ w.t()


def _layernorm(
    x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    ms = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(ms + eps) * g).to(x.dtype)


def _make_norm(cfg: GPTConfig):
    """The block-norm function for the config: ``fn(x, g, b)``. RMSNorm
    ignores the bias leaf (kept in the tree so the layout is uniform)."""
    if cfg.norm_impl == "rmsnorm":
        return lambda x, g, b: _rmsnorm(x, g, cfg.norm_eps)
    return lambda x, g, b: _layernorm(x, g, b, cfg.norm_eps)


def _dense_mlp(
    m: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: GPTConfig,
    cdt: torch.dtype, tp: Any = None,
) -> torch.Tensor:
    """The dense feed-forward on normed input (..., D): GPT-2 gelu (tanh
    approximation, as ``jax.nn.gelu``'s default) or SwiGLU with gate/up
    stacked in ``wi`` (D, 2, F). With ``tp`` (the model group) and ``wi`` /
    ``wo2`` holding this rank's F/m columns / rows, the partial outputs
    are summed over the group before ``bo2`` is added, once."""
    split = tp is not None and lp["wo2"].shape[0] != cfg.ff_dim
    if split:
        m = copy_to_model(m, tp)
    out = _mlp_out(m, lp, cfg, cdt)
    if split:
        out = reduce_from_model(out, tp)
    return out + lp["bo2"].to(cdt)


def _mlp_out(
    m: torch.Tensor, lp: Dict[str, torch.Tensor], cfg: GPTConfig,
    cdt: torch.dtype, acc: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The feed-forward's down projection of normed input (..., D), before
    ``bo2``: over this rank's F/m columns a partial sum, in ``acc`` (the
    product's operands taken to it) when given, else in ``cdt``."""
    if cfg.mlp_variant == "swiglu":
        z = torch.einsum("...d,dcf->...cf", m, dequant(lp["wi"], cdt)) + lp[
            "bi"
        ].to(cdt)
        h = F.silu(z[..., 0, :]) * z[..., 1, :]
    else:
        z = torch.einsum("...d,df->...f", m, dequant(lp["wi"], cdt)) + lp[
            "bi"
        ].to(cdt)
        h = F.gelu(z, approximate="tanh")
    w = dequant(lp["wo2"], cdt)
    if acc is not None:
        h, w = h.to(acc), w.to(acc)
    return torch.einsum("...f,fd->...d", h, w)


def _row_split_sum(x: torch.Tensor, tp: Any, cdt: torch.dtype
                   ) -> torch.Tensor:
    """The sum over the model group of this rank's fp32 partial products,
    rounded to ``cdt`` once: the unsplit product accumulates in fp32 and
    rounds once, so the split differs from it only in the order of the
    fp32 sums."""
    return reduce_from_model(x, tp).to(cdt)


def _head_weight(params: Dict[str, Any], cfg: GPTConfig) -> torch.Tensor:
    """The (V, D) output table for :func:`_lm_head`: the tied embedding or
    ``lm_head``, rounded to the compute dtype and held in fp32 (the copy
    :func:`cast_params` made once, else made here per call: always for an
    int8 table, whose dequant then runs where the head is used)."""
    if "head_c" in params:
        return params["head_c"]
    table = params["wte"] if cfg.tie_word_embeddings else params["lm_head"]
    return dequant(table, compute_dtype(cfg)).float()


def _rope_tables(
    pos: torch.Tensor, theta: float, head_dim: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables (S, hd/2) for explicit positions (S,), fp32."""
    half = head_dim // 2
    freqs = float(theta) ** (
        -torch.arange(half, dtype=torch.float32, device=pos.device) / half
    )
    ang = pos.float()[:, None] * freqs[None]
    return torch.cos(ang), torch.sin(ang)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(
        x.dtype
    )


def _rope(
    x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]
) -> torch.Tensor:
    """Half-split (NeoX-style) rotation of (B, S, H, hd); fp32 math."""
    cos, sin = tables
    return _rotate(x, cos[None, :, None, :], sin[None, :, None, :])


def _project_qkv(
    a: torch.Tensor,
    lp: Dict[str, torch.Tensor],
    cfg: GPTConfig,
    cdt: torch.dtype,
    rope_tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    repeat_kv: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, S, D) -> q (B, S, H, hd) and k/v (B, S, H or Hkv, hd).

    Fused MHA projection, or separate q / grouped-kv projections (GQA).
    RoPE rotates q/k before any kv repeat; ``repeat_kv=False`` returns k/v
    at their Hkv width (what the decode cache stores).
    """
    if cfg.kv_head == cfg.n_head:
        qkv = torch.einsum(
            "bsd,dthk->bsthk", a, dequant(lp["wqkv"], cdt)
        ) + lp["bqkv"].to(cdt)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q = torch.einsum("bsd,dhk->bshk", a, dequant(lp["wq"], cdt)) + lp[
            "bq"
        ].to(cdt)
        kv = torch.einsum(
            "bsd,dthk->bsthk", a, dequant(lp["wkv"], cdt)
        ) + lp["bkv"].to(cdt)
        k, v = kv[:, :, 0], kv[:, :, 1]
    if rope_tables is not None:
        q = _rope(q, rope_tables)
        k = _rope(k, rope_tables)
    if repeat_kv and cfg.kv_head != cfg.n_head:
        rep = cfg.n_head // cfg.kv_head
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return q, k, v


def _model_group(mesh: Any) -> Any:
    """The mesh's ``"model"`` group, or None (no mesh, or a model extent of
    1)."""
    return None if mesh is None else mesh.group("model")


def _local_kv_heads(params: Dict[str, Any], cfg: GPTConfig) -> int:
    """The KV heads ``params`` hold: Hkv, or this rank's Hkv/m of a
    slice."""
    blocks = params["blocks"]
    w = blocks["wqkv"] if cfg.kv_head == cfg.n_head else blocks["wkv"]
    return int((w["q"] if is_quantized(w) else w).shape[3])


def _embed_tokens(table: Any, tokens: torch.Tensor, cfg: GPTConfig,
                  tp: Any) -> torch.Tensor:
    """Rows of ``table`` for ``tokens``. A table holding this rank's
    V/m rows (a vocab split over the model group) looks up the tokens it
    holds, zeroes the others and sums over the group."""
    if tp is None or table.shape[0] == cfg.vocab_size:
        return embed_rows(table, tokens)
    import torch.distributed as dist

    local = table.shape[0]
    idx = tokens - dist.get_rank(tp) * local
    inside = (idx >= 0) & (idx < local)
    rows = embed_rows(table, idx.clamp(0, local - 1))
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows, tp)


def gpt_logits(params: Dict[str, Any], x: torch.Tensor, cfg: GPTConfig,
               tp: Any = None) -> torch.Tensor:
    """fp32 logits (..., V) of the final hidden states ``x``. A vocab split
    over the model group gives each rank V/m columns, gathered whole."""
    w = _head_weight(params, cfg)
    if tp is None or w.shape[0] == cfg.vocab_size:
        return _lm_head(x, w)
    return gather_from_model(_lm_head(copy_to_model(x, tp), w), -1, tp)


def gpt_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: GPTConfig,
    mesh: Any = None,
    seq_axis: Optional[str] = None,
    return_aux: bool = False,
    return_hidden: bool = False,
) -> Any:
    """tokens (B, S) int -> fp32 logits (B, S, V): the training forward
    (``gpt.py:611`` of the JAX package, dense path).

    With ``attn_impl="flash"`` each layer's attention is one
    :func:`flash_attention` call, differentiable through its own backward
    kernels; ``"reference"`` is the dense attention. ``cfg.remat``
    recomputes each block in the backward. ``return_hidden`` returns the
    post-final-norm hidden states (B, S, D) instead of logits (the input of
    :func:`chunked_lm_loss`); ``return_aux`` also returns the MoE
    load-balancing loss, zero for the dense configs the port runs.

    ``mesh`` (``parallel/mesh.py``) splits the blocks over its ``"model"``
    axis, Megatron-style, where ``params`` holds this rank's slices (the
    specs of :func:`gpt_logical_axes`): the attention of H/m heads (or
    Hkv/m kv heads) and their rows of ``wo``, the MLP's F/m columns of
    ``wi`` and rows of ``wo2``; each block's partial output is summed over
    the group and its bias (``bo``, ``bo2``) added after the sum, once. A
    vocab split (a vocab the model extent divides) makes the embedding a
    masked lookup summed over the group and the head's logits a gather.
    """
    from ray_lightning_tpu_torch.ops import attention_reference, flash_attention

    if seq_axis is not None:
        raise NotImplementedError(
            "sequence parallelism is not ported yet (ROADMAP queue 1 item 13)"
        )
    tp = _model_group(mesh)
    cfg.validate_variants()
    if cfg.seq_impl not in ("ring", "zigzag"):
        raise ValueError(
            f"unknown seq_impl {cfg.seq_impl!r}; use 'ring' or 'zigzag'"
        )
    cdt = compute_dtype(cfg)
    norm_fn = _make_norm(cfg)
    _, S = tokens.shape
    attn_fn = (
        flash_attention if cfg.attn_impl == "flash" else attention_reference
    )
    rope_tables = (
        _rope_tables(torch.arange(S, device=tokens.device), cfg.rope_theta,
                     cfg.head_dim)
        if cfg.pos_embed == "rope"
        else None
    )
    x = _embed_tokens(params["wte"], tokens, cfg, tp)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][:S]
    x = x.to(cdt)

    def block(h: torch.Tensor, lp: Dict[str, torch.Tensor]) -> torch.Tensor:
        a = norm_fn(h, lp["ln1_g"], lp["ln1_b"])
        split = tp is not None and lp["wo"].shape[0] != cfg.n_head
        if split:
            if "wkv" in lp and lp["wkv"].shape[2] == cfg.kv_head:
                raise ValueError(
                    f"n_kv_head ({cfg.kv_head}) must be divisible by the "
                    "model extent when n_head is: the kv heads shard with "
                    "the query heads")
            a = copy_to_model(a, tp)
        q, k, v = _project_qkv(a, lp, cfg, cdt, rope_tables)  # (B,S,H,hd)
        o = attn_fn(
            q, k, v, causal=True, window=cfg.attn_window, sinks=cfg.attn_sinks
        )
        o = torch.einsum("bshk,hkd->bsd", o, dequant(lp["wo"], cdt))
        if split:
            o = reduce_from_model(o, tp)
        h = h + o + lp["bo"].to(cdt)
        m = norm_fn(h, lp["ln2_g"], lp["ln2_b"])
        return h + _dense_mlp(m, lp, cfg, cdt, tp)

    blocks = params["blocks"]
    for li in range(cfg.n_layer):
        if cfg.remat:
            # The layer is read inside the recomputed block, so the
            # backward reads it again (under ZeRO-3: gathers it again)
            # instead of keeping it.
            x = checkpoint(lambda h, li=li: block(h, _layer(blocks, li)), x,
                           use_reentrant=False)
        else:
            x = block(x, _layer(blocks, li))
    x = norm_fn(x, params["lnf_g"], params["lnf_b"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = x if return_hidden else gpt_logits(params, x, cfg, tp)
    return (out, aux) if return_aux else out


def gpt_logical_axes(cfg: GPTConfig) -> Dict[str, Any]:
    """Logical axis names per parameter (JAX ``gpt.py:270-336``, dense
    configs), which the strategy resolves to mesh axes through
    ``parallel/logical.py``'s rules (embed->fsdp, heads/mlp/vocab->model)."""
    cfg.validate_variants()
    if cfg.mlp_variant == "swiglu":
        mlp = {
            "wi": ("layers", "embed", None, "mlp"),
            "bi": ("layers", None, "mlp"),
            "wo2": ("layers", "mlp", "embed"),
            "bo2": ("layers", None),
        }
    else:
        mlp = {
            "wi": ("layers", "embed", "mlp"),
            "bi": ("layers", "mlp"),
            "wo2": ("layers", "mlp", "embed"),
            "bo2": ("layers", None),
        }
    if cfg.kv_head == cfg.n_head:
        attn = {
            "wqkv": ("layers", "embed", None, "heads", "kv"),
            "bqkv": ("layers", None, "heads", "kv"),
        }
    else:
        # GQA: kv heads shard over "heads" too (n_kv_head divisible by the
        # model extent, like n_head).
        attn = {
            "wq": ("layers", "embed", "heads", "kv"),
            "bq": ("layers", "heads", "kv"),
            "wkv": ("layers", "embed", None, "heads", "kv"),
            "bkv": ("layers", None, "heads", "kv"),
        }
    out: Dict[str, Any] = {
        "wte": ("vocab", "embed"),
        "blocks": {
            "ln1_g": ("layers", None),
            "ln1_b": ("layers", None),
            **attn,
            "wo": ("layers", "heads", "kv", "embed"),
            "bo": ("layers", None),
            "ln2_g": ("layers", None),
            "ln2_b": ("layers", None),
            **mlp,
        },
        "lnf_g": (None,),
        "lnf_b": (None,),
    }
    if cfg.pos_embed == "learned":
        out["wpe"] = (None, "embed")
    if not cfg.tie_word_embeddings:
        out["lm_head"] = ("vocab", "embed")
    return out


#: Logical axes of the serving engine's (L, slots, S, Hkv, hd) KV tensors
#: (JAX ``gpt.py:343-345``): the per-slot decode cache and the prefix-pool
#: blocks share the layout. KV heads split over the mesh's "model" axis;
#: slots, positions and head_dim are whole on every rank, so slot
#: bookkeeping and the per-fold token harvest never cross ranks.
DECODE_CACHE_AXES: Tuple[Optional[str], ...] = (
    "layers", None, None, "heads", "kv",
)


def check_decode_mesh(cfg: GPTConfig, mesh: Any) -> None:
    """Fail fast when a serving mesh cannot split this config's heads (JAX
    ``gpt.py:348-368``): each rank needs a whole number of q heads AND kv
    heads, checked before anything is allocated."""
    m = int(mesh.shape.get("model", 1))
    if m <= 1:
        return
    if cfg.n_head % m or cfg.kv_head % m:
        raise ValueError(
            f"mesh model axis ({m}) must divide n_head ({cfg.n_head}) and "
            f"n_kv_head ({cfg.kv_head}): attention heads and the KV cache "
            "shard over the model axis, so each device needs a whole "
            "number of q and kv heads — use a smaller model axis or a "
            "head count divisible by it"
        )


def gpt_param_slices(
    params: Dict[str, Any],
    cfg: GPTConfig,
    mesh: Any,
    rules: Optional[Sequence[Tuple[str, Optional[str]]]] = None,
) -> Dict[str, Any]:
    """This rank's slices of a (possibly int8) GPT parameter tree on a
    serving mesh: the counterpart of JAX ``gpt_param_shardings`` (``gpt.py:
    371-411``), whose specs come from :func:`gpt_logical_axes` through
    ``parallel/logical.py``'s rules (heads, MLP columns and a vocab the
    model extent divides split over ``"model"``; 50257 does not, so
    GPT-2's ``wte`` stays whole). A leaf already at its slice's shape is
    taken as cut. An int8 node's ``q`` is cut like its leaf; its scales
    ``s`` are cut only on the dims where they are not 1 (the output
    channels), so they broadcast over this rank's ``q`` as the JAX
    package's whole scales do over its sharded one. Slices are copies:
    the whole tree can be dropped."""
    from ray_lightning_tpu_torch.parallel.logical import (
        DEFAULT_RULES,
        shard_of,
        spec_from_logical,
    )

    if mesh is None:
        return params
    rule_list = tuple(rules) if rules is not None else DEFAULT_RULES

    def cut(x: Any, full: Tuple[int, ...], spec: Tuple, path: str) -> Any:
        x = torch.as_tensor(x)
        if tuple(x.shape) == tuple(full):
            x = shard_of(x, spec, mesh.coords, mesh.shape)
            return x.clone(memory_format=torch.contiguous_format)
        local = tuple(n // int(mesh.shape[a]) if a else n
                      for n, a in zip(full, spec))
        if tuple(x.shape) != local:
            raise ValueError(
                f"{path}: shape {tuple(x.shape)} is neither the whole leaf "
                f"{tuple(full)} nor this rank's slice {local}")
        return x

    def walk(node: Any, shape: Any, axes: Any, path: str) -> Any:
        if isinstance(shape, dict):
            return {k: walk(node[k], shape[k], axes[k], f"{path}/{k}")
                    for k in shape}
        spec = spec_from_logical(tuple(shape), axes, rule_list, mesh.shape)
        if not is_quantized(node):
            return cut(node, tuple(shape), spec, path)
        s_full = tuple(1 if n == 1 else m
                       for n, m in zip(node["s"].shape, shape))
        s_spec = tuple(a if n != 1 else None for n, a in zip(s_full, spec))
        return {"q": cut(node["q"], tuple(shape), spec, path + "/q"),
                "s": cut(node["s"], s_full, s_spec, path + "/s")}

    return walk(params, param_shapes(cfg), gpt_logical_axes(cfg), "")


def lm_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross entropy + accuracy over all positions."""
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1).long()
    )
    acc = (logits.argmax(-1) == targets).float().mean()
    return ce, acc


def _vocab_parallel_chunk(logits: torch.Tensor, t_c: torch.Tensor,
                          tp: Any) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """(log-sum-exp, target logit, argmax) of one chunk whose ``logits``
    hold this rank's V/m columns of a vocab split over the model group:
    the maxima are gathered (no gradient), the exponential sums and the
    target logit (nonzero on the rank holding the target's column) summed
    over the group; the argmax is the first maximum over the whole
    vocab, as ``argmax`` of the whole logits gives."""
    import torch.distributed as dist

    local = logits.shape[-1]
    lo = dist.get_rank(tp) * local
    best, arg = logits.detach().max(-1, keepdim=True)
    maxes = gather_from_model(best, -1, tp)  # (..., m)
    args = gather_from_model(arg, -1, tp)
    mx = maxes.amax(-1)
    lse = torch.log(reduce_from_model(
        torch.exp(logits - mx[..., None]).sum(-1), tp)) + mx
    idx = t_c.long() - lo
    inside = (idx >= 0) & (idx < local)
    tgt = torch.gather(logits, -1, idx.clamp(0, local - 1)[..., None])[..., 0]
    tgt = reduce_from_model(torch.where(inside, tgt, 0.0), tp)
    rank = maxes.argmax(-1, keepdim=True)  # the first rank holding it
    top = torch.gather(args, -1, rank)[..., 0] + rank[..., 0] * local
    return lse, tgt, top


def chunked_lm_loss(
    x: torch.Tensor, wte: Any, targets: torch.Tensor, chunk: int,
    tp: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LM head + mean CE + accuracy without (B, S, V) logits
    (``gpt.py:924`` of the JAX package).

    ``x``: post-final-norm hidden states (B, S, D); ``wte``: the (V, D)
    output table; ``targets`` (B, S), negative = ignore. The head and the
    cross entropy run over S-chunks, each under ``torch.utils.checkpoint``
    so the backward recomputes a chunk's logits instead of keeping them:
    peak logits memory is B*chunk*V fp32. The table's cast to the compute
    dtype is made once, outside the chunk loop. Same fp32 math as
    :func:`lm_loss`; the mean is over the valid positions.

    ``tp`` (the model group) with ``wte`` holding this rank's V/m rows
    makes the head vocab-parallel: each chunk's log-sum-exp and target
    logit are reduced over the group (:func:`_vocab_parallel_chunk`), and
    ``x`` (whole on every rank) gets its gradient summed over the group.
    """
    B, S, D = x.shape
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad), value=-1)
    # The table as _lm_head reads it: rounded to the compute dtype, in fp32.
    wte_c = dequant(wte, x.dtype).float()

    def body(x_c: torch.Tensor, t_c: torch.Tensor):
        valid = t_c >= 0
        if tp is not None:
            logits = _lm_head(copy_to_model(x_c, tp), wte_c)
            lse, tgt, top = _vocab_parallel_chunk(
                logits, t_c.clamp(min=0), tp)
        else:
            logits = _lm_head(x_c, wte_c)
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1,
                               t_c.clamp(min=0)[..., None].long())[..., 0]
            top = logits.argmax(-1)
        ce_sum = torch.where(valid, lse - tgt, 0.0).sum()
        hit = (top == t_c) & valid
        return ce_sum, hit.float().sum()

    ce_sum = n_correct = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        ce_c, hit_c = checkpoint(body, x[:, sl], targets[:, sl],
                                 use_reentrant=False)
        ce_sum = ce_sum + ce_c
        n_correct = n_correct + hit_c
    n = torch.clamp((targets >= 0).float().sum(), min=1.0)
    return ce_sum / n, n_correct / n


def make_fake_text(
    n_seqs: int = 256,
    seq_len: int = 64,
    vocab: int = 256,
    seed: int = 0,
    noise: float = 0.05,
) -> ArrayDataset:
    """Synthetic LM corpus, the JAX package's ``make_fake_text`` exactly
    (same numpy draws, same tokens): an affine recurrence
    ``t[i+1] = (5*t[i] + 7) % V`` with occasional random flips, so a small
    GPT's loss falls well below ln(V) within a few epochs."""
    g = np.random.default_rng(seed)
    starts = g.integers(0, vocab, size=n_seqs)
    toks = np.empty((n_seqs, seq_len + 1), dtype=np.int32)
    toks[:, 0] = starts
    flips = g.random((n_seqs, seq_len)) < noise
    rand = g.integers(0, vocab, size=(n_seqs, seq_len))
    for i in range(seq_len):
        nxt = (5 * toks[:, i] + 7) % vocab
        toks[:, i + 1] = np.where(flips[:, i], rand[:, i], nxt)
    return ArrayDataset(toks)


#: The device draw's 32-bit mix: two rounds of xor-shift and a multiply
#: by an odd constant below 2**27, so every product of a 32-bit value stays
#: below 2**59 and int64 arithmetic gives the same bits on every device.
_M32 = 0xFFFFFFFF
_MIX = 0x45D9F3B


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    x = x ^ (x >> 16)
    x = (x * _MIX) & _M32
    return x ^ (x >> 16)


def seed64(seed: int) -> int:
    """A request's seed as the signed 64-bit value of its low 64 bits (what
    an int64 seed tensor holds)."""
    s = int(seed) & (2**64 - 1)
    return s - 2**64 if s >= 2**63 else s


def draw_uniforms(
    seeds: torch.Tensor, counters: torch.Tensor, n: int
) -> torch.Tensor:
    """Row b's draw number ``counters[b]`` of the stream ``seeds[b]``: (B, n)
    fp32 uniforms in (0, 1), one per vocabulary index.

    A pure integer function of (seed, counter, index) made of int64 ops
    whose values stay below 2**63, so the CPU and the card give the same
    bits and a row's draw never depends on its batchmates. The top 24 bits
    of the hash become ``(bits + 0.5) / 2**24``, exact in fp32. This
    replaces a per-request generator: the device holds a seed and a draw
    counter per slot (the JAX engine holds a PRNG key per slot), and the
    n-th token of a request uses its n-th draw on every path."""
    lo, hi = seeds & _M32, (seeds >> 32) & _M32
    key = _mix32(lo ^ _mix32(hi ^ 0x9E3779B9))
    key = _mix32(key ^ _mix32((counters & _M32) ^ 0x85EBCA6B))
    col = _mix32(torch.arange(n, device=seeds.device) ^ 0x27D4EB2F)
    bits = _mix32(key[:, None] ^ col[None])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _gumbel_argmax(
    logits: torch.Tensor, seeds: torch.Tensor, counters: torch.Tensor
) -> torch.Tensor:
    """Categorical draws from (B, V) logits by the Gumbel-max trick, row
    b's noise from draw ``counters[b]`` of stream ``seeds[b]``."""
    u = draw_uniforms(seeds, counters, logits.shape[-1])
    return torch.argmax(logits.float() - torch.log(-torch.log(u)), dim=-1)


def sample_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    seeds: Optional[torch.Tensor] = None,
    counters: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample token ids from (B, V) logits with static knobs.

    ``temperature == 0`` is greedy argmax. top-k keeps the k highest
    logits; top-p (nucleus) keeps the smallest prefix of the sorted
    distribution whose mass reaches p (the crossing token included).
    Filters compose k first, then p, as in the JAX package. Row b draws
    number ``counters[b]`` of stream ``seeds[b]`` (both default to 0):
    :func:`sample_logits_batched` with the knobs broadcast.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    B, dev = logits.shape[0], logits.device
    zeros = torch.zeros(B, dtype=torch.long, device=dev)
    return sample_logits_batched(
        logits,
        torch.full((B,), float(temperature), device=dev),
        torch.full((B,), int(top_k or 0), dtype=torch.long, device=dev),
        torch.full((B,), 1.0 if top_p is None else float(top_p), device=dev),
        zeros if seeds is None else seeds,
        zeros if counters is None else counters,
    )


def filter_logits_batched(
    logits: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
) -> torch.Tensor:
    """Per-row temperature, top-k and top-p of (B, V) logits, as tensors
    (rows with ``temps`` <= 0 are greedy; their filtered logits are not
    read). Returns fp32 logits with ``-inf`` outside each
    row's support. One descending sort serves both filters, as in the
    JAX package's ``sample_logits_batched``."""
    V = logits.shape[-1]
    t = torch.clamp(temps, min=1e-8)[:, None]
    lg = (logits / t).float()
    neg = float("-inf")
    sorted_desc = torch.sort(lg, dim=-1, descending=True).values
    k = torch.where((top_ks > 0) & (top_ks < V), top_ks, V).long()
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    lg = lg.masked_fill(lg < kth, neg)
    apply_p = ((top_ps > 0.0) & (top_ps < 1.0))[:, None]
    sd = sorted_desc.masked_fill(sorted_desc < kth, neg)
    probs = torch.softmax(sd, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    cutoff = torch.where(before < top_ps[:, None], sd, float("inf")).amin(
        dim=-1, keepdim=True
    )
    return lg.masked_fill(apply_p & (lg < cutoff), neg)


def sample_logits_batched(
    logits: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    seeds: torch.Tensor,
    counters: torch.Tensor,
    sampling: bool = True,
) -> torch.Tensor:
    """Per-row sampling with tensor knobs: the batched counterpart of
    :func:`sample_logits`. ``temps`` (B,) fp32 (<= 0 = greedy); ``top_ks``
    (B,) int (0 = off); ``top_ps`` (B,) fp32 (>= 1 = off); row b draws
    number ``counters[b]`` of stream ``seeds[b]``.

    ``sampling=False`` is the all-greedy variant, a bare argmax: the JAX
    sampler short-circuits to it through ``lax.cond``; a CUDA graph has no
    branch, so the caller, who knows on the host which rows sample, picks
    the variant. Every op has a fixed shape and nothing is read back."""
    greedy = torch.argmax(logits, dim=-1)
    if not sampling:
        return greedy
    lg = filter_logits_batched(logits, temps, top_ks, top_ps)
    return torch.where(temps <= 0.0, greedy,
                       _gumbel_argmax(lg, seeds, counters))


def gpt_prefill(
    params: Dict[str, Any],
    cfg: GPTConfig,
    prompt: torch.Tensor,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One parallel forward over ``prompt`` (B, P) that yields the decode
    cache: returns pre-final-norm hidden states (B, P, D) and the stacked
    K/V (L, B, P, Hkv, hd) in the compute dtype.

    Attention is causal (band-limited by ``attn_window``/``attn_sinks``),
    so row ``i`` depends only on ``prompt[:, :i+1]``: callers may
    right-pad prompts to a bucket length and read row ``true_len - 1``.
    With ``attn_impl="flash"`` each layer's attention is one flash call.
    Otherwise the prefill is one :func:`gpt_prefill_chunk` at position 0
    into an empty cache, so a prompt prefilled whole and one prefilled in
    chunks (or seeded from the prefix cache) get the same rows bit for bit.

    ``mesh`` (a serving mesh, ``parallel/mesh.py:mesh_from_spec``) splits
    the blocks over its ``"model"`` group where ``params`` holds this
    rank's slices (:func:`gpt_param_slices`): each rank's flash call runs
    on its H/m heads, and the K/V it returns are its Hkv/m heads.
    """
    from ray_lightning_tpu_torch.ops import flash_attention

    cfg.validate_variants()
    tp = _model_group(mesh)
    cdt = compute_dtype(cfg)
    H, hd = cfg.n_head, cfg.head_dim
    Hkv = cfg.kv_head
    rep = H // Hkv
    B, P = prompt.shape
    if cfg.attn_impl != "flash":
        shape = (cfg.n_layer, B, P, _local_kv_heads(params, cfg), hd)
        k = torch.zeros(shape, dtype=cdt, device=prompt.device)
        return gpt_prefill_chunk(params, cfg, prompt, k, torch.zeros_like(k), 0,
                                 mesh=mesh)
    norm_fn = _make_norm(cfg)
    pf_tables = (
        _rope_tables(torch.arange(P, device=prompt.device), cfg.rope_theta, hd)
        if cfg.pos_embed == "rope"
        else None
    )
    h = _embed_tokens(params["wte"], prompt, cfg, tp)
    if cfg.pos_embed == "learned":
        h = h + params["wpe"][:P]
    h = h.to(cdt)
    ks, vs = [], []
    for li in range(cfg.n_layer):
        lp = _layer(params["blocks"], li)
        a = norm_fn(h, lp["ln1_g"], lp["ln1_b"])
        q, k_kv, v_kv = _project_qkv(a, lp, cfg, cdt, pf_tables, repeat_kv=False)
        if Hkv != H:
            # The kernel takes H-headed K/V (the JAX callers repeat too).
            k_att = k_kv.repeat_interleave(rep, dim=2)
            v_att = v_kv.repeat_interleave(rep, dim=2)
        else:
            k_att, v_att = k_kv, v_kv
        o = flash_attention(
            q, k_att, v_att, causal=True, window=cfg.attn_window,
            sinks=cfg.attn_sinks,
        )
        if tp is None:
            h = h + torch.einsum(
                "bshk,hkd->bsd", o, dequant(lp["wo"], cdt)
            ) + lp["bo"].to(cdt)
            m = norm_fn(h, lp["ln2_g"], lp["ln2_b"])
            h = h + _dense_mlp(m, lp, cfg, cdt)
        else:
            # As _out_mlp: fp32 partial products, one rounding after the
            # sum.
            f32 = torch.float32
            o = torch.einsum("bshk,hkd->bsd", o.to(f32),
                             dequant(lp["wo"], cdt).to(f32))
            h = h + _row_split_sum(o, tp, cdt) + lp["bo"].to(cdt)
            m = norm_fn(h, lp["ln2_g"], lp["ln2_b"])
            mlp = _row_split_sum(_mlp_out(m, lp, cfg, cdt, acc=f32), tp, cdt)
            h = h + (mlp + lp["bo2"].to(cdt))
        ks.append(k_kv.to(cdt))
        vs.append(v_kv.to(cdt))
    return h, torch.stack(ks), torch.stack(vs)


#: The decode step runs its row-wise work (norms, matrix products, the LM
#: head) on blocks of this many rows, the last block padded with zeros, so
#: each of those kernels sees one shape whatever the batch. On the card a
#: GEMM's kernel, and with it the order of its sums, follows its row
#: count: without the blocks a slot's logits would round differently with
#: other batchmates.
DECODE_ROWS = 8


#: The prefill on the reference path (:func:`gpt_prefill_chunk`) runs its
#: row-wise work on blocks of this many rows, for the same reason: a row's
#: K/V and hidden state then come out the same whether the prompt is
#: prefilled whole, in chunks, or after a prefix-cache hit.
PREFILL_ROWS = 256


def _in_row_blocks(fn, *xs: torch.Tensor, rows: int = DECODE_ROWS) -> Any:
    """``fn`` on each ``rows``-row block of ``xs`` (whose row count is a
    multiple of it); a tensor result, or each one of a tuple, joined along
    the rows."""
    outs = [
        fn(*(x[i : i + rows] for x in xs))
        for i in range(0, xs[0].shape[0], rows)
    ]
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


def _in_prefill_rows(fn, *xs: torch.Tensor) -> Any:
    """``fn`` on the (B*C) rows of (B, C, ...) tensors in blocks of
    ``PREFILL_ROWS``, the last padded with zero rows; results come back as
    (B, C, ...)."""
    B, C = xs[0].shape[:2]
    n = B * C
    pad = -n % PREFILL_ROWS
    flat = [
        torch.cat([x.reshape(n, *x.shape[2:]),
                   x.new_zeros((pad, *x.shape[2:]))])
        for x in xs
    ]
    out = _in_row_blocks(fn, *flat, rows=PREFILL_ROWS)

    def cut(t):
        return t[:n].reshape(B, C, *t.shape[1:])

    return tuple(cut(t) for t in out) if isinstance(out, tuple) else cut(out)


def _qkv_rows(hb, lp, cfg, cdt, norm_fn):
    """Rows (R, D) -> the first norm and the projections: q (R, H, hd) and
    k, v (R, Hkv, hd)."""
    a = norm_fn(hb[:, None], lp["ln1_g"], lp["ln1_b"])[:, 0]
    if cfg.kv_head == cfg.n_head:
        qkv = torch.einsum(
            "bd,dthk->bthk", a, dequant(lp["wqkv"], cdt)
        ) + lp["bqkv"].to(cdt)
        return qkv[:, 0], qkv[:, 1], qkv[:, 2]
    q = torch.einsum("bd,dhk->bhk", a, dequant(lp["wq"], cdt)) + lp[
        "bq"
    ].to(cdt)
    kv = torch.einsum(
        "bd,dthk->bthk", a, dequant(lp["wkv"], cdt)
    ) + lp["bkv"].to(cdt)
    return q, kv[:, 0], kv[:, 1]


def _out_mlp_rows(hb, ob, lp, cfg, cdt, norm_fn):
    """Rows (R, D) and their attention output (R, H, hd) -> the block's
    output rows: out projection, residual, second norm, MLP, residual."""
    hb = hb + torch.einsum(
        "bhk,hkd->bd", ob, dequant(lp["wo"], cdt)
    ) + lp["bo"].to(cdt)
    m = norm_fn(hb[:, None], lp["ln2_g"], lp["ln2_b"])[:, 0]
    return hb + _dense_mlp(m, lp, cfg, cdt)


def _out_mlp(rows_fn, h, o, lp, cfg, cdt, norm_fn, tp):
    """The block's output rows from rows ``h`` and their attention output
    ``o``, the row-wise work in ``rows_fn``'s blocks (:func:`_in_row_blocks`
    or :func:`_in_prefill_rows`). With ``tp`` (the model group; ``wo`` and
    ``wo2`` hold this rank's rows) the out projection's partial sums of
    every block are summed over the group in one all-reduce of all the
    rows, then the residual, second norm and MLP run per block and the
    MLP's partial sums take one more: two collectives per layer whatever
    the row count. The partial products are fp32, rounded to the compute
    dtype once after the sum (:func:`_row_split_sum`); ``bo`` and ``bo2``
    are added after it, in the order the unsplit block adds them. A row's
    sums do not depend on the other rows, so the blocks keep the batch
    invariance."""
    if tp is None:
        return rows_fn(
            lambda hb, ob: _out_mlp_rows(hb, ob, lp, cfg, cdt, norm_fn), h, o
        )
    f32 = torch.float32
    wo = dequant(lp["wo"], cdt).to(f32)
    att = rows_fn(lambda ob: torch.einsum("bhk,hkd->bd", ob.to(f32), wo), o)
    h = h + _row_split_sum(att, tp, cdt) + lp["bo"].to(cdt)
    mlp = rows_fn(
        lambda hb: _mlp_out(
            norm_fn(hb[:, None], lp["ln2_g"], lp["ln2_b"])[:, 0], lp, cfg,
            cdt, acc=f32),
        h,
    )
    return h + (_row_split_sum(mlp, tp, cdt) + lp["bo2"].to(cdt))


def _attend_cache(
    q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
    allowed: torch.Tensor, sm_scale: float,
) -> torch.Tensor:
    """Attention of q (B, C, H, hd) over the Hkv-headed cache rows kc, vc
    (B, K, Hkv, hd) where ``allowed`` (C, K) holds, in the reference op
    order (``ops/attention.py:attention_reference``): fp32 scores, scaled,
    ``-inf`` outside the band, fp32 softmax, the probabilities rounded to
    v's dtype for the second product, whose sums are rounded once to fp32
    and then to v's dtype. Both products and the softmax's normaliser sum
    in fp64 before that rounding, so the result does not depend on the
    order in which a kernel (chosen by C and K) adds the terms. Head h
    reads kv head h // (H / Hkv), as after ``repeat_interleave``."""
    B, C, H, hd = q.shape
    Hkv = kc.shape[2]
    qg = q.reshape(B, C, Hkv, H // Hkv, hd).double()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kc.double()).float() * sm_scale
    s = s.masked_fill(~allowed, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.double().sum(-1, keepdim=True).float()
    o = torch.einsum(
        "bgrqk,bkgd->bqgrd", p.to(vc.dtype).double(), vc.double()
    )
    return o.float().to(vc.dtype).reshape(B, C, H, hd).to(q.dtype)


def _chunk_targets(rows: torch.Tensor, S: int, C: int) -> torch.Tensor:
    """Distinct cache rows for a chunk's C rows at positions ``rows``: the
    position itself while it lies in the cache, else ``position - C``, a
    row below the chunk's first that no other row of it names. A write of
    all C rows then needs no data-dependent shape: rows not to be written
    get their old value back."""
    return torch.where(rows < S, rows, rows - C).clamp(0, S - 1)


def gpt_prefill_chunk(
    params: Dict[str, Any],
    cfg: GPTConfig,
    chunk: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    start_pos: Any,
    true_len: Any = None,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cache-seeded chunked prefill: extend an existing KV range
    (``gpt.py:1114`` of the JAX package).

    ``chunk`` (B, C) holds the next C prompt tokens, right-padded: only the
    first ``true_len`` are real. ``k_cache``/``v_cache`` (L, B, S, Hkv, hd)
    already hold the K/V of positions ``[0, start_pos)``. The chunk runs one
    causal forward at absolute positions ``start_pos + i``: each layer
    writes the chunk's K/V into rows ``[start_pos, start_pos + true_len)``
    (a padded row is never written; rows past S are dropped) and then
    attends each query to the cache rows its band allows
    (:func:`_attend_cache`). Returns the pre-final-norm hidden states
    (B, C, D) and the caches, written in place.

    ``start_pos`` and ``true_len`` are ints or 0-d (or one-element) tensors
    on the chunk's device: with tensors nothing depends on their values on
    the host, which is how a captured chunk takes them. The learned
    position rows are a per-row gather, clipped, so a padded row past the
    table end reads a real row and the real rows stay exact. Every query
    attends over all S cache rows with the masked ones adding exact zeros.
    The row-wise work runs on blocks of ``PREFILL_ROWS`` rows, and the
    attention's sums in fp64, so a row comes out bit for bit the same
    whatever the chunking: the property the serving engine's chunked
    prefill and prefix cache rest on.

    With ``mesh`` (:func:`gpt_prefill`) ``params`` and the caches hold this
    rank's heads; each layer's two partial sums take one all-reduce each
    over all the chunk's rows (:func:`_out_mlp`).
    """
    from ray_lightning_tpu_torch.ops.attention import band_allowed

    cfg.validate_variants()
    tp = _model_group(mesh)
    cdt = compute_dtype(cfg)
    norm_fn = _make_norm(cfg)
    B, C = chunk.shape
    S = k_cache.shape[2]
    dev = chunk.device
    tl = C if true_len is None else true_len
    if isinstance(start_pos, torch.Tensor):
        start_pos = start_pos.reshape(())
    elif int(start_pos) < 0:
        raise ValueError(f"need start_pos >= 0, got {start_pos}")
    if isinstance(tl, torch.Tensor):
        tl = tl.reshape(())
    elif not 1 <= int(tl) <= C:
        raise ValueError(f"need 1 <= true_len <= {C}, got true_len={tl}")
    offs = torch.arange(C, device=dev)
    positions = offs + start_pos
    tgt = _chunk_targets(positions, S, C)
    write = ((offs < tl) & (positions < S))[None, :, None, None]
    x = _embed_tokens(params["wte"], chunk, cfg, tp)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][positions.clamp(max=cfg.max_seq - 1)]
    h = x.to(cdt)
    if cfg.pos_embed == "rope":
        cos, sin = _rope_tables(positions, cfg.rope_theta, cfg.head_dim)
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    allowed = band_allowed(
        positions[:, None], torch.arange(S, device=dev)[None, :],
        cfg.attn_window, cfg.attn_sinks,
    )
    sm_scale = 1.0 / (cfg.head_dim**0.5)
    for li in range(cfg.n_layer):
        lp = _layer(params["blocks"], li)
        q, k_new, v_new = _in_prefill_rows(
            lambda hb: _qkv_rows(hb, lp, cfg, cdt, norm_fn), h
        )
        if cfg.pos_embed == "rope":
            q = _rotate(q, cos, sin)
            k_new = _rotate(k_new, cos, sin)
        # Write before attending: the chunk's own rows are part of what
        # it attends to.
        kc, vc = k_cache[li], v_cache[li]
        kc[:, tgt] = torch.where(write, k_new.to(kc.dtype), kc[:, tgt])
        vc[:, tgt] = torch.where(write, v_new.to(vc.dtype), vc[:, tgt])
        o = _attend_cache(q, kc, vc, allowed, sm_scale)
        h = _out_mlp(_in_prefill_rows, h, o, lp, cfg, cdt, norm_fn, tp)
    return h, k_cache, v_cache


def gpt_decode_step(
    params: Dict[str, Any],
    cfg: GPTConfig,
    cur: torch.Tensor,
    pos: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One KV-cached decode step with per-slot positions.

    ``cur`` (B,) holds each slot's current token and ``pos`` (B,) the
    position it occupies. The step computes each token's k/v, writes them
    into the (L, B, S, Hkv, hd) caches at that slot's position, attends to
    ``position <= pos[b]`` (band-limited by the window/sinks) and returns
    fp32 logits (B, V) for the next position plus the caches. The caches
    are written in place and returned (the same tensors). Masked cache
    rows contribute exactly zero through the softmax, so stale rows from
    an evicted tenant are invisible.

    A position past the cache end (a frozen slot whose request used the
    whole cache) is clamped for the embedding read and the cache write,
    where XLA clamps its gather and dynamic_update_slice; such a slot's
    output is never read.

    With ``mesh`` (:func:`gpt_prefill`) each rank runs the fp64 attention
    on its own heads only (heads are independent, so those rows are
    bitwise the unsplit step's) and sums the out projection's and the
    MLP's partial outputs over the model group, two all-reduces of the
    (Bp, D) rows per layer (:func:`_out_mlp`).
    """
    from ray_lightning_tpu_torch.ops.attention import band_allowed

    cfg.validate_variants()
    tp = _model_group(mesh)
    cdt = compute_dtype(cfg)
    norm_fn = _make_norm(cfg)
    hd = cfg.head_dim
    B = cur.shape[0]
    Bp = -(-B // DECODE_ROWS) * DECODE_ROWS
    S = k_cache.shape[2]
    pos_w = pos.clamp(max=S - 1)
    slots = torch.arange(B, device=cur.device)

    x = _embed_tokens(params["wte"], cur, cfg, tp)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][pos.clamp(max=cfg.max_seq - 1)]
    # (Bp, D): the rows past B are zeros, carried along and never read.
    h = F.pad(x.to(cdt), (0, 0, 0, Bp - B))
    if cfg.pos_embed == "rope":
        cos, sin = _rope_tables(pos, cfg.rope_theta, hd)  # (B, half)
        cos, sin = cos[:, None, :], sin[:, None, :]
    allowed = band_allowed(
        pos[:, None, None, None],
        torch.arange(S, device=cur.device)[None, None, None],
        cfg.attn_window,
        cfg.attn_sinks,
    )  # (B, 1, 1, S)
    for li in range(cfg.n_layer):
        lp = _layer(params["blocks"], li)
        q, k_new, v_new = (
            t[:B]
            for t in _in_row_blocks(
                lambda hb: _qkv_rows(hb, lp, cfg, cdt, norm_fn), h
            )
        )
        if cfg.pos_embed == "rope":
            q = _rotate(q, cos, sin)
            k_new = _rotate(k_new, cos, sin)
        # In place: one cache in memory, each slot's row at its position.
        kc, vc = k_cache[li], v_cache[li]
        kc[slots, pos_w] = k_new.to(kc.dtype)
        vc[slots, pos_w] = v_new.to(vc.dtype)
        o = _decode_attend(q, kc.double(), vc.double(), allowed, cdt)
        o = F.pad(o, (0, 0, 0, 0, 0, Bp - B))
        h = _out_mlp(_in_row_blocks, h, o, lp, cfg, cdt, norm_fn, tp)
    return _decode_logits(params, cfg, h, norm_fn, tp)[:B], k_cache, v_cache


def _decode_attend(
    q: torch.Tensor, kd: torch.Tensor, vd: torch.Tensor,
    allowed: torch.Tensor, cdt: torch.dtype,
) -> torch.Tensor:
    """One query per slot: q (B, H, hd) against the fp64 copy of the
    Hkv-headed cache kd, vd (B, S, Hkv, hd) where ``allowed`` (B, 1, 1, S)
    holds; returns (B, H, hd) in ``cdt``. Head h reads kv head
    h // (H / Hkv), matching the prefill's repeat_interleave. It runs in
    fp64, which rounds 2^29 times finer than fp32: the order in which the
    kernels (chosen by B and S) add the terms then does not reach the
    compute-dtype result."""
    B, H, hd = q.shape
    Hkv = kd.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, hd).double()
    s = torch.einsum("bgrk,bsgk->bgrs", qg * (1.0 / np.sqrt(hd)), kd)
    s = s.masked_fill(~allowed, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgrs,bsgk->bgrk", p, vd).reshape(B, H, hd).to(cdt)


def _decode_logits(params, cfg, h, norm_fn, tp=None) -> torch.Tensor:
    """Final norm and LM head of decode rows h (R, D), R a multiple of
    ``DECODE_ROWS``, in blocks of that many rows: fp32 logits (R, V). A
    head split over the model group ``tp`` (a vocab it divides) gives each
    rank V/m columns, gathered whole."""
    w_head = _head_weight(params, cfg)

    def head(hb):
        hb = norm_fn(hb[:, None], params["lnf_g"], params["lnf_b"])[:, 0]
        return _lm_head(hb, w_head)

    out = _in_row_blocks(head, h)
    if tp is None or w_head.shape[0] == cfg.vocab_size:
        return out
    return gather_from_model(out, -1, tp)


def gpt_decode_fold(
    params: Dict[str, Any],
    cfg: GPTConfig,
    cur: torch.Tensor,
    pos: torch.Tensor,
    seeds: torch.Tensor,
    counters: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    active: torch.Tensor,
    remaining: torch.Tensor,
    eos_toks: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    fold: int,
    sampling: bool = True,
    page_table: Optional[torch.Tensor] = None,
    page_size: int = 0,
    piggyback: Optional[ChunkRows] = None,
    mesh: Any = None,
) -> Tuple[torch.Tensor, ...]:
    """``fold`` decode+sample iterations with per-slot termination on the
    device: the serving engine's hot loop.

    Each iteration decodes every slot, samples, and advances only the
    active slots; a slot whose sampled token equals its eos (``eos_toks``
    -1 = off) or whose ``remaining`` budget hits zero freezes mid-fold, so
    no post-EOS token is emitted. The host reads nothing until the fold
    ends. A slot's token uses draw ``counters[slot]`` of its stream
    ``seeds[slot]``, and the counter advances with each emitted token, so
    a request's n-th token uses its n-th draw. ``sampling=False`` is the
    all-greedy variant (see :func:`sample_logits_batched`).

    With ``page_table`` set, ``k_cache``/``v_cache`` are the page pools
    (L, P, page_size, Hkv, hd) and each iteration runs
    :func:`gpt_decode_step_paged`: gather, the same dense step, scatter.

    Returns ``(tok_block (fold, B) int with -1 at non-emitted lanes,
    emit_block (fold, B) bool, cur, pos, counters, active, remaining,
    k_cache, v_cache)``: the JAX fold's outputs with the counters where it
    returns its keys. With ``piggyback`` (:func:`piggyback_prefill`) its
    chunk rows run after the iterations and their ``pb_toks`` are
    appended. ``mesh``: see :func:`gpt_decode_step`; every rank samples
    the same reduced logits with the same draws, so the ranks emit the
    same tokens.
    """
    toks_out, emits_out = [], []
    for _ in range(int(fold)):
        if page_table is None:
            logits, k_cache, v_cache = gpt_decode_step(
                params, cfg, cur, pos, k_cache, v_cache, mesh=mesh
            )
        else:
            logits, k_cache, v_cache = gpt_decode_step_paged(
                params, cfg, cur, pos, k_cache, v_cache, page_table,
                page_size, mesh=mesh,
            )
        toks = sample_logits_batched(logits, temps, top_ks, top_ps, seeds,
                                     counters, sampling).to(cur.dtype)
        emit = active
        toks_out.append(torch.where(emit, toks, -1))
        emits_out.append(emit)
        cur = torch.where(active, toks, cur)
        pos = torch.where(active, pos + 1, pos)
        counters = torch.where(active, counters + 1, counters)
        remaining = torch.where(active, remaining - 1, remaining)
        active = active & (remaining > 0) & (toks != eos_toks)
    out = (
        torch.stack(toks_out), torch.stack(emits_out), cur, pos, counters,
        active, remaining, k_cache, v_cache,
    )
    if piggyback is None:
        return out
    return out + (piggyback_prefill(
        params, cfg, piggyback, cur, pos, counters, active, remaining, temps,
        top_ks, top_ps, seeds, k_cache, v_cache, sampling=sampling,
        page_table=page_table, page_size=page_size, mesh=mesh,
    ),)


def gpt_decode_verify(
    params: Dict[str, Any],
    cfg: GPTConfig,
    toks: torch.Tensor,
    pos: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward over Q candidate tokens per slot: the verify half of
    speculative decoding (``gpt.py:1697`` of the JAX package).

    ``toks`` (B, Q) holds each slot's current token followed by Q - 1
    draft tokens; ``pos`` (B,) is the position of the current token, so
    row i sits at position ``pos + i``. The K/V of every row are written
    into the cache rows ``[pos, pos + Q)`` (in place); rows at or past
    the cache end are dropped, never clamped, since a clamp would
    overwrite row S - 1, a real row. Row i attends to ``position <= pos +
    i``. Returns fp32 logits (B, Q, V): ``logits[:, i]`` predicts the
    token after row i, and the caches.

    This is :func:`gpt_decode_step` with a query axis, op for op: the
    B * Q rows' row-wise work runs in ``DECODE_ROWS`` blocks and each
    query's attention through the step's own fp64 attention at batch B,
    so ``logits[:, i]`` is bitwise what i + 1 sequential decode steps
    give. Rows of rejected drafts leave K/V above the slot's accepted
    position: masked there, and rewritten by the next verify before any
    query reads them. ``mesh``: as :func:`gpt_decode_step`.
    """
    from ray_lightning_tpu_torch.ops.attention import band_allowed

    cfg.validate_variants()
    tp = _model_group(mesh)
    cdt = compute_dtype(cfg)
    norm_fn = _make_norm(cfg)
    B, Q = toks.shape
    R = B * Q
    Rp = -(-R // DECODE_ROWS) * DECODE_ROWS
    S = k_cache.shape[2]
    dev = toks.device
    positions = pos[:, None] + torch.arange(Q, device=dev)[None]  # (B, Q)
    flat = positions.reshape(-1)
    x = _embed_tokens(params["wte"], toks.reshape(-1), cfg, tp)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][flat.clamp(max=cfg.max_seq - 1)]
    # (Rp, D), row b * Q + i; the rows past R are zeros, never read.
    h = F.pad(x.to(cdt), (0, 0, 0, Rp - R))
    if cfg.pos_embed == "rope":
        cos, sin = _rope_tables(flat, cfg.rope_theta, cfg.head_dim)
        cos, sin = cos[:, None, :], sin[:, None, :]
    # Every (slot, row) is written: the rows past the cache end get their
    # old value back at distinct rows below the slot's first (a clamp would
    # overwrite row S - 1, a real row), so no shape depends on the data.
    write = (positions < S)[..., None, None]
    w_slot = torch.arange(B, device=dev)[:, None].expand(B, Q)
    w_pos = _chunk_targets(positions, S, Q)
    cols = torch.arange(S, device=dev)[None, None, None]
    allowed = [
        band_allowed(positions[:, i, None, None, None], cols,
                     cfg.attn_window, cfg.attn_sinks)
        for i in range(Q)
    ]  # each (B, 1, 1, S), as the step's
    for li in range(cfg.n_layer):
        lp = _layer(params["blocks"], li)
        q, k_new, v_new = (
            t[:R]
            for t in _in_row_blocks(
                lambda hb: _qkv_rows(hb, lp, cfg, cdt, norm_fn), h
            )
        )
        if cfg.pos_embed == "rope":
            q = _rotate(q, cos, sin)
            k_new = _rotate(k_new, cos, sin)
        kc, vc = k_cache[li], v_cache[li]
        kc[w_slot, w_pos] = torch.where(
            write, k_new.reshape(B, Q, *k_new.shape[1:]).to(kc.dtype),
            kc[w_slot, w_pos],
        )
        vc[w_slot, w_pos] = torch.where(
            write, v_new.reshape(B, Q, *v_new.shape[1:]).to(vc.dtype),
            vc[w_slot, w_pos],
        )
        kd, vd = kc.double(), vc.double()
        qb = q.reshape(B, Q, *q.shape[1:])
        o = torch.stack(
            [_decode_attend(qb[:, i].contiguous(), kd, vd, allowed[i], cdt)
             for i in range(Q)],
            dim=1,
        )
        o = F.pad(o.reshape(R, *o.shape[2:]), (0, 0, 0, 0, 0, Rp - R))
        h = _out_mlp(_in_row_blocks, h, o, lp, cfg, cdt, norm_fn, tp)
    logits = _decode_logits(params, cfg, h, norm_fn, tp)[:R]
    return logits.reshape(B, Q, -1), k_cache, v_cache


# -- Paged KV: block-table attention over a shared page pool ---------------
# A paged engine gives each slot a page table: ``table[b, i]`` names the pool
# page holding positions [i * page, (i + 1) * page) of slot b. Each function
# gathers the slots' pages into the dense layout, runs the dense function
# unchanged, and scatters the rows that function wrote back through the
# table. The gathered view is a copy, so writes into it never reach the pool
# by themselves. Pool page 0 is the scratch page: released and unallocated
# table entries point there, and so do rows that are not to be kept.


def paged_gather(pool: torch.Tensor, table: torch.Tensor, page: int) -> torch.Tensor:
    """Dense view of each slot's paged cache (``gpt.py:1880`` of the JAX
    package): ``pool`` (L, P, page, Hkv, hd) gathered through ``table``
    (B, n) into a new (L, B, n * page, Hkv, hd) tensor."""
    L, _, pg, Hkv, hd = pool.shape
    B, n = table.shape
    return pool.index_select(1, table.reshape(-1)).reshape(L, B, n * pg, Hkv, hd)


def paged_put_rows(
    pool: torch.Tensor,
    table: torch.Tensor,
    rows: torch.Tensor,
    vals: torch.Tensor,
    valid: torch.Tensor,
    page: int,
) -> torch.Tensor:
    """Scatter per-slot cache rows into the pool in place (``gpt.py:1894``
    of the JAX package): ``rows`` (B, R) positions, ``vals`` (L, B, R, Hkv,
    hd), ``valid`` (B, R). Invalid rows (padding, positions past the view)
    go to row 0 of the scratch page, which nothing reads. Returns
    ``pool``."""
    n = table.shape[1]
    rows_cl = rows.clamp(0, n * page - 1)
    pidx = torch.gather(table, 1, rows_cl // page)
    pidx = torch.where(valid, pidx, 0)
    off = torch.where(valid, rows_cl % page, 0)
    pool[:, pidx, off] = vals.to(pool.dtype)
    return pool


def gpt_decode_step_paged(
    params: Dict[str, Any],
    cfg: GPTConfig,
    cur: torch.Tensor,
    pos: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    table: torch.Tensor,
    page: int,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gpt_decode_step` over a paged cache (``gpt.py:1916`` of the
    JAX package): gather each slot's pages, run the dense step unchanged
    (the same logits, bit for bit), and scatter the one row per slot it
    wrote, at ``min(pos, S - 1)``, the dense step's own clamp, back to its
    page. Returns the logits and the pools, written in place."""
    S = table.shape[1] * int(page)
    k_view = paged_gather(pool_k, table, page)
    v_view = paged_gather(pool_v, table, page)
    logits, k_view, v_view = gpt_decode_step(
        params, cfg, cur, pos, k_view, v_view, mesh=mesh
    )
    p = pos.clamp(0, S - 1)
    slots = torch.arange(cur.shape[0], device=cur.device)
    rows = p[:, None]
    valid = torch.ones_like(rows, dtype=torch.bool)
    paged_put_rows(pool_k, table, rows, k_view[:, slots, p][:, :, None],
                   valid, page)
    paged_put_rows(pool_v, table, rows, v_view[:, slots, p][:, :, None],
                   valid, page)
    return logits, pool_k, pool_v


def gpt_decode_verify_paged(
    params: Dict[str, Any],
    cfg: GPTConfig,
    toks: torch.Tensor,
    pos: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    table: torch.Tensor,
    page: int,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gpt_decode_verify` over a paged cache (``gpt.py:1948`` of the
    JAX package): gather, the dense verify unchanged, and scatter rows
    ``[pos, pos + Q)`` back; rows past the view's end go to scratch, as
    the dense verify drops them."""
    B, Q = toks.shape
    S = table.shape[1] * int(page)
    k_view = paged_gather(pool_k, table, page)
    v_view = paged_gather(pool_v, table, page)
    logits, k_view, v_view = gpt_decode_verify(
        params, cfg, toks, pos, k_view, v_view, mesh=mesh
    )
    rows = pos[:, None] + torch.arange(Q, device=toks.device)[None]
    valid = rows < S
    cl = rows.clamp(0, S - 1)
    b = torch.arange(B, device=toks.device)[:, None]
    paged_put_rows(pool_k, table, rows, k_view[:, b, cl], valid, page)
    paged_put_rows(pool_v, table, rows, v_view[:, b, cl], valid, page)
    return logits, pool_k, pool_v


def gpt_prefill_chunk_paged(
    params: Dict[str, Any],
    cfg: GPTConfig,
    chunk: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    table_row: torch.Tensor,
    start_pos: Any,
    true_len: Any = None,
    *,
    page: int,
    mesh: Any = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`gpt_prefill_chunk` for one paged slot (``gpt.py:1981`` of the
    JAX package): ``table_row`` (1, n) is that slot's page table. Gather
    the slot's view, run the dense chunk unchanged, and scatter rows
    ``[start_pos, start_pos + true_len)`` back; padded rows and rows past
    the view go to scratch (the dense chunk never writes them)."""
    C = chunk.shape[1]
    S = table_row.shape[1] * int(page)
    tl = C if true_len is None else true_len
    k_view = paged_gather(pool_k, table_row, page)
    v_view = paged_gather(pool_v, table_row, page)
    h, k_view, v_view = gpt_prefill_chunk(
        params, cfg, chunk, k_view, v_view, start_pos, tl, mesh=mesh
    )
    offs = torch.arange(C, device=chunk.device)
    if isinstance(start_pos, torch.Tensor):
        start_pos = start_pos.reshape(())
    if isinstance(tl, torch.Tensor):
        tl = tl.reshape(())
    rows = (start_pos + offs)[None]  # (1, C)
    valid = (offs < tl)[None] & (rows < S)
    cl = rows.clamp(0, S - 1)[0]
    paged_put_rows(pool_k, table_row, rows, k_view[:, :, cl], valid, page)
    paged_put_rows(pool_v, table_row, rows, v_view[:, :, cl], valid, page)
    return h, pool_k, pool_v



# -- Piggybacked prefill chunks ----------------------------------------------


def first_token(
    params: Dict[str, Any],
    cfg: GPTConfig,
    h_last: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    seeds: torch.Tensor,
    counters: torch.Tensor,
    sampling: bool = True,
    mesh: Any = None,
) -> torch.Tensor:
    """Prompts' first tokens from ``h_last`` (N, 1, D), the pre-final-norm
    hidden state of each prompt's last position: final norm, LM head, and
    draw ``counters`` of streams ``seeds`` under the (N,) knobs (greedy
    where ``temps`` <= 0). Returns (N,) on the device."""
    h = _make_norm(cfg)(h_last, params["lnf_g"], params["lnf_b"])
    logits = gpt_logits(params, h[:, 0], cfg, _model_group(mesh))
    return sample_logits_batched(logits, temps, top_ks, top_ps, seeds,
                                 counters, sampling)


@dataclass
class ChunkRow:
    """One prefill chunk, as the host plans it: the slot, its next prompt
    tokens ``tokens`` (a host array of ``length`` real tokens) at positions
    ``start ..``, and on the prompt's ``final`` chunk the budget ``n_new``
    and ``eos`` (-1 = off) the slot is armed with."""

    slot: int
    tokens: Any
    start: int
    length: int
    final: bool = False
    n_new: int = 0
    eos: int = -1


class ChunkRows:
    """C chunk rows as device tensors: the JAX package's piggyback arrays
    (``gpt.py:1459``), packed into one (C, CB + 7) int64 buffer so the host
    fills them with one copy. ``chunk`` (C, CB) holds each row's tokens,
    right-padded; ``start``, ``length``, ``slot``, ``n_new`` and ``eos``
    are (C,) views; ``final`` and ``valid`` (C,) bool. A row that is not
    ``valid`` is a no-op: a fused dispatch always carries C rows, as the
    JAX block does, so a captured fold has one shape."""

    _FIELDS = ("start", "length", "slot", "n_new", "eos", "final", "valid")

    def __init__(self, n_rows: int, chunk_len: int, device: Any = "cpu"):
        self.chunk_len = int(chunk_len)
        self.buf = torch.zeros((n_rows, self.chunk_len + len(self._FIELDS)),
                               dtype=torch.long, device=device)

    @property
    def chunk(self) -> torch.Tensor:
        return self.buf[:, : self.chunk_len]

    def _col(self, name: str) -> torch.Tensor:
        return self.buf[:, self.chunk_len + self._FIELDS.index(name)]

    start = property(lambda self: self._col("start"))
    length = property(lambda self: self._col("length"))
    slot = property(lambda self: self._col("slot"))
    n_new = property(lambda self: self._col("n_new"))
    eos = property(lambda self: self._col("eos"))
    final = property(lambda self: self._col("final") != 0)
    valid = property(lambda self: self._col("valid") != 0)

    def fill(self, rows: Sequence[ChunkRow]) -> None:
        """Write ``rows`` (at most C) into the buffer in place, the rest
        invalid: one copy, pinned and non-blocking on the card."""
        from ray_lightning_tpu_torch.utils.graphs import pinned_copy

        C = self.buf.shape[0]
        if len(rows) > C:
            raise ValueError(f"{len(rows)} chunk rows for {C} row buffers")
        host = torch.zeros(self.buf.shape, dtype=torch.long)
        for i, r in enumerate(rows):
            host[i, : r.length] = torch.as_tensor(
                np.asarray(r.tokens[: r.length], np.int64))
            host[i, self.chunk_len :] = torch.tensor(
                [r.start, r.length, r.slot, r.n_new, r.eos, int(r.final), 1])
        pinned_copy(self.buf, host)


def _prefill_slot(params, cfg, chunk, k_cache, v_cache, slot, start, length,
                  page_table, page_size, mesh=None) -> torch.Tensor:
    """:func:`gpt_prefill_chunk` of one (1, C) chunk on the slot named by
    the (1,) tensor ``slot``: its view of the cache (its rows, or its pages
    through its table row) gathered, the chunk run on the view, and the
    chunk's rows written back (their targets are distinct, so the write is
    one index_put). Returns the hidden states (1, C, D)."""
    if page_table is not None:
        h, _, _ = gpt_prefill_chunk_paged(
            params, cfg, chunk, k_cache, v_cache,
            page_table.index_select(0, slot), start, length, page=page_size,
            mesh=mesh,
        )
        return h
    kv, vv = k_cache.index_select(1, slot), v_cache.index_select(1, slot)
    h, kv, vv = gpt_prefill_chunk(params, cfg, chunk, kv, vv, start, length,
                                  mesh=mesh)
    C, S = chunk.shape[1], k_cache.shape[2]
    tgt = _chunk_targets(torch.arange(C, device=chunk.device) + start, S, C)
    rows = slot.expand(C)
    # The view holds the cache's own values outside the rows the chunk
    # wrote, so all C targets are written back as they are.
    k_cache[:, rows, tgt] = kv[:, 0, tgt]
    v_cache[:, rows, tgt] = vv[:, 0, tgt]
    return h


def _put(state: torch.Tensor, slot: torch.Tensor, when: torch.Tensor,
         value: Any) -> None:
    """``state[slot] = value`` where ``when`` holds, else unchanged, with
    no host read (``slot`` a (1,) tensor)."""
    old = state.index_select(0, slot)
    state.index_copy_(0, slot, torch.where(when, value, old).to(state.dtype))


def piggyback_prefill(
    params: Dict[str, Any],
    cfg: GPTConfig,
    rows: ChunkRows,
    cur: torch.Tensor,
    pos: torch.Tensor,
    counters: torch.Tensor,
    active: torch.Tensor,
    remaining: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    seeds: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    sampling: bool = True,
    hist: Optional[torch.Tensor] = None,
    page_table: Optional[torch.Tensor] = None,
    page_size: int = 0,
    mesh: Any = None,
) -> torch.Tensor:
    """Prefill chunk rows, each on its own slot (``_piggyback_prefill``,
    ``gpt.py:1459`` of the JAX package): :func:`gpt_prefill_chunk` over
    the slot's rows ``[start, start + length)`` (the paged one through the
    slot's table row with ``page_table``), the token history healed over
    the same rows when ``hist`` is given, and then either the slot parked
    at the next chunk's first row or, on a final chunk, the first token
    (:func:`first_token`, the slot's draw 0) and the slot armed: ``cur``,
    ``pos``, ``active``, ``remaining`` and ``counters`` (1). The sampling
    knobs and seed are the slot's own, which its admission wrote. Caches,
    state and history are written in place; returns (C,) with the first
    token at valid final rows, -1 elsewhere.

    A fold runs this after its iterations: a parked slot's lane writes
    one cache row at its position during the fold, and the chunk rewrites
    that row. Every row runs whether valid or not, so the work has one
    shape: an invalid row writes its slot's state and rows back unchanged.
    The engine's separate chunk is this function with one row, so a
    piggybacked chunk is that chunk bit for bit."""
    C = rows.chunk.shape[0]
    toks = []
    for i in range(C):
        s = rows.slot[i : i + 1]
        ok = rows.valid[i]
        start, n = rows.start[i], rows.length[i]
        h = _prefill_slot(params, cfg, rows.chunk[i : i + 1], k_cache,
                          v_cache, s, start, torch.where(ok, n, 0),
                          page_table, page_size, mesh)
        end = start + n
        if hist is not None:
            cols = torch.arange(hist.shape[1], device=hist.device)
            src = rows.chunk[i].index_select(
                0, (cols - start).clamp(0, rows.chunk.shape[1] - 1))
            inside = ok & (cols >= start) & (cols < end)
            hist.index_copy_(0, s, torch.where(
                inside, src, hist.index_select(0, s)[0])[None])
        _put(pos, s, ok, end)
        fin = ok & rows.final[i]
        h_last = h.index_select(1, (n - 1).clamp(min=0).reshape(1))
        tok = first_token(
            params, cfg, h_last, temps.index_select(0, s),
            top_ks.index_select(0, s), top_ps.index_select(0, s),
            seeds.index_select(0, s), torch.zeros_like(s), sampling,
            mesh=mesh,
        ).to(cur.dtype)
        _put(cur, s, fin, tok)
        _put(active, s, fin, (rows.n_new[i] > 1) & (tok != rows.eos[i]))
        _put(remaining, s, fin, rows.n_new[i] - 1)
        _put(counters, s, fin, 1)
        toks.append(torch.where(fin, tok, -1))
    return torch.cat(toks)


# -- Speculative decoding: drafters and the verify fold ---------------------


def ngram_propose(
    hist: torch.Tensor, pos: torch.Tensor, cur: torch.Tensor, *, depth: int
) -> torch.Tensor:
    """The n-gram (prompt-lookup) drafter, no weights (``gpt.py:2017`` of
    the JAX package): ``hist`` (B, S) is each slot's token history (live
    at positions ``<= pos``), ``cur`` (B,) the token at ``pos``. Finds the
    latest earlier occurrence of the bigram ending at ``cur`` and proposes
    the ``depth`` tokens that followed it; else the latest occurrence of
    ``cur`` alone; else repeats ``cur``. Continuations past ``pos`` are
    ``cur``. Returns (B, depth)."""
    B, S = hist.shape
    dev = hist.device
    rows = torch.arange(S, device=dev)[None]
    # Clamped gathers: a frozen slot's pos may sit past the history's end
    # (XLA clamps its gathers; that slot's drafts are never emitted).
    prev = torch.gather(hist, 1, (pos - 1).clamp(0, S - 1)[:, None])[:, 0]
    hist_prev = torch.cat([hist.new_zeros((B, 1)), hist[:, :-1]], dim=1)
    in_past = (rows >= 1) & (rows <= pos[:, None] - 1)
    uni = in_past & (hist == cur[:, None])
    bi = uni & (hist_prev == prev[:, None])
    j_bi = torch.where(bi, rows, -1).amax(dim=1)
    j_uni = torch.where(uni, rows, -1).amax(dim=1)
    j = torch.where(j_bi >= 0, j_bi, j_uni)
    cont = j[:, None] + 1 + torch.arange(depth, device=dev)[None]
    ok = (j[:, None] >= 0) & (cont <= pos[:, None])
    drafts = torch.gather(hist, 1, cont.clamp(0, S - 1))
    return torch.where(ok, drafts, cur[:, None])


def model_propose(
    draft_params: Dict[str, Any],
    draft_cfg: GPTConfig,
    hist: torch.Tensor,
    pos: torch.Tensor,
    cur: torch.Tensor,
    *,
    depth: int,
    window: int,
) -> torch.Tensor:
    """The draft-model drafter (``gpt.py:2057`` of the JAX package): a
    small GPT prefills each slot's last ``window`` history tokens (at
    positions 0..window-1, through :func:`gpt_prefill`, so under
    ``attn_impl="flash"`` the flash kernel) and then proposes ``depth``
    greedy tokens through :func:`gpt_decode_step` on a throwaway cache.
    Stateless: nothing to keep in step with accepts, recycles or prefix
    seeds. A history shorter than the window is left-filled with its
    first token. ``cur`` is already in ``hist`` at ``pos``. Returns (B,
    depth)."""
    B, S = hist.shape
    dev = hist.device
    idx = pos[:, None] - window + 1 + torch.arange(window, device=dev)[None]
    toks_w = torch.gather(hist, 1, idx.clamp(0, S - 1))
    toks_w = torch.where(idx >= 0, toks_w, hist[:, :1])
    h_pf, pf_k, pf_v = gpt_prefill(draft_params, draft_cfg, toks_w)
    norm_fn = _make_norm(draft_cfg)
    shape = (draft_cfg.n_layer, B, window + depth, draft_cfg.kv_head,
             draft_cfg.head_dim)
    kc = torch.zeros(shape, dtype=compute_dtype(draft_cfg), device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :, :window] = pf_k
    vc[:, :, :window] = pf_v
    h_last = norm_fn(h_pf[:, window - 1 : window], draft_params["lnf_g"],
                     draft_params["lnf_b"])[:, 0]
    t = torch.argmax(
        _lm_head(h_last, _head_weight(draft_params, draft_cfg)), dim=-1
    )
    drafts = [t]
    for i in range(depth - 1):
        logits, kc, vc = gpt_decode_step(
            draft_params, draft_cfg, t,
            torch.full((B,), window + i, dtype=torch.long, device=dev), kc, vc,
        )
        t = torch.argmax(logits, dim=-1)
        drafts.append(t)
    return torch.stack(drafts, dim=1)


def _hist_write_at(
    hist: torch.Tensor, pos: torch.Tensor, tok: torch.Tensor
) -> torch.Tensor:
    """``hist[b, pos[b]] = tok[b]`` for every slot whose ``pos`` lies in
    the history (``gpt.py:2264`` of the JAX package)."""
    rows = torch.arange(hist.shape[1], device=hist.device)[None]
    return torch.where(rows == pos[:, None], tok[:, None], hist)


def gpt_decode_fold_spec(
    params: Dict[str, Any],
    cfg: GPTConfig,
    cur: torch.Tensor,
    pos: torch.Tensor,
    seeds: torch.Tensor,
    counters: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    active: torch.Tensor,
    remaining: torch.Tensor,
    eos_toks: torch.Tensor,
    hist: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    *,
    fold: int,
    depth: int,
    draft_fn: Any,
    sampling: bool = True,
    page_table: Optional[torch.Tensor] = None,
    page_size: int = 0,
    piggyback: Optional[ChunkRows] = None,
    mesh: Any = None,
) -> Tuple[torch.Tensor, ...]:
    """Speculative :func:`gpt_decode_fold` (``gpt.py:2113`` of the JAX
    package): each of the ``fold`` iterations drafts ``depth`` tokens per
    slot (``draft_fn(hist, pos, cur)``), scores positions ``pos .. pos +
    depth`` with one :func:`gpt_decode_verify` (the paged one with
    ``page_table``), and accepts the longest prefix whose samples match
    the drafts: 1 to depth + 1 emitted tokens per slot and verify.

    The accept scan samples index i from ``logits[:, i]``, which saw only
    inputs already verified, and stops at the first sample that differs
    from its draft; that sample is itself the right next token. EOS and
    the budget freeze a slot mid-scan, as in :func:`gpt_decode_fold`.

    Draws: a slot's n-th emitted token must use its n-th draw, whatever
    the accept lengths, so a sampled request gives the same tokens with and
    without speculation and with any batchmates. Scan index i of a slot
    that is still emitting follows i emitted tokens of this verify, so it
    samples with draw ``counters + i``; after the scan the counters advance
    by the emitted counts on the device. Nothing is read back.

    ``hist`` (B, S) is the token history the drafters read: the fold
    writes ``cur`` at ``pos`` and every emitted token at its position.
    Returns ``(tok_block (fold * (depth + 1), B) with -1 at non-emitted
    lanes, emit_block, cur, pos, counters, active, remaining, hist,
    k_cache, v_cache)``; with ``piggyback`` its chunk rows run after the
    iterations (:func:`piggyback_prefill`, which also heals their history
    rows) and ``pb_toks`` is appended. ``mesh``: as
    :func:`gpt_decode_fold`; ``draft_fn`` runs on whole weights on every
    rank (a draft model is not split).
    """
    D = int(depth)
    B = cur.shape[0]
    dev = cur.device
    rows = torch.arange(hist.shape[1], device=dev)[None]
    no_draft = torch.full((B, 1), -1, dtype=cur.dtype, device=dev)
    toks_out, emits_out = [], []
    for _ in range(int(fold)):
        # The current token enters the history before drafting (it covers
        # a token sampled at admission; later it rewrites the same value).
        hist = _hist_write_at(hist, pos, cur)
        drafts = draft_fn(hist, pos, cur).to(cur.dtype)
        toks_in = torch.cat([cur[:, None], drafts], dim=1)
        if page_table is None:
            logits, k_cache, v_cache = gpt_decode_verify(
                params, cfg, toks_in, pos, k_cache, v_cache, mesh=mesh
            )
        else:
            logits, k_cache, v_cache = gpt_decode_verify_paged(
                params, cfg, toks_in, pos, k_cache, v_cache, page_table,
                page_size, mesh=mesh,
            )
        pos0 = pos
        # The last index has no draft to match: the -1 sentinel stops the
        # scan there (tokens are >= 0).
        drafts_pad = torch.cat([drafts, no_draft], dim=1)
        accepting = torch.ones_like(active)
        emitted = []
        for i in range(D + 1):
            emit = active & accepting
            toks = sample_logits_batched(
                logits[:, i], temps, top_ks, top_ps, seeds, counters + i,
                sampling,
            ).to(cur.dtype)
            cur = torch.where(emit, toks, cur)
            pos = torch.where(emit, pos + 1, pos)
            remaining = torch.where(emit, remaining - 1, remaining)
            live = (remaining > 0) & (toks != eos_toks)
            active = torch.where(emit, live, active)
            accepting = emit & live & (toks == drafts_pad[:, i])
            emitted.append(torch.where(emit, toks, -1))
            emits_out.append(emit)
        toks_out += emitted
        n_emit = pos - pos0
        counters = counters + n_emit
        # Emitted tokens enter the history at positions pos0 + 1 .. pos.
        offs = rows - (pos0[:, None] + 1)
        hvalid = (offs >= 0) & (offs < n_emit[:, None])
        em = torch.stack(emitted, dim=1)  # (B, D + 1)
        hist = torch.where(hvalid, torch.gather(em, 1, offs.clamp(0, D)), hist)
    out = (
        torch.stack(toks_out), torch.stack(emits_out), cur, pos, counters,
        active, remaining, hist, k_cache, v_cache,
    )
    if piggyback is None:
        return out
    return out + (piggyback_prefill(
        params, cfg, piggyback, cur, pos, counters, active, remaining, temps,
        top_ks, top_ps, seeds, k_cache, v_cache, sampling=sampling, hist=hist,
        page_table=page_table, page_size=page_size, mesh=mesh,
    ),)


def gpt_generate(
    params: Dict[str, Any],
    cfg: GPTConfig,
    prompt: Any,
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    device: Any = "cuda",
) -> torch.Tensor:
    """Autoregressive decode with a KV cache: prompt (B, P) -> (B, P +
    max_new_tokens) on ``device``.

    A prefill (one parallel forward over the prompt fills the (L, B,
    P + new, Hkv, hd) cache and samples the first new token), then one
    cached decode step per further token. Greedy when ``temperature ==
    0``; otherwise row b samples its n-th new token with draw n of the
    stream ``seed + b`` (:func:`draw_uniforms`), as the serving engine
    samples a request with that seed, with optional top-k / top-p.
    ``params`` move to ``device`` if they are elsewhere.
    """
    device = resolve_device(device)
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=device)
    B, P = prompt.shape
    total = P + int(max_new_tokens)
    if total > cfg.max_seq:
        raise ValueError(
            f"prompt + max_new_tokens = {total} exceeds max_seq {cfg.max_seq}"
        )
    cfg.validate_variants()
    if int(max_new_tokens) == 0:
        return prompt
    params = cast_params(params_to(params, device), cfg)
    cdt = compute_dtype(cfg)
    norm_fn = _make_norm(cfg)
    L, hd, Hkv = cfg.n_layer, cfg.head_dim, cfg.kv_head
    seeds = torch.tensor([seed64(int(seed) + b) for b in range(B)],
                         dtype=torch.long).to(device)

    def sample(logits, n):
        counters = torch.full((B,), n, dtype=torch.long, device=device)
        return sample_logits(logits, temperature, top_k, top_p, seeds,
                             counters)

    with torch.no_grad():
        k_cache = torch.zeros((L, B, total, Hkv, hd), dtype=cdt, device=device)
        v_cache = torch.zeros_like(k_cache)
        toks = torch.zeros((B, total), dtype=torch.long, device=device)
        toks[:, :P] = prompt
        h_pf, pf_k, pf_v = gpt_prefill(params, cfg, prompt)
        k_cache[:, :, :P] = pf_k
        v_cache[:, :, :P] = pf_v
        h_last = norm_fn(h_pf[:, P - 1 : P], params["lnf_g"], params["lnf_b"])
        logits = _lm_head(h_last[:, 0], _head_weight(params, cfg))
        toks[:, P] = sample(logits, 0)
        for t in range(P, total - 1):
            logits, k_cache, v_cache = gpt_decode_step(
                params, cfg, toks[:, t],
                torch.full((B,), t, dtype=torch.long, device=device),
                k_cache, v_cache,
            )
            toks[:, t + 1] = sample(logits, t + 1 - P)
    return toks


def params_to(tree: Any, device: torch.device) -> Any:
    """``tree`` with every tensor on ``device`` (a no-op where it is)."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=device)


class GPTLM(TorchModule):
    """Language-model module over :func:`gpt_forward` (the JAX package's
    ``GPTLM``, ``gpt.py:2385``).

    Batches are ``(tokens,)`` or tokens, (B, S+1) int; the step trains on
    the shifted pair. ``batch_size`` is the rows of one batch on the one
    card (the JAX module's ``batch_size`` is per device).
    """

    def __init__(
        self,
        config: Optional[GPTConfig] = None,
        lr: float = 3e-4,
        warmup_steps: int = 20,
        batch_size: int = 8,
        n_train: int = 256,
        dataset: Optional[Dataset] = None,
        weight_decay: float = 0.01,
    ) -> None:
        super().__init__()
        if isinstance(config, dict):
            config = GPTConfig(**config)
        self.config = config or GPTConfig()
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.batch_size = batch_size
        self.n_train = n_train
        self._dataset = dataset
        self.weight_decay = weight_decay
        self._mesh: Any = None

    # -- strategy hooks --------------------------------------------------
    def bind_mesh(self, mesh: Any, seq_axis: Optional[str] = None) -> None:
        """Run the forward over ``mesh`` (``parallel/mesh.py``): the
        strategy's hook (JAX ``gpt.py:2418-2420``). Sequence parallelism,
        and seq, ep or pp axes larger than 1, raise."""
        if seq_axis is not None:
            raise NotImplementedError(
                "sequence parallelism is not ported yet (ROADMAP queue 1 "
                "item 13)")
        for axis in ("seq", "ep", "pp"):
            if mesh is not None and mesh.size(axis) > 1:
                raise NotImplementedError(
                    f"a {axis!r} mesh axis larger than 1 (sequence, expert "
                    "and pipeline parallelism) is not ported yet (ROADMAP "
                    "queue 1 item 13)")
        self._mesh = mesh

    def param_logical_axes(self) -> Dict[str, Any]:
        return gpt_logical_axes(self.config)

    # -- model -----------------------------------------------------------
    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        return init_gpt_params(generator, self.config)

    def _forward(self, params: Any, tokens: torch.Tensor) -> torch.Tensor:
        return gpt_forward(params, tokens, self.config, mesh=self._mesh)

    def _loss(self, params: Any, batch: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        toks = batch[0] if isinstance(batch, (tuple, list)) else batch
        toks = toks.long()
        if self.config.loss_chunk > 0:
            # Under a model axis the hidden state of the split forward is
            # whole on every rank; a vocab split makes the head
            # vocab-parallel, an odd vocab leaves the table whole.
            h = gpt_forward(params, toks[:, :-1], self.config,
                            mesh=self._mesh, return_hidden=True)
            w = _head_weight(params, self.config)
            tp = _model_group(self._mesh)
            return chunked_lm_loss(
                h, w, toks[:, 1:], self.config.loss_chunk,
                tp=tp if w.shape[0] != self.config.vocab_size else None,
            )
        return lm_loss(self._forward(params, toks[:, :-1]), toks[:, 1:])

    # -- steps -----------------------------------------------------------
    def training_step(self, params, batch, generator):
        loss, acc = self._loss(params, batch)
        return loss, {"loss": loss, "acc": acc}

    def validation_step(self, params, batch):
        loss, acc = self._loss(params, batch)
        return {"val_loss": loss, "val_accuracy": acc}

    def predict_step(self, params, batch):
        toks = batch[0] if isinstance(batch, (tuple, list)) else batch
        return self._forward(params, toks[:, :-1].long()).argmax(-1)

    def generate(
        self,
        prompt: Any,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> torch.Tensor:
        """KV-cached decode from the fitted params (:func:`gpt_generate`)
        on the device the params live on; greedy unless ``temperature >
        0``."""
        if self.params is None:
            raise RuntimeError("no parameters: fit first or set module.params")
        return gpt_generate(
            self.params, self.config, prompt, max_new_tokens,
            temperature=temperature, seed=seed, top_k=top_k,
            top_p=top_p, device=self.params["wte"].device,
        )

    def configure_optimizers(self):
        sched = warmup_cosine_decay_schedule(
            0.0, self.lr, self.warmup_steps, max(self.warmup_steps + 1, 10_000)
        )
        wd = self.weight_decay

        def adamw(leaves):
            # optax.adamw's math: one group, every leaf decayed, the decay
            # scaled by the scheduled lr (set by the loop before each
            # update), eps outside the square root.
            return torch.optim.AdamW(
                leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd
            )

        return {"optimizer": adamw, "lr_schedule": sched}

    # -- data ------------------------------------------------------------
    def _data(self) -> Dataset:
        if self._dataset is None:
            # Full max_seq-length sequences, so tokens per step are
            # batch * max_seq, as throughput numbers assume.
            self._dataset = make_fake_text(
                self.n_train,
                seq_len=self.config.max_seq,
                vocab=self.config.vocab_size,
            )
        return self._dataset

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self._data(), batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(
            make_fake_text(
                64,
                seq_len=self.config.max_seq,
                vocab=self.config.vocab_size,
                seed=7,
            ),
            batch_size=self.batch_size,
        )
