"""GPT in PyTorch: the training forward, losses and ``GPTLM``; prefill,
cached decode, sampling and generate.

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
- Randomness comes from explicit ``torch.Generator``s, not threefry keys:
  the same seed gives other draws than the JAX package, by design.
- Dense configs only: ``n_experts > 0`` raises (MoE is ROADMAP queue 1 item 13).
- ``remat`` recomputes each block in the backward through
  ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.trainer.data import ArrayDataset, DataLoader, Dataset
from ray_lightning_tpu_torch.trainer.module import TorchModule
from ray_lightning_tpu_torch.trainer.optim import warmup_cosine_decay_schedule
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.quantize import dequant, embed_rows

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
    at construction and the per-step ``dequant`` then passes it through."""
    cdt = compute_dtype(cfg)
    blocks = {
        k: (v.to(cdt) if k in _MATMUL_LEAVES else v)
        for k, v in params["blocks"].items()
    }
    out = {k: v for k, v in params.items() if k not in ("blocks", "lm_head")}
    out["blocks"] = blocks
    out["head_c"] = _head_weight(params, cfg)
    return out


def _layer(blocks: Dict[str, torch.Tensor], li: int) -> Dict[str, torch.Tensor]:
    return {k: v[li] for k, v in blocks.items()}


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
    cdt: torch.dtype,
) -> torch.Tensor:
    """The dense feed-forward on normed input (..., D): GPT-2 gelu (tanh
    approximation, as ``jax.nn.gelu``'s default) or SwiGLU with gate/up
    stacked in ``wi`` (D, 2, F)."""
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
    return torch.einsum("...f,fd->...d", h, dequant(lp["wo2"], cdt)) + lp[
        "bo2"
    ].to(cdt)


def _head_weight(params: Dict[str, Any], cfg: GPTConfig) -> torch.Tensor:
    """The (V, D) output table for :func:`_lm_head`: the tied embedding or
    ``lm_head``, rounded to the compute dtype and held in fp32 (the copy
    :func:`cast_params` made once, else made here per call)."""
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
    """
    from ray_lightning_tpu_torch.ops import attention_reference, flash_attention

    if mesh is not None or seq_axis is not None:
        raise NotImplementedError(
            "meshes and sequence parallelism are not ported yet (ROADMAP "
            "queue 1 items 11 and 13)"
        )
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
    x = embed_rows(params["wte"], tokens)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][:S]
    x = x.to(cdt)

    def block(h: torch.Tensor, lp: Dict[str, torch.Tensor]) -> torch.Tensor:
        a = norm_fn(h, lp["ln1_g"], lp["ln1_b"])
        q, k, v = _project_qkv(a, lp, cfg, cdt, rope_tables)  # (B,S,H,hd)
        o = attn_fn(
            q, k, v, causal=True, window=cfg.attn_window, sinks=cfg.attn_sinks
        )
        h = h + torch.einsum("bshk,hkd->bsd", o, dequant(lp["wo"], cdt)) + lp[
            "bo"
        ].to(cdt)
        m = norm_fn(h, lp["ln2_g"], lp["ln2_b"])
        return h + _dense_mlp(m, lp, cfg, cdt)

    for li in range(cfg.n_layer):
        lp = _layer(params["blocks"], li)
        if cfg.remat:
            x = checkpoint(block, x, lp, use_reentrant=False)
        else:
            x = block(x, lp)
    x = norm_fn(x, params["lnf_g"], params["lnf_b"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = x if return_hidden else _lm_head(x, _head_weight(params, cfg))
    return (out, aux) if return_aux else out


def lm_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross entropy + accuracy over all positions."""
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1).long()
    )
    acc = (logits.argmax(-1) == targets).float().mean()
    return ce, acc


def chunked_lm_loss(
    x: torch.Tensor, wte: Any, targets: torch.Tensor, chunk: int
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
        logits = _lm_head(x_c, wte_c)
        valid = t_c >= 0
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, t_c.clamp(min=0)[..., None].long())[..., 0]
        ce_sum = torch.where(valid, lse - tgt, 0.0).sum()
        hit = (logits.argmax(-1) == t_c) & valid
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


def sample_logits(
    logits: torch.Tensor,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample token ids from (B, V) logits with static knobs.

    ``temperature == 0`` is greedy argmax. top-k keeps the k highest
    logits; top-p (nucleus) keeps the smallest prefix of the sorted
    distribution whose mass reaches p (the crossing token included).
    Filters compose k first, then p, as in the JAX package.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / float(temperature)
    neg = float("-inf")
    V = logits.shape[-1]
    if top_k is not None and 0 < int(top_k) < V:
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if top_p is not None and 0.0 < float(top_p) < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        cutoff = torch.where(
            before < float(top_p), sorted_logits, float("inf")
        ).amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, neg)
    return _gumbel_argmax(logits, [generator] * logits.shape[0])


def _gumbel_argmax(
    logits: torch.Tensor, generators: Sequence[Optional[torch.Generator]]
) -> torch.Tensor:
    """Categorical draws from (B, V) logits by the Gumbel-max trick, each
    row's uniforms from its own generator (so a row's draw never depends
    on its batchmates)."""
    V = logits.shape[-1]
    u = torch.stack(
        [torch.rand(V, generator=g, device=logits.device) for g in generators]
    )
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + gumbel, dim=-1)


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
    generators: Sequence[Optional[torch.Generator]],
) -> torch.Tensor:
    """Per-row sampling with tensor knobs: the batched counterpart of
    :func:`sample_logits`. ``temps`` (B,) fp32 (<= 0 = greedy); ``top_ks``
    (B,) int (0 = off); ``top_ps`` (B,) fp32 (>= 1 = off).
    ``generators[b]`` draws row b's noise; rows whose generator is None
    are greedy, so the host knows which rows sample without reading the
    device. An all-greedy batch is a bare argmax."""
    greedy = torch.argmax(logits, dim=-1)
    rows = [b for b, g in enumerate(generators) if g is not None]
    if not rows:
        return greedy
    idx = torch.tensor(rows, device=logits.device)
    lg = filter_logits_batched(
        logits[idx], temps[idx], top_ks[idx], top_ps[idx]
    )
    sampled = _gumbel_argmax(lg, [generators[b] for b in rows])
    out = greedy.clone()
    out[idx] = torch.where(temps[idx] <= 0.0, greedy[idx], sampled)
    return out


def gpt_prefill(
    params: Dict[str, Any],
    cfg: GPTConfig,
    prompt: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One parallel forward over ``prompt`` (B, P) that yields the decode
    cache: returns pre-final-norm hidden states (B, P, D) and the stacked
    K/V (L, B, P, Hkv, hd) in the compute dtype.

    Attention is causal (band-limited by ``attn_window``/``attn_sinks``),
    so row ``i`` depends only on ``prompt[:, :i+1]``: callers may
    right-pad prompts to a bucket length and read row ``true_len - 1``.
    With ``attn_impl="flash"`` each layer's attention is one flash call.
    """
    from ray_lightning_tpu_torch.ops import attention_reference, flash_attention

    cfg.validate_variants()
    cdt = compute_dtype(cfg)
    norm_fn = _make_norm(cfg)
    H, hd = cfg.n_head, cfg.head_dim
    Hkv = cfg.kv_head
    rep = H // Hkv
    _, P = prompt.shape
    attn_fn = (
        flash_attention if cfg.attn_impl == "flash" else attention_reference
    )
    pf_tables = (
        _rope_tables(torch.arange(P, device=prompt.device), cfg.rope_theta, hd)
        if cfg.pos_embed == "rope"
        else None
    )
    h = embed_rows(params["wte"], prompt)
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
        o = attn_fn(
            q, k_att, v_att, causal=True, window=cfg.attn_window,
            sinks=cfg.attn_sinks,
        )
        h = h + torch.einsum("bshk,hkd->bsd", o, dequant(lp["wo"], cdt)) + lp[
            "bo"
        ].to(cdt)
        m = norm_fn(h, lp["ln2_g"], lp["ln2_b"])
        h = h + _dense_mlp(m, lp, cfg, cdt)
        ks.append(k_kv.to(cdt))
        vs.append(v_kv.to(cdt))
    return h, torch.stack(ks), torch.stack(vs)


def gpt_decode_step(
    params: Dict[str, Any],
    cfg: GPTConfig,
    cur: torch.Tensor,
    pos: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
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
    """
    from ray_lightning_tpu_torch.ops.attention import band_allowed

    cfg.validate_variants()
    cdt = compute_dtype(cfg)
    norm_fn = _make_norm(cfg)
    H, hd = cfg.n_head, cfg.head_dim
    Hkv = cfg.kv_head
    rep = H // Hkv
    B = cur.shape[0]
    S = k_cache.shape[2]
    pos_w = pos.clamp(max=S - 1)
    slots = torch.arange(B, device=cur.device)

    x = embed_rows(params["wte"], cur)
    if cfg.pos_embed == "learned":
        x = x + params["wpe"][pos.clamp(max=cfg.max_seq - 1)]
    h = x.to(cdt)  # (B, D)
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
        a = norm_fn(h[:, None], lp["ln1_g"], lp["ln1_b"])[:, 0]
        if Hkv == H:
            qkv = torch.einsum(
                "bd,dthk->bthk", a, dequant(lp["wqkv"], cdt)
            ) + lp["bqkv"].to(cdt)
            q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        else:
            q = torch.einsum("bd,dhk->bhk", a, dequant(lp["wq"], cdt)) + lp[
                "bq"
            ].to(cdt)
            kv = torch.einsum(
                "bd,dthk->bthk", a, dequant(lp["wkv"], cdt)
            ) + lp["bkv"].to(cdt)
            k_new, v_new = kv[:, 0], kv[:, 1]
        if cfg.pos_embed == "rope":
            q = _rotate(q, cos, sin)
            k_new = _rotate(k_new, cos, sin)
        # In place: one cache in memory, each slot's row at its position.
        kc, vc = k_cache[li], v_cache[li]
        kc[slots, pos_w] = k_new.to(kc.dtype)
        vc[slots, pos_w] = v_new.to(vc.dtype)
        # Grouped attention against the Hkv-headed cache: head h reads kv
        # head h // rep, matching the prefill's repeat_interleave.
        qg = q.reshape(B, Hkv, rep, hd).float()
        s = torch.einsum("bgrk,bsgk->bgrs", qg * (1.0 / np.sqrt(hd)), kc.float())
        s = s.masked_fill(~allowed, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bgrs,bsgk->bgrk", p, vc.float()).reshape(B, H, hd)
        o = o.to(cdt)
        h = h + torch.einsum("bhk,hkd->bd", o, dequant(lp["wo"], cdt)) + lp[
            "bo"
        ].to(cdt)
        m = norm_fn(h[:, None], lp["ln2_g"], lp["ln2_b"])[:, 0]
        h = h + _dense_mlp(m, lp, cfg, cdt)
    h = norm_fn(h[:, None], params["lnf_g"], params["lnf_b"])[:, 0]
    logits = _lm_head(h, _head_weight(params, cfg))
    return logits, k_cache, v_cache


def gpt_decode_fold(
    params: Dict[str, Any],
    cfg: GPTConfig,
    cur: torch.Tensor,
    pos: torch.Tensor,
    generators: Sequence[Optional[torch.Generator]],
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
) -> Tuple[torch.Tensor, ...]:
    """``fold`` decode+sample iterations with per-slot termination on the
    device: the serving engine's hot loop.

    Each iteration decodes every slot, samples, and advances only the
    active slots; a slot whose sampled token equals its eos (``eos_toks``
    -1 = off) or whose ``remaining`` budget hits zero freezes mid-fold, so
    no post-EOS token is emitted. The host reads nothing until the fold
    ends. ``generators[b]`` (None = greedy) draws once per iteration for
    its slot: while the slot is active that is once per emitted token,
    and after it froze the draws are never used.

    Returns ``(tok_block (fold, B) int with -1 at non-emitted lanes,
    emit_block (fold, B) bool, cur, pos, active, remaining, k_cache,
    v_cache)``.
    """
    toks_out, emits_out = [], []
    for _ in range(int(fold)):
        logits, k_cache, v_cache = gpt_decode_step(
            params, cfg, cur, pos, k_cache, v_cache
        )
        toks = sample_logits_batched(logits, temps, top_ks, top_ps, generators)
        toks = toks.to(cur.dtype)
        emit = active
        toks_out.append(torch.where(emit, toks, -1))
        emits_out.append(emit)
        cur = torch.where(active, toks, cur)
        pos = torch.where(active, pos + 1, pos)
        remaining = torch.where(active, remaining - 1, remaining)
        active = active & (remaining > 0) & (toks != eos_toks)
    return (
        torch.stack(toks_out), torch.stack(emits_out), cur, pos, active,
        remaining, k_cache, v_cache,
    )


def gpt_generate(
    params: Dict[str, Any],
    cfg: GPTConfig,
    prompt: Any,
    max_new_tokens: int,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    device: Any = "cuda",
) -> torch.Tensor:
    """Autoregressive decode with a KV cache: prompt (B, P) -> (B, P +
    max_new_tokens) on ``device``.

    A prefill (one parallel forward over the prompt fills the (L, B,
    P + new, Hkv, hd) cache and samples the first new token), then one
    cached decode step per further token. Greedy when ``temperature ==
    0``; otherwise sampling from ``generator`` with optional top-k / top-p.
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
    if temperature > 0.0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
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
        toks[:, P] = sample_logits(logits, temperature, top_k, top_p, generator)
        for t in range(P, total - 1):
            logits, k_cache, v_cache = gpt_decode_step(
                params, cfg, toks[:, t],
                torch.full((B,), t, dtype=torch.long, device=device),
                k_cache, v_cache,
            )
            toks[:, t + 1] = sample_logits(
                logits, temperature, top_k, top_p, generator
            )
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

    # -- model -----------------------------------------------------------
    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        return init_gpt_params(generator, self.config)

    def _forward(self, params: Any, tokens: torch.Tensor) -> torch.Tensor:
        return gpt_forward(params, tokens, self.config)

    def _loss(self, params: Any, batch: Any) -> Tuple[torch.Tensor, torch.Tensor]:
        toks = batch[0] if isinstance(batch, (tuple, list)) else batch
        toks = toks.long()
        if self.config.loss_chunk > 0:
            h = gpt_forward(params, toks[:, :-1], self.config, return_hidden=True)
            return chunked_lm_loss(
                h, _head_weight(params, self.config), toks[:, 1:],
                self.config.loss_chunk,
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
        generator: Optional[torch.Generator] = None,
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
            temperature=temperature, generator=generator, top_k=top_k,
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
