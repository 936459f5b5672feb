"""BERT-style bidirectional encoder with masked-LM pretraining: the port of
``ray_lightning_tpu/models/bert.py``.

The non-causal counterpart of the GPT family: the same stacked per-layer
leaves (a leading ``layers`` dim, so the weight bridge is a copy), the same
logical axes, the same flash attention, run with ``causal=False`` (every
position attends to every position), and a masked-LM objective.

Differences that follow from PyTorch:

- Layers run in a Python loop over the stacked leaves; ``remat``
  recomputes each block in the backward through ``torch.utils.checkpoint``.
- Dynamic BERT masking (80/10/10) draws from the training step's
  ``torch.Generator`` on the device, so a CUDA graph of the step draws new
  masks at every replay (the step's generator is reseeded per step and
  registered with the graph). The draws are not JAX's threefry draws:
  parity with the JAX package is held on (inputs, targets) made outside,
  and the masking on its contract.
- Validation masks with a generator seeded 0 on every call (the JAX
  package uses a fixed ``PRNGKey(0)``), so ``val_loss`` is comparable
  across epochs but not with the JAX package's.
- Over a mesh's ``"model"`` axis each block splits Megatron-style, as
  :func:`~ray_lightning_tpu_torch.models.gpt.gpt_forward` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_lightning_tpu_torch.models.gpt import (
    _embed_tokens,
    _layer,
    _layernorm,
    _lm_head,
    _model_group,
    chunked_lm_loss,
    compute_dtype,
    make_fake_text,
)
from ray_lightning_tpu_torch.parallel.tp import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
)
from ray_lightning_tpu_torch.trainer.data import DataLoader, Dataset
from ray_lightning_tpu_torch.trainer.module import TorchModule
from ray_lightning_tpu_torch.trainer.optim import warmup_cosine_decay_schedule


@dataclass(frozen=True)
class BERTConfig:
    """Same field names and defaults as the JAX package's ``BERTConfig``."""

    vocab_size: int = 256
    n_layer: int = 2
    n_head: int = 4
    d_model: int = 128
    d_ff: int = 0  # 0 -> 4 * d_model
    max_seq: int = 128
    compute_dtype: str = "float32"  # "bfloat16" for GPU runs
    remat: bool = False
    attn_impl: str = "flash"  # "flash" | "reference"
    # Masked-LM objective: fraction of positions selected per sequence,
    # split 80% [MASK] / 10% random token / 10% kept (BERT's recipe).
    mask_prob: float = 0.15
    # [MASK] id; the default reserves the last vocab row.
    mask_token_id: int = -1
    # S-chunk size for the fused MLM head + CE (see GPTConfig.loss_chunk).
    loss_chunk: int = 0
    init_std: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def mask_id(self) -> int:
        return self.mask_token_id if self.mask_token_id >= 0 else self.vocab_size - 1


def bert_param_shapes(cfg: BERTConfig) -> Dict[str, Any]:
    """The parameter tree's shapes (JAX ``bert.py:72-109``)."""
    L, D, H, hd, F_ = (
        cfg.n_layer, cfg.d_model, cfg.n_head, cfg.head_dim, cfg.ff_dim,
    )
    return {
        "wte": (cfg.vocab_size, D),
        "wpe": (cfg.max_seq, D),
        "blocks": {
            "ln1_g": (L, D),
            "ln1_b": (L, D),
            "wqkv": (L, D, 3, H, hd),
            "bqkv": (L, 3, H, hd),
            "wo": (L, H, hd, D),
            "bo": (L, D),
            "ln2_g": (L, D),
            "ln2_b": (L, D),
            "wi": (L, D, F_),
            "bi": (L, F_),
            "wo2": (L, F_, D),
            "bo2": (L, D),
        },
        "lnf_g": (D,),
        "lnf_b": (D,),
        # MLM transform before the tied decoder (BERT's extra dense+LN).
        "mlm_w": (D, D),
        "mlm_b": (D,),
        "mlm_ln_g": (D,),
        "mlm_ln_b": (D,),
    }


def init_bert_params(generator: torch.Generator, cfg: BERTConfig) -> Dict[str, Any]:
    """Parameter tree with stacked per-layer leaves (leading dim L), fp32,
    drawn from ``generator`` on its device: normal(0, init_std) weights,
    the two residual projections scaled by 1/sqrt(2L), zero biases, unit
    norm gains (the JAX package's distributions; other draws)."""
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
        k: ({n: leaf(n, s) for n, s in v.items()} if isinstance(v, dict)
            else leaf(k, v))
        for k, v in bert_param_shapes(cfg).items()
    }


#: Logical axes of one encoder block's stacked leaves, shared with ViT
#: (``models/vit.py``): heads and MLP columns over "model", embed over
#: "fsdp" (the GPT family's rules).
ENCODER_BLOCK_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "ln1_g": ("layers", None),
    "ln1_b": ("layers", None),
    "wqkv": ("layers", "embed", None, "heads", "kv"),
    "bqkv": ("layers", None, "heads", "kv"),
    "wo": ("layers", "heads", "kv", "embed"),
    "bo": ("layers", None),
    "ln2_g": ("layers", None),
    "ln2_b": ("layers", None),
    "wi": ("layers", "embed", "mlp"),
    "bi": ("layers", "mlp"),
    "wo2": ("layers", "mlp", "embed"),
    "bo2": ("layers", None),
}


def bert_logical_axes(cfg: BERTConfig) -> Dict[str, Any]:
    """Logical axis names per parameter (same rule set as the GPT family:
    embed->fsdp, heads/mlp/vocab->model)."""
    return {
        "wte": ("vocab", "embed"),
        "wpe": (None, "embed"),
        "blocks": dict(ENCODER_BLOCK_AXES),
        "lnf_g": (None,),
        "lnf_b": (None,),
        "mlm_w": ("embed", None),
        "mlm_b": (None,),
        "mlm_ln_g": (None,),
        "mlm_ln_b": (None,),
    }


def attention_fn(attn_impl: str) -> Callable:
    """``attend(q, k, v)``: non-causal flash attention or the reference."""
    from ray_lightning_tpu_torch.ops import attention_reference, flash_attention

    if attn_impl == "reference":
        return lambda q, k, v: attention_reference(q, k, v, causal=False)
    return lambda q, k, v: flash_attention(q, k, v, causal=False)


def encoder_block(
    h: torch.Tensor,
    lp: Dict[str, torch.Tensor],
    attend: Callable,
    cdt: torch.dtype,
    tps: Tuple[Any, Any] = (None, None),
) -> torch.Tensor:
    """One pre-LN encoder block on (B, S, D): fused-qkv attention through
    ``attend``, then the gelu (tanh approximation, ``jax.nn.gelu``'s
    default) MLP. ``tps`` holds the model group of each half whose leaves
    are this rank's slice (H/m heads, F/m MLP columns; :func:`block_groups`)
    or None: a split half's partial output is summed over the group and
    its bias added after the sum, once."""
    tp_attn, tp_mlp = tps
    a = copy_to_model(_layernorm(h, lp["ln1_g"], lp["ln1_b"]), tp_attn)
    qkv = torch.einsum("bsd,dthk->bsthk", a, lp["wqkv"].to(cdt)) + lp[
        "bqkv"
    ].to(cdt)
    o = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    o = torch.einsum("bshk,hkd->bsd", o, lp["wo"].to(cdt))
    h = h + reduce_from_model(o, tp_attn) + lp["bo"].to(cdt)
    m = copy_to_model(_layernorm(h, lp["ln2_g"], lp["ln2_b"]), tp_mlp)
    m = F.gelu(
        torch.einsum("bsd,df->bsf", m, lp["wi"].to(cdt)) + lp["bi"].to(cdt),
        approximate="tanh",
    )
    m = torch.einsum("bsf,fd->bsd", m, lp["wo2"].to(cdt))
    return h + (reduce_from_model(m, tp_mlp) + lp["bo2"].to(cdt))


def block_groups(mesh: Any, blocks: Dict[str, Any], n_head: int,
                 ff_dim: int) -> Tuple[Any, Any]:
    """(attention's, MLP's) model group for :func:`encoder_block`: the
    mesh's ``"model"`` group for a half whose stacked leaves hold this
    rank's slice, None for a whole one (the rules split heads and MLP
    columns only where the model extent divides them)."""
    tp = _model_group(mesh)
    if tp is None:
        return None, None
    return (tp if blocks["wo"].shape[1] != n_head else None,
            tp if blocks["wo2"].shape[1] != ff_dim else None)


def run_blocks(x: torch.Tensor, blocks: Dict[str, Any], n_layer: int,
               attend: Callable, cdt: torch.dtype,
               tps: Tuple[Any, Any] = (None, None),
               remat: bool = False) -> torch.Tensor:
    """The stacked encoder blocks over ``x``, each recomputed in the
    backward under ``remat``."""
    for li in range(n_layer):
        if remat:
            # Read (under ZeRO-3: gathered) inside the recomputed block.
            x = checkpoint(
                lambda h, li=li: encoder_block(h, _layer(blocks, li), attend,
                                               cdt, tps),
                x, use_reentrant=False)
        else:
            x = encoder_block(x, _layer(blocks, li), attend, cdt, tps)
    return x


def bert_forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: BERTConfig,
    return_hidden: bool = False,
    mesh: Any = None,
) -> torch.Tensor:
    """tokens (B, S) int -> fp32 MLM logits (B, S, V) (JAX ``bert.py:140``).

    Bidirectional: every layer's attention is one ``flash_attention(...,
    causal=False)`` call (``attn_impl="flash"``), or the reference.
    ``return_hidden`` returns the post-MLM-transform hidden states (B, S,
    D) for :func:`chunked_lm_loss`. ``mesh`` splits the blocks over its
    ``"model"`` axis where ``params`` holds this rank's slices (the specs of
    :func:`bert_logical_axes`); a vocab split makes the embedding a masked
    lookup summed over the group and the logits a gather.
    """
    cdt = compute_dtype(cfg)
    tp = _model_group(mesh)
    S = tokens.shape[1]
    tokens = tokens.long()
    x = (_embed_tokens(params["wte"], tokens, cfg, tp) + params["wpe"][:S]).to(cdt)
    tps = block_groups(mesh, params["blocks"], cfg.n_head, cfg.ff_dim)
    x = run_blocks(x, params["blocks"], cfg.n_layer, attention_fn(cfg.attn_impl),
                   cdt, tps, cfg.remat)
    x = _layernorm(x, params["lnf_g"], params["lnf_b"])
    # MLM transform: dense + gelu + LN, then the tied decoder.
    x = F.gelu(
        torch.einsum("bsd,de->bse", x, params["mlm_w"].to(cdt))
        + params["mlm_b"].to(cdt),
        approximate="tanh",
    )
    x = _layernorm(x, params["mlm_ln_g"], params["mlm_ln_b"])
    if return_hidden:
        return x
    # The table as the JAX head reads it: rounded to the compute dtype,
    # products and sums in fp32.
    w = params["wte"].to(cdt).float()
    if tp is None or w.shape[0] == cfg.vocab_size:
        return _lm_head(x, w)
    return gather_from_model(_lm_head(copy_to_model(x, tp), w), -1, tp)


def apply_mlm_masking(
    generator: torch.Generator, tokens: torch.Tensor, cfg: BERTConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BERT dynamic masking: (inputs, targets) from clean tokens.

    ``mask_prob`` of positions are selected; of those 80% become
    ``[MASK]``, 10% a uniform random token, 10% stay. Targets carry the
    ORIGINAL id at selected positions and -1 (ignore) elsewhere, the
    contract :func:`chunked_lm_loss` averages over. The draws come from
    ``generator`` on its device (the tokens' device) and read nothing back
    to the host, so the masking runs inside a captured training step.
    """
    shape, dev = tokens.shape, tokens.device
    sel = torch.rand(shape, generator=generator, device=dev) < cfg.mask_prob
    u = torch.rand(shape, generator=generator, device=dev)
    # The 10% branch replaces with a REAL vocabulary token: draw from the
    # vocab minus [MASK] by sampling vocab_size-1 values and shifting the
    # ones at/above mask_id up by one.
    rand_toks = torch.randint(0, cfg.vocab_size - 1, shape, generator=generator,
                              device=dev, dtype=tokens.dtype)
    rand_toks = rand_toks + (rand_toks >= cfg.mask_id).to(tokens.dtype)
    masked = torch.where(
        u < 0.8,
        torch.full_like(tokens, cfg.mask_id),
        torch.where(u < 0.9, rand_toks, tokens),
    )
    inputs = torch.where(sel, masked, tokens)
    targets = torch.where(sel, tokens, torch.full_like(tokens, -1))
    return inputs, targets


def masked_lm_loss(
    logits: torch.Tensor, targets: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE + accuracy over positions with ``targets >= 0`` (dense
    counterpart of the chunked path)."""
    valid = targets >= 0
    ce = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).float(),
        targets.clamp(min=0).reshape(-1).long(),
        reduction="none",
    ).reshape(targets.shape)
    n = torch.clamp(valid.float().sum(), min=1.0)
    loss = torch.where(valid, ce, 0.0).sum() / n
    hit = (logits.argmax(-1) == targets) & valid
    return loss, hit.float().sum() / n


class BERTEncoder(TorchModule):
    """Masked-LM pretraining module over the synthetic token corpus (the
    JAX package's ``BERTEncoder``).

    The affine-recurrence corpus (:func:`make_fake_text`) suits MLM: a
    masked token is recoverable from either neighbor, so the loss drops far
    below ln(V) once the encoder uses both directions. ``batch_size`` is
    the rows of one batch on the one card.
    """

    def __init__(
        self,
        config: Optional[BERTConfig | Dict[str, Any]] = None,
        lr: float = 3e-4,
        warmup_steps: int = 20,
        batch_size: int = 8,
        n_train: int = 256,
        dataset: Optional[Dataset] = None,
        weight_decay: float = 0.01,
    ) -> None:
        super().__init__()
        if isinstance(config, dict):
            config = BERTConfig(**config)
        self.config = config or BERTConfig()
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.batch_size = batch_size
        self.n_train = n_train
        self._dataset = dataset
        self.weight_decay = weight_decay
        self._mesh: Any = None

    # -- strategy hooks --------------------------------------------------
    def bind_mesh(self, mesh: Any, seq_axis: Optional[str] = None) -> None:
        """Run the forward over ``mesh``'s ``"model"`` axis (the
        strategy's hook). Sequence parallelism raises."""
        if seq_axis is not None:
            raise NotImplementedError(
                "sequence parallelism is not ported yet (ROADMAP queue 1 "
                "item 13)")
        self._mesh = mesh

    def param_logical_axes(self) -> Dict[str, Any]:
        return bert_logical_axes(self.config)

    # -- model -----------------------------------------------------------
    def init_params(self, generator: torch.Generator, batch: Any) -> Any:
        return init_bert_params(generator, self.config)

    def _loss(self, params: Any, batch: Any, generator: torch.Generator) -> Any:
        toks = batch[0] if isinstance(batch, (tuple, list)) else batch
        toks = toks[:, : self.config.max_seq].long()
        inputs, targets = apply_mlm_masking(generator, toks, self.config)
        if self.config.loss_chunk > 0:
            hidden = bert_forward(params, inputs, self.config,
                                  return_hidden=True, mesh=self._mesh)
            wte = params["wte"]
            tp = _model_group(self._mesh)
            return chunked_lm_loss(
                hidden, wte, targets, self.config.loss_chunk,
                tp=tp if wte.shape[0] != self.config.vocab_size else None,
            )
        logits = bert_forward(params, inputs, self.config, mesh=self._mesh)
        return masked_lm_loss(logits, targets)

    def training_step(self, params, batch, generator):
        loss, acc = self._loss(params, batch, generator)
        return loss, {"loss": loss, "mlm_acc": acc}

    def validation_step(self, params, batch):
        # Deterministic eval masking: a generator seeded 0, so val_loss is
        # comparable across epochs (train re-masks every step).
        toks = batch[0] if isinstance(batch, (tuple, list)) else batch
        generator = torch.Generator(device=toks.device).manual_seed(0)
        loss, acc = self._loss(params, batch, generator)
        return {"val_loss": loss, "val_accuracy": acc}

    def configure_optimizers(self):
        sched = warmup_cosine_decay_schedule(
            0.0, self.lr, self.warmup_steps, max(self.warmup_steps + 1, 10_000)
        )
        wd = self.weight_decay

        def adamw(leaves):
            # optax.adamw's math (see GPTLM.configure_optimizers).
            return torch.optim.AdamW(
                leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd
            )

        return {"optimizer": adamw, "lr_schedule": sched}

    @torch.no_grad()
    def fill_mask(self, tokens: Any) -> torch.Tensor:
        """Argmax prediction at every ``[MASK]`` position; all other
        positions pass through unchanged. tokens (B, S) int with
        ``mask_id`` at the positions to fill; runs on the device the
        params live on."""
        if self.params is None:
            raise RuntimeError("no parameters: fit first or set module.params")
        device = self.params["wte"].device
        toks = torch.as_tensor(np.asarray(tokens), device=device).long()
        logits = bert_forward(self.params, toks, self.config, mesh=self._mesh)
        # Never "fill" with [MASK] itself: its wte row has a logit too,
        # and an undertrained model may rank it first.
        logits[..., self.config.mask_id] = float("-inf")
        return torch.where(toks == self.config.mask_id, logits.argmax(-1), toks)

    # -- data ------------------------------------------------------------
    def _data(self) -> Dataset:
        if self._dataset is None:
            # Reserve the [MASK] row: corpus tokens stay below mask_id.
            self._dataset = make_fake_text(
                self.n_train,
                seq_len=self.config.max_seq - 1,
                vocab=self.config.mask_id,
            )
        return self._dataset

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self._data(), batch_size=self.batch_size, shuffle=True)

    def val_dataloader(self) -> DataLoader:
        # Held-out corpus (same recurrence, different seed — the GPTLM
        # convention) so val_loss carries a generalization signal.
        return DataLoader(
            make_fake_text(
                64,
                seq_len=self.config.max_seq - 1,
                vocab=self.config.mask_id,
                seed=7,
            ),
            batch_size=self.batch_size,
        )
