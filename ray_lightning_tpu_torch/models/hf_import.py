"""Import Hugging Face GPT-2 and Llama weights into the port's GPT family:
the port of ``ray_lightning_tpu/models/hf_import.py``.

``load_hf_gpt2`` / ``load_hf_llama`` map a ``transformers`` model
(instance or local checkpoint path) onto
:func:`~ray_lightning_tpu_torch.models.gpt.gpt_forward`'s parameter tree:
stacked per-layer leaves (a leading ``layers`` dim) instead of per-module
tensors, on an explicit ``device``. Each returns ``(params, GPTConfig)``.
``transformers`` is imported only inside the functions that need it, never
when this module is imported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.models.weights import params_from_jax


def _check_overrides(arch: Dict[str, Any], overrides: Dict[str, Any]) -> None:
    """Reject overrides of checkpoint-defined fields. Single source for
    every family loader: shape fields (whatever ``arch`` pins) plus the
    structure/numerics fields that would change the param layout or the
    math the checkpoint was trained with."""
    locked = set(arch) | {
        "n_kv_head",
        "n_experts",
        "norm_impl",
        "norm_eps",
        "mlp_variant",
        "tie_word_embeddings",
    }
    clash = set(overrides) & locked
    if clash:
        raise ValueError(
            f"architecture fields {sorted(clash)} are defined by the HF "
            "checkpoint and cannot be overridden"
        )


def _state_dict(model: Any) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


def load_hf_gpt2(
    model_or_path: Any, device: Union[str, torch.device] = "cuda",
    **cfg_overrides: Any,
) -> Tuple[Dict[str, Any], GPTConfig]:
    """HF GPT-2 -> (params tree on ``device``, GPTConfig).

    Args:
      model_or_path: a ``transformers`` ``GPT2LMHeadModel``/``GPT2Model``
        instance, or a local checkpoint path for ``from_pretrained``.
      device: where the tree goes (``"cpu"`` to stay on the host).
      cfg_overrides: GPTConfig fields to override (e.g. ``attn_impl``,
        ``compute_dtype``). Architecture fields (sizes, head counts) come
        from the HF config and cannot be overridden.

    Returns params for ``gpt_forward``/``GPTLM`` and the matching
    :class:`GPTConfig` (learned positions, tied head, gelu-tanh: GPT-2's
    architecture).
    """
    model = _resolve_model(model_or_path)
    sd = _state_dict(model)
    # Both GPT2Model ("wte.weight") and GPT2LMHeadModel ("transformer.wte
    # .weight") layouts.
    prefix = "transformer." if any(k.startswith("transformer.") for k in sd) else ""

    def t(name: str) -> np.ndarray:
        return sd[prefix + name]

    hf_cfg = model.config
    # The port's forward hardcodes GPT-2's defaults (gelu-tanh, LN eps
    # 1e-5, 1/sqrt(hd) scaling). Non-default family variants would convert
    # silently with WRONG numerics — fail fast instead.
    unsupported = {
        "activation_function": (
            getattr(hf_cfg, "activation_function", "gelu_new"),
            ("gelu_new",),
        ),
        "layer_norm_epsilon": (
            float(getattr(hf_cfg, "layer_norm_epsilon", 1e-5)),
            (1e-5,),
        ),
        "scale_attn_by_inverse_layer_idx": (
            bool(getattr(hf_cfg, "scale_attn_by_inverse_layer_idx", False)),
            (False,),
        ),
        "reorder_and_upcast_attn": (
            bool(getattr(hf_cfg, "reorder_and_upcast_attn", False)),
            (False,),
        ),
    }
    bad = {
        k: got for k, (got, ok) in unsupported.items() if got not in ok
    }
    if bad:
        raise ValueError(
            f"HF config options {bad} are not supported by the native "
            "GPT forward (it implements stock GPT-2: gelu_new, LN eps "
            "1e-5, 1/sqrt(head_dim) attention scaling)"
        )
    L, D = hf_cfg.n_layer, hf_cfg.n_embd
    H = hf_cfg.n_head
    hd = D // H
    F_ = t("h.0.mlp.c_fc.weight").shape[1]

    arch = dict(
        vocab_size=hf_cfg.vocab_size,
        n_layer=L,
        n_head=H,
        d_model=D,
        d_ff=F_,
        max_seq=hf_cfg.n_positions,
        pos_embed="learned",
    )
    _check_overrides(arch, cfg_overrides)
    cfg = GPTConfig(**arch, **cfg_overrides)

    def stack(name: str, reshape=None) -> np.ndarray:
        out = np.stack([t(f"h.{i}.{name}") for i in range(L)])
        return out.reshape((L,) + reshape) if reshape else out

    params: Dict[str, Any] = {
        "wte": t("wte.weight"),
        "wpe": t("wpe.weight"),
        "blocks": {
            "ln1_g": stack("ln_1.weight"),
            "ln1_b": stack("ln_1.bias"),
            # HF Conv1D stores (in, out); c_attn's out dim is [q|k|v] each
            # D wide with heads-major, head_dim-minor layout.
            "wqkv": stack("attn.c_attn.weight", (D, 3, H, hd)),
            "bqkv": stack("attn.c_attn.bias", (3, H, hd)),
            "wo": stack("attn.c_proj.weight", (H, hd, D)),
            "bo": stack("attn.c_proj.bias"),
            "ln2_g": stack("ln_2.weight"),
            "ln2_b": stack("ln_2.bias"),
            "wi": stack("mlp.c_fc.weight"),
            "bi": stack("mlp.c_fc.bias"),
            "wo2": stack("mlp.c_proj.weight"),
            "bo2": stack("mlp.c_proj.bias"),
        },
        "lnf_g": t("ln_f.weight"),
        "lnf_b": t("ln_f.bias"),
    }
    # On ``device``, every leaf's name and shape checked against cfg.
    return params_from_jax(params, cfg, device), cfg


def load_hf_llama(
    model_or_path: Any, device: Union[str, torch.device] = "cuda",
    **cfg_overrides: Any,
) -> Tuple[Dict[str, Any], GPTConfig]:
    """HF Llama -> (params tree on ``device``, GPTConfig).

    Maps a ``transformers`` ``LlamaForCausalLM`` (instance or local
    checkpoint path) onto the port's decoder: RoPE (the half-split
    rotation is HF Llama's ``rotate_half``), RMSNorm, SwiGLU ([gate|up]
    packed into ``wi``), GQA when ``num_key_value_heads <
    num_attention_heads``, untied ``lm_head`` unless the checkpoint ties.
    """
    model = _resolve_model(model_or_path, family="llama")
    sd = _state_dict(model)
    prefix = "model." if any(k.startswith("model.") for k in sd) else ""

    def t(name: str) -> np.ndarray:
        return sd[prefix + name]

    hf_cfg = model.config
    # Fail fast on family variants the port's forward does not implement:
    # a silent convert would run with wrong numerics.
    unsupported = {
        "hidden_act": (getattr(hf_cfg, "hidden_act", "silu"), ("silu",)),
        "rope_scaling": (getattr(hf_cfg, "rope_scaling", None), (None,)),
        "attention_bias": (
            bool(getattr(hf_cfg, "attention_bias", False)),
            (False,),
        ),
        "mlp_bias": (bool(getattr(hf_cfg, "mlp_bias", False)), (False,)),
    }
    bad = {k: got for k, (got, ok) in unsupported.items() if got not in ok}
    if bad:
        raise ValueError(
            f"HF Llama config options {bad} are not supported by the "
            "native decoder (it implements stock Llama: silu SwiGLU, "
            "unscaled RoPE, bias-free projections)"
        )
    L, D = hf_cfg.num_hidden_layers, hf_cfg.hidden_size
    H = hf_cfg.num_attention_heads
    Hkv = getattr(hf_cfg, "num_key_value_heads", H) or H
    hd = D // H
    F_ = hf_cfg.intermediate_size
    tied = bool(getattr(hf_cfg, "tie_word_embeddings", False))

    arch = dict(
        vocab_size=hf_cfg.vocab_size,
        n_layer=L,
        n_head=H,
        d_model=D,
        d_ff=F_,
        max_seq=hf_cfg.max_position_embeddings,
        pos_embed="rope",
        rope_theta=float(getattr(hf_cfg, "rope_theta", 10000.0)),
        norm_impl="rmsnorm",
        norm_eps=float(getattr(hf_cfg, "rms_norm_eps", 1e-5)),
        mlp_variant="swiglu",
        tie_word_embeddings=tied,
    )
    if Hkv != H:
        arch["n_kv_head"] = Hkv
    _check_overrides(arch, cfg_overrides)
    cfg = GPTConfig(**arch, **cfg_overrides)

    def lin(name: str, i: int) -> np.ndarray:
        # torch Linear stores (out, in); the port's einsums consume (in, out).
        return sd[f"{prefix}layers.{i}.{name}.weight"].T

    def stack(fn) -> np.ndarray:
        return np.stack([fn(i) for i in range(L)])

    zeros = np.zeros
    if Hkv == H:
        attn = {
            "wqkv": stack(
                lambda i: np.stack(
                    [
                        lin("self_attn.q_proj", i).reshape(D, H, hd),
                        lin("self_attn.k_proj", i).reshape(D, H, hd),
                        lin("self_attn.v_proj", i).reshape(D, H, hd),
                    ],
                    axis=1,
                )
            ),
            "bqkv": zeros((L, 3, H, hd), np.float32),
        }
    else:
        attn = {
            "wq": stack(lambda i: lin("self_attn.q_proj", i).reshape(D, H, hd)),
            "bq": zeros((L, H, hd), np.float32),
            "wkv": stack(
                lambda i: np.stack(
                    [
                        lin("self_attn.k_proj", i).reshape(D, Hkv, hd),
                        lin("self_attn.v_proj", i).reshape(D, Hkv, hd),
                    ],
                    axis=1,
                )
            ),
            "bkv": zeros((L, 2, Hkv, hd), np.float32),
        }
    params: Dict[str, Any] = {
        "wte": t("embed_tokens.weight"),
        "blocks": {
            "ln1_g": stack(lambda i: t(f"layers.{i}.input_layernorm.weight")),
            "ln1_b": zeros((L, D), np.float32),  # rmsnorm: unused
            **attn,
            "wo": stack(lambda i: lin("self_attn.o_proj", i).reshape(H, hd, D)),
            "bo": zeros((L, D), np.float32),
            "ln2_g": stack(
                lambda i: t(f"layers.{i}.post_attention_layernorm.weight")
            ),
            "ln2_b": zeros((L, D), np.float32),
            # SwiGLU packing: gate/up stacked on their own axis (D, 2, F),
            # wi[:, 0] = gate, wi[:, 1] = up, as _dense_mlp reads them.
            "wi": stack(
                lambda i: np.stack(
                    [lin("mlp.gate_proj", i), lin("mlp.up_proj", i)], axis=1
                )
            ),
            "bi": zeros((L, 2, F_), np.float32),
            "wo2": stack(lambda i: lin("mlp.down_proj", i)),
            "bo2": zeros((L, D), np.float32),
        },
        "lnf_g": t("norm.weight"),
        "lnf_b": zeros((D,), np.float32),
    }
    if not tied:
        if "lm_head.weight" not in sd:
            raise ValueError(
                "checkpoint has tie_word_embeddings=False but no "
                "lm_head.weight — pass a LlamaForCausalLM (a bare "
                "LlamaModel carries no output head)"
            )
        params["lm_head"] = sd["lm_head.weight"]
    return params_from_jax(params, cfg, device), cfg


def _resolve_model(model_or_path: Any, family: str = "gpt2"):
    import os

    if isinstance(model_or_path, (str, os.PathLike)):
        if family == "llama":
            from transformers import LlamaForCausalLM as cls
        else:
            from transformers import GPT2LMHeadModel as cls

        # local_files_only: this is an import bridge, not a downloader —
        # point it at a checkout/export you already have on disk.
        return cls.from_pretrained(
            os.fspath(model_or_path), local_files_only=True
        )
    return model_or_path


def hf_gpt2_logits(model: Any, tokens: np.ndarray) -> np.ndarray:
    """Reference logits from the HF model (eval mode, no grad): the parity
    oracle the tests compare against."""
    model = model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(np.asarray(tokens, np.int64)))
    logits = out.logits if hasattr(out, "logits") else out.last_hidden_state
    return np.asarray(logits.float().numpy())
