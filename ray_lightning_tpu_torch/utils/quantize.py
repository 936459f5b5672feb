"""Weight-only int8 quantization for inference (PyTorch port of the JAX
package's ``utils/quantize.py``).

Decode re-reads every matmul weight and the (V, D) head per generated
token, so halving the bytes per weight halves what the weights cost to
keep resident and to read. Weight-only int8 is symmetric with
per-output-channel fp32 scales over the contraction axes; activations and
accumulation stay in the compute dtype.

``quantize_params_int8`` maps a GPT parameter tree (``models/gpt.py``
layout) to the same tree with the large matmul leaves replaced by
``{"q": int8, "s": fp32 broadcast-ready scales}`` nodes; norms, biases,
positional tables and MoE expert/router leaves stay fp32. The forward and
decode paths read either form through :func:`dequant` and
:func:`embed_rows`, which dequantize where the weight is used. The
arithmetic is the JAX package's step for step (fp32 scale and division,
round half to even, the 1e-12 floor), so the same fp32 tree quantizes to
bit-identical ``q`` and ``s`` in both packages.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and set(w) == {"q", "s"}


def quantize_tensor(
    w: Any, reduce_axes: Tuple[int, ...]
) -> Dict[str, torch.Tensor]:
    """Symmetric int8 with fp32 scales shared over ``reduce_axes`` (the
    contraction dims of the consuming matmul, i.e. per output channel)."""
    w = torch.as_tensor(w).float()
    s = w.abs().amax(dim=tuple(reduce_axes), keepdim=True) / 127.0
    s = torch.clamp(s, min=1e-12)  # all-zero channels: avoid 0/0
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def dequant(w: Any, dt: torch.dtype) -> torch.Tensor:
    """Dense weights in ``dt``: a quantized node is dequantized as
    ``(q.float() * s).to(dt)`` where it is used; a tensor already in
    ``dt`` comes back as is (no copy), which is how the engine's
    compute-dtype copy of a float tree passes through every step."""
    if is_quantized(w):
        return (w["q"].float() * w["s"]).to(dt)
    return w.to(dt)


def embed_rows(table: Any, idx: torch.Tensor) -> torch.Tensor:
    """Row gather from a (possibly quantized) (V, D) table: gather the
    int8 rows and their scales, dequantize only what was read."""
    if is_quantized(table):
        return table["q"][idx].float() * table["s"][idx]
    return table[idx]


#: Contraction (reduce) axes per quantized leaf of the stacked GPT tree;
#: leaves absent from a model (GQA vs fused, tied vs untied) are skipped.
_GPT_BLOCK_AXES: Dict[str, Tuple[int, ...]] = {
    "wqkv": (1,),  # (L, D, 3, H, hd): contract D
    "wq": (1,),  # (L, D, H, hd)
    "wkv": (1,),  # (L, D, 2, Hkv, hd)
    "wo": (1, 2),  # (L, H, hd, D): contract H, hd
    "wi": (1,),  # (L, D, F) or (L, D, 2, F): contract D
    "wo2": (1,),  # (L, F, D): contract F
}


def quantize_params_int8(params: Dict[str, Any]) -> Dict[str, Any]:
    """GPT parameter tree -> the same tree with the large matmul weights as
    int8 nodes. MoE trees (a ``router`` leaf) keep their expert leaves
    ``wi``/``wo2`` fp32: expert weights are read sparsely and the router
    is accuracy-critical."""
    out: Dict[str, Any] = dict(params)
    blocks = dict(params["blocks"])
    moe = "router" in blocks
    for name, axes in _GPT_BLOCK_AXES.items():
        if name not in blocks:
            continue
        if moe and name in ("wi", "wo2"):
            continue
        blocks[name] = quantize_tensor(blocks[name], axes)
    out["blocks"] = blocks
    out["wte"] = quantize_tensor(params["wte"], (1,))  # (V, D): contract D
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"], (1,))
    return out


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse mapping to a plain fp32 tree (the reference semantics:
    the quantized path's outputs equal running this tree)."""

    def walk(node: Any) -> Any:
        if is_quantized(node):
            return node["q"].float() * node["s"]
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def weight_bytes(params: Dict[str, Any]) -> int:
    """Bytes of every tensor in a parameter tree (int8 nodes count their
    ``q`` and ``s``): the resident weight footprint."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    return int(params.numel()) * params.element_size()
