"""The weight bridge: the JAX package's parameter trees <-> the port's.

Every model of the zoo keeps the JAX package's leaf names and layouts: the
GPT family's and BERT's stacked ``(L, ...)`` leaves
(``ray_lightning_tpu/models/gpt.py:171-267``, ``bert.py:72-109``), ViT's
(``vit.py:98-127``), flax's ResNet-18 tree with HWIO kernels, and the XOR
and MNIST fixtures' flat trees. So the bridge is a copy with no
re-layout: each numpy leaf becomes an fp32 tensor on the target device,
and a weight-only int8 node ``{"q": int8, "s": fp32}``
(``utils/quantize.py``) becomes an int8 tensor and an fp32 tensor of the
same shapes. Make the numpy tree on the JAX side with, e.g.,
``jax.tree_util.tree_map(np.asarray, init_gpt_params(key, cfg))``.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.models.bert import BERTConfig, bert_param_shapes
from ray_lightning_tpu_torch.models.gpt import GPTConfig, param_shapes
from ray_lightning_tpu_torch.models.vit import ViTConfig, vit_param_shapes
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.quantize import is_quantized


def _int8_node(node: Dict[str, Any], shape, path: str, device) -> Dict[str, Any]:
    """One int8 node, checked: ``q`` int8 of the leaf's shape, ``s`` fp32
    of the same rank with each dim 1 (a reduced axis) or the leaf's."""
    q = np.asarray(node["q"])
    s = np.asarray(node["s"])
    if q.dtype != np.int8 or q.shape != tuple(shape):
        raise ValueError(
            f"{path}: int8 node needs q int8 of shape {tuple(shape)}, got "
            f"{q.dtype} {q.shape}"
        )
    if s.ndim != q.ndim or any(
        n not in (1, m) for n, m in zip(s.shape, q.shape)
    ):
        raise ValueError(
            f"{path}: int8 node scales of shape {s.shape} do not broadcast "
            f"over q {q.shape} (each dim 1 or q's)"
        )
    return {
        "q": torch.from_numpy(q.copy()).to(device),
        "s": torch.from_numpy(s.astype(np.float32)).to(device),
    }


def expected_shapes(cfg: Any) -> Dict[str, Any]:
    """The tree of leaf shapes a model's parameters have: ``cfg`` is a
    ``GPTConfig``, ``BERTConfig`` or ``ViTConfig``, or the tree of shapes
    itself (``ResNet18.param_shapes(channels)``, ``XORModule.
    param_shapes()``, ``MNISTClassifier.param_shapes(in_features)``)."""
    if isinstance(cfg, GPTConfig):
        return param_shapes(cfg)
    if isinstance(cfg, BERTConfig):
        return bert_param_shapes(cfg)
    if isinstance(cfg, ViTConfig):
        return vit_param_shapes(cfg)
    if isinstance(cfg, dict):
        return cfg
    raise TypeError(f"no parameter shapes for {type(cfg).__name__}")


def params_from_jax(
    tree: Dict[str, Any],
    cfg: Any,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves, int8 nodes allowed) -> the port's
    tree on ``device``: fp32 tensors, and int8 nodes as int8 ``q`` and
    fp32 ``s``. Checks every leaf's name and shape against ``cfg`` (a
    config, a model, or a tree of shapes: :func:`expected_shapes`)."""
    device = resolve_device(device)
    expected = expected_shapes(cfg)

    def convert(node: Any, shapes: Any, path: str) -> Any:
        if isinstance(shapes, dict):
            if not isinstance(node, dict) or set(node) != set(shapes):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(
                    f"{path or 'params'}: expected leaves {sorted(shapes)}, "
                    f"got {got}"
                )
            return {
                k: convert(node[k], shapes[k], f"{path}/{k}" if path else k)
                for k in shapes
            }
        if is_quantized(node):
            return _int8_node(node, shapes, path, device)
        if isinstance(node, dict):
            raise ValueError(
                f"{path}: expected an array or an int8 node {{'q', 's'}}, "
                f"got leaves {sorted(node)}"
            )
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != tuple(shapes):
            raise ValueError(
                f"{path}: expected shape {tuple(shapes)}, got {arr.shape}"
            )
        return torch.from_numpy(arr.copy()).to(device)

    return convert(tree, expected, "")


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree -> the same tree of numpy arrays: fp32 leaves, and
    int8 nodes as int8 ``q`` and fp32 ``s`` (the JAX side takes it as is:
    ``jax.tree_util.tree_map(jnp.asarray, ...)``)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if is_quantized(v):
            out[k] = {
                "q": v["q"].detach().cpu().numpy(),
                "s": v["s"].detach().float().cpu().numpy(),
            }
        elif isinstance(v, dict):
            out[k] = params_to_numpy(v)
        else:
            out[k] = v.detach().float().cpu().numpy()
    return out
