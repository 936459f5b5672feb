"""The weight bridge: the JAX package's GPT parameter tree <-> the port's.

Both sides use the same leaf names and the same stacked ``(L, ...)``
layouts (``ray_lightning_tpu/models/gpt.py:171-267``), so the bridge is a
copy with no re-layout: each numpy leaf becomes an fp32 tensor on the
target device. Make the numpy tree on the JAX side with, e.g.,
``jax.tree_util.tree_map(np.asarray, init_gpt_params(key, cfg))``.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np
import torch

from ray_lightning_tpu_torch.models.gpt import GPTConfig, param_shapes
from ray_lightning_tpu_torch.utils.device import resolve_device
from ray_lightning_tpu_torch.utils.quantize import is_quantized


def params_from_jax(
    tree: Dict[str, Any],
    cfg: GPTConfig,
    device: Union[str, torch.device] = "cuda",
) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) -> the port's tree of fp32 tensors
    on ``device``. Checks every leaf's name and shape against ``cfg``."""
    device = resolve_device(device)
    expected = param_shapes(cfg)

    def convert(node: Any, shapes: Any, path: str) -> Any:
        if isinstance(shapes, dict):
            if is_quantized(node):
                raise NotImplementedError(
                    f"{path}: int8 weight trees are not ported yet (ROADMAP "
                    "queue 1 item 8)"
                )
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
            raise NotImplementedError(
                f"{path}: int8 weight trees are not ported yet (ROADMAP "
                "queue 1 item 8)"
            )
        arr = np.asarray(node, dtype=np.float32)
        if arr.shape != tuple(shapes):
            raise ValueError(
                f"{path}: expected shape {tuple(shapes)}, got {arr.shape}"
            )
        return torch.from_numpy(arr.copy()).to(device)

    return convert(tree, expected, "")


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The port's tree -> the same tree of fp32 numpy arrays (the JAX side
    takes it as is: ``jax.tree_util.tree_map(jnp.asarray, ...)``)."""
    return {
        k: (
            params_to_numpy(v)
            if isinstance(v, dict)
            else v.detach().float().cpu().numpy()
        )
        for k, v in params.items()
    }
