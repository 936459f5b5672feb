"""What the zoo's model-axis test runs on each rank of its two-rank gloo
world (``tests/test_torch_zoo_mesh.py``), and in the test process for the
whole weights.

A fabric actor imports this module by reference, so it imports neither JAX
nor the JAX package: cases take numpy weights and inputs and return numpy
arrays.
"""
from typing import Any, Dict, Optional

import numpy as np
import torch


def split_case(family: str, cfg_kwargs: Dict[str, Any], tree: Any,
               x: np.ndarray, y: np.ndarray, model: Optional[int]
               ) -> Dict[str, Any]:
    """``family`` ("bert" or "vit") on this rank's slices of ``tree`` over a
    ``{"model": model}`` mesh (None: the whole weights, no mesh), placed by
    the module's ``param_logical_axes`` through the rules, as
    ``GSPMDStrategy`` places them; the forward through the module bound to
    the mesh. Returns the logits, the loss's gradient of each leaf (this
    rank's slice), the leaves' specs and this rank's model coordinate."""
    from ray_lightning_tpu_torch.models import bert, vit
    from ray_lightning_tpu_torch.models.weights import (
        params_from_jax,
        params_to_numpy,
    )
    from ray_lightning_tpu_torch.parallel.logical import tree_logical_specs
    from ray_lightning_tpu_torch.parallel.mesh import build_mesh
    from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

    if family == "bert":
        cfg = bert.BERTConfig(**cfg_kwargs)
        module = bert.BERTEncoder(cfg)
    else:
        cfg = vit.ViTConfig(**cfg_kwargs)
        module = vit.ViTClassifier(cfg)
    params = params_from_jax(tree, cfg, "cpu")
    mesh = build_mesh({"model": model}) if model else None
    specs = None
    if mesh is not None:
        module.bind_mesh(mesh)
        specs = tree_logical_specs(params, module.param_logical_axes(),
                                   mesh.shape)
        params = _cut(params, specs, mesh)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    if family == "bert":
        logits = bert.bert_forward(params, xt, cfg, mesh=module._mesh)
        loss, _ = bert.masked_lm_loss(logits, yt)
    else:
        logits = module._forward(params, xt)
        loss = torch.nn.functional.cross_entropy(logits, yt)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    return {
        "logits": logits.detach().numpy(),
        "grads": params_to_numpy(grads),
        "specs": specs,
        "coord": None if mesh is None else mesh.coords["model"],
    }


def _cut(params: Any, specs: Any, mesh: Any) -> Any:
    """This rank's slice of every leaf (copies)."""
    from ray_lightning_tpu_torch.parallel.logical import shard_of

    if isinstance(params, dict):
        return {k: _cut(v, specs[k], mesh) for k, v in params.items()}
    return shard_of(params, specs, mesh.coords, mesh.shape).clone()
