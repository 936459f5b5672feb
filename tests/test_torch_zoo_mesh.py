"""PyTorch port, model zoo under a mesh's ``"model"`` axis: BERT's and
ViT's blocks split Megatron-style over two gloo ranks, held against the
port's dense forward and the JAX package's (``tests/test_bert.py:155``
and ``tests/test_vit.py:118`` are the bars: 2e-4 on BERT's logits, 1e-4 on
ViT's).

One two-rank world serves the module (the ``world`` fixture of
``tests/_torch_serve_mesh_common.py``). Each rank holds its slices of the
weights as the rules place them from the module's
``param_logical_axes`` (heads, MLP columns and BERT's 64-row vocabulary
over ``"model"``) and runs the forward and the backward of the loss; the
gradient of each slice must be that slice of the dense gradient (5e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_lightning_tpu.models.bert as jbert
import ray_lightning_tpu.models.vit as jvit
from ray_lightning_tpu_torch.parallel.logical import shard_of
from tests import _torch_zoo_mesh_worker as Z
from tests._torch_serve_mesh_common import world  # noqa: F401 - fixture

GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
BERT = dict(vocab_size=64, n_layer=2, n_head=2, d_model=32, max_seq=32,
            attn_impl="reference")
#: One head and an odd vocabulary: the rules keep the heads and ``wte``
#: whole and split only the MLP columns.
BERT_MLP_ONLY = dict(BERT, vocab_size=63, n_head=1)
VIT = dict(image_size=16, patch_size=4, n_layer=2, n_head=4, d_model=64,
           d_ff=64, attn_impl="reference")


def _inputs(family, kw):
    rng = np.random.default_rng(1)
    if family == "bert":
        cfg = jbert.BERTConfig(**kw)
        params = jbert.init_bert_params(jax.random.PRNGKey(0), cfg)
        toks = rng.integers(0, cfg.mask_id, (4, 32)).astype(np.int32)
        sel = rng.random(toks.shape) < 0.15
        sel[:, 0] = True
        x = np.where(sel, cfg.mask_id, toks).astype(np.int32)
        y = np.where(sel, toks, -1).astype(np.int32)
        want = jbert.bert_forward(params, jnp.asarray(x), cfg)
        tol = dict(atol=2e-4, rtol=0)
    else:
        cfg = jvit.ViTConfig(**kw)
        params = jvit.init_vit_params(jax.random.PRNGKey(0), cfg)
        x = rng.normal(size=(4, 16, 16, 3)).astype(np.float32)
        y = np.array([0, 3, 5, 9], np.int32)
        want = jvit.vit_forward(params, jnp.asarray(x), cfg)
        tol = dict(atol=1e-4, rtol=1e-4)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return tree, x, y, np.asarray(want), tol


def _check_grads(got, dense, specs, coord):
    if isinstance(dense, dict):
        for k in dense:
            _check_grads(got[k], dense[k], specs[k], coord)
        return
    want = shard_of(dense, specs, {"model": coord}, {"model": 2})
    np.testing.assert_allclose(got, want, **GRAD_TOL)


CASES = {"bert": ("bert", BERT, True), "vit": ("vit", VIT, True),
         "bert_mlp_only": ("bert", BERT_MLP_ONLY, False)}


@pytest.mark.parametrize("case", list(CASES))
def test_model_axis_split_matches_the_dense_forward(world, case):
    """At model=2 both ranks' logits equal each other and the dense
    forward's (the port's and JAX's, at JAX's bars); the heads (where the
    extent divides them), the MLP columns and BERT's even vocabulary are
    split; every slice's gradient is the slice of the dense gradient."""
    family, kw, heads_split = CASES[case]
    tree, x, y, want, tol = _inputs(family, kw)
    ranks = world(Z.split_case, family, kw, tree, x, y, 2)
    dense = Z.split_case(family, kw, tree, x, y, None)
    np.testing.assert_allclose(dense["logits"], want, **tol)
    assert [r["coord"] for r in ranks] == [0, 1]
    blocks = ranks[0]["specs"]["blocks"]
    split = "model" if heads_split else None
    assert blocks["wqkv"][3] == split and blocks["wo"][1] == split
    assert blocks["wi"][2] == "model" and blocks["wo2"][1] == "model"
    if family == "bert":
        assert ranks[0]["specs"]["wte"][0] == (
            "model" if kw["vocab_size"] % 2 == 0 else None)
    for r in ranks:
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
        np.testing.assert_allclose(r["logits"], dense["logits"], **tol)
        np.testing.assert_allclose(r["logits"], want, **tol)
        _check_grads(r["grads"], dense["grads"], r["specs"], r["coord"])
