"""``GSPMDStrategy``'s mesh and tensor-parallel forward (``parallel/
mesh.py``, ``parallel/tp.py``, ``models/gpt.py``) held against the JAX
package's on the CPU: the rank order and groups, the host-staged all-
gather, and each rank's logits from its slices against the JAX dense and
sharded forwards. ``tests/_torch_gspmd_common.py`` holds the four-rank
gloo world, the JAX strategy over 8 virtual devices and the bars.
"""
import dataclasses

import jax
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
from tests import _torch_dist_worker as W
from tests._torch_gspmd_common import (  # noqa: F401
    GPT_CFG,
    WORLD,
    jax_gspmd,
    jax_mesh,
    world,
)


# -- the mesh --------------------------------------------------------------


def test_rank_order_and_groups_follow_the_jax_device_order(world):
    """Rank r sits at ``np.unravel_index(r, sizes)`` over the six axes
    (data-parallel axes first, as the JAX mesh lays out its devices), and
    each group holds the ranks that differ on its axes alone."""
    ranks = world(W.mesh_info, {"data": 2, "model": 2})
    jmesh = jax_gspmd({"data": 4, "model": 2}).mesh
    for r, info in enumerate(ranks):
        assert info["coords"]["data"] == r // 2
        assert info["coords"]["model"] == r % 2
        assert info["dp_rank"] == r // 2
        assert info["groups"]["model"] == [r - r % 2, r - r % 2 + 1]
        assert info["groups"]["dp"] == info["groups"]["data"] == [r % 2,
                                                                 r % 2 + 2]
        assert info["groups"]["fsdp"] is None
    # The JAX mesh's devices along "model" are adjacent too.
    ids = np.vectorize(lambda d: d.id)(jmesh.devices).reshape(4, 2)
    assert (ids[:, 1] - ids[:, 0] == 1).all()


def test_staged_all_gather_matches_the_plain_one(world):
    """The all-gather a CUDA tensor takes on gloo (through host buffers)
    gives the plain one's result, in group-rank order along the model
    axis."""
    ranks = world(W.collectives, {"data": 2, "model": 2})
    mine = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
            for r in range(WORLD)]
    for r, out in enumerate(ranks):
        base = r - r % 2
        want = np.concatenate([mine[base], mine[base + 1]])
        np.testing.assert_array_equal(out["gather_staged=False"], want)
        np.testing.assert_array_equal(out["gather_staged=True"], want)


# -- the forward -----------------------------------------------------------

FWD_CASES = {
    "mha_model4": (GPT_CFG, {"model": 4}),
    "mha_data2_model2": (GPT_CFG, {"data": 2, "model": 2}),
    "mha_fsdp2_model2": (GPT_CFG, {"fsdp": 2, "model": 2}),
    "llama_gqa_swiglu_untied": (dataclasses.asdict(dataclasses.replace(
        jgpt.GPTConfig.llama(vocab_size=256, n_layer=2, n_head=4,
                             n_kv_head=2, d_model=64, d_ff=96, max_seq=64),
        attn_impl="reference")), {"data": 2, "model": 2}),
    # GPT-2's vocab (50257) is odd: ("vocab", "model") falls through and
    # the table stays whole on every rank.
    "odd_vocab_model4": (dict(GPT_CFG, vocab_size=257), {"model": 4}),
}


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_tp_forward_matches_jax_dense_and_sharded(world, case):
    """Each rank's logits on its data-parallel rows from its slices of the
    same weights: within atol 1e-4 of the JAX dense forward and of the JAX
    forward on sharded parameters."""
    cfg_kw, shape = FWD_CASES[case]
    jcfg = jgpt.GPTConfig(**cfg_kw)
    params = W.gpt_numpy_params(cfg_kw)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size,
                                             (4, 32)).astype(np.int32)
    dense = np.asarray(jgpt.gpt_forward(params, toks, jcfg))
    s = jax_gspmd(jax_mesh(shape))
    s.bind_module(jgpt.GPTLM(config=jcfg))
    placed = s.place_params(jax.tree_util.tree_map(np.asarray, params))
    sharded = np.asarray(jax.jit(lambda p, t: jgpt.gpt_forward(p, t, jcfg))(
        placed, toks))
    ranks = world(W.tp_forward, shape, cfg_kw, params, toks)
    dp = shape.get("data", 1) * shape.get("fsdp", 1)
    per = len(toks) // dp
    m = shape.get("model", 1)
    for r in ranks:
        rows = slice(r["dp_rank"] * per, (r["dp_rank"] + 1) * per)
        np.testing.assert_allclose(r["logits"], dense[rows], atol=1e-4)
        np.testing.assert_allclose(r["logits"], sharded[rows], atol=1e-4)
        want_rows = (jcfg.vocab_size // m if jcfg.vocab_size % m == 0
                     else jcfg.vocab_size)
        assert r["wte_rows"] == want_rows
