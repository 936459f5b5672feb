"""``GSPMDStrategy``'s train steps (``strategies/gspmd.py``,
``MeshTrainOptimizer``) held against the JAX package's ``GSPMDStrategy``
on the CPU: AdamW with global-norm clipping over data x model and fsdp x
model meshes, replicated leaves bitwise across model ranks, the FSDP
fallback of a module without logical axes, and ZeRO-3 with host-staged
gathers. ``tests/_torch_gspmd_common.py`` holds the four-rank gloo world,
the JAX strategy over 8 virtual devices and the bars.
"""
import jax
import numpy as np
import pytest

from ray_lightning_tpu.models.boring import BoringModule as JBoring
from tests import _torch_dist_worker as W
from tests._torch_gspmd_common import (  # noqa: F401
    BORING_TOL,
    CLIP,
    GPT_CFG,
    GPT_TOL,
    N_STEPS,
    assert_tree,
    boring_params,
    jax_gspmd,
    jax_gspmd_train,
    make_batches,
    world,
)


# -- train steps -----------------------------------------------------------


TRAIN_CASES = [(shape, n) for shape in ("data2_model2", "fsdp2_model2")
               for n in (1, N_STEPS)]
SHAPES = {"data2_model2": {"data": 2, "model": 2},
          "fsdp2_model2": {"fsdp": 2, "model": 2}}


@pytest.mark.parametrize("shape_name,n_steps", TRAIN_CASES)
def test_gspmd_steps_match_jax(world, shape_name, n_steps):
    """One step, and five, of AdamW with global-norm clipping on a
    tensor-parallel mesh: every rank's losses and logged grad norms and
    the whole gathered parameters against the JAX ``GSPMDStrategy``'s;
    the replicated leaves (norms, ``bo``, ``bo2``, ``wpe``, the final
    norm) bitwise equal on every rank; each rank's optimizer state holds
    its slices only and gathers to the whole leaves."""
    shape = SHAPES[shape_name]
    params = W.gpt_numpy_params(GPT_CFG)
    ranks = world(W.gspmd_train, shape, "gpt", params,
                  make_batches("gpt", N_STEPS)[:n_steps], CLIP, GPT_CFG)
    snaps, j_logs = jax_gspmd_train(shape, "gpt")
    for r in ranks:
        assert_tree(r["gathered"], snaps[n_steps - 1], GPT_TOL, "params")
        for got, want in zip(r["logs"], j_logs):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **GPT_TOL)
        assert r["logs"] == ranks[0]["logs"]
        assert r["replicated"].keys() == ranks[0]["replicated"].keys()
        for k, v in r["replicated"].items():
            np.testing.assert_array_equal(v, ranks[0]["replicated"][k],
                                          err_msg=k)
        assert set(map(tuple, r["state_shapes"])) <= set(
            map(tuple, r["shard_shapes"]))
        full = {np.shape(x) for x in jax.tree_util.tree_leaves(params)}
        assert set(map(tuple, r["full_state_shapes"])) <= full
    specs = ranks[0]["specs"]
    assert specs["blocks/wqkv"][3] == "model"
    assert specs["blocks/wo"][1] == "model" and specs["wte"][0] == "model"
    assert specs["blocks/bo"] == (None, None)
    fsdp = "fsdp" if "fsdp" in shape else None
    assert specs["blocks/wi"] == (None, fsdp, "model")
    assert specs["blocks/wo2"] == (None, "model", fsdp)
    assert {"blocks/ln1_g", "blocks/bo", "blocks/bo2", "lnf_g",
            "lnf_b"} <= set(ranks[0]["replicated"])


def test_fallback_without_logical_axes_is_fsdp_by_largest_axis(world):
    """``BoringModule`` has no ``param_logical_axes``: over ``{"fsdp": 4}``
    each leaf splits its largest divisible axis over fsdp (JAX
    ``tests/test_gpt.py:214-229``), and a step matches the JAX strategy's
    over ``{"fsdp": 8}``."""
    from jax.sharding import PartitionSpec as P

    js = jax_gspmd({"fsdp": 8})
    js.bind_module(JBoring())
    jspec = js.param_sharding(boring_params())
    assert jspec["w"].spec == P("fsdp", None)
    ranks = world(W.gspmd_train, {"fsdp": 4}, "boring", boring_params(),
                  make_batches("boring", 1), None)
    snaps, j_logs = jax_gspmd_train({"fsdp": 4}, "boring")
    for r in ranks:
        assert r["specs"] == {"w": ("fsdp", None), "b": (None,)}
        assert_tree(r["gathered"], snaps[0], BORING_TOL, "params")
        np.testing.assert_allclose(r["logs"][0]["loss"], j_logs[0]["loss"],
                                   **BORING_TOL)


def test_zero3_gathers_staged_through_host_memory(world):
    """``RayShardedStrategy(zero_stage=3)`` on four gloo ranks with every
    gather staged through host buffers (the path CUDA tensors of ranks
    sharing a card take) is bitwise the unstaged run, which
    ``tests/test_torch_strategies.py`` holds against the JAX ZeRO-3 step."""
    params = W.gpt_numpy_params(GPT_CFG)
    batches = make_batches("gpt", 1)
    staged = world(W.zero3_train, params, batches, True, GPT_CFG)
    plain = world(W.zero3_train, params, batches, False, GPT_CFG)
    for a, b in zip(staged, plain):
        assert a["logs"] == b["logs"]
        assert_tree(a["gathered"], b["gathered"], dict(rtol=0, atol=0))
        assert np.isfinite(a["logs"][0]["loss"])
