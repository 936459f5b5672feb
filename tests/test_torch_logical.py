"""The port's logical-axis rules (``parallel/logical.py``) and
``GSPMDStrategy``'s driver-side surface held against the JAX package's,
with no process group: every GPT leaf's resolved spec (MHA, GQA,
SwiGLU, untied head) on meshes built from shapes alone, JAX's own rule
cases (``tests/test_gpt.py:231-300``), the slice/reassemble pair that
carries weights across, the strategy's validation, sampler sharding and
batch multiplier (``tests/test_gpt.py:54-66``, ``:301-323``), and that
the new modules import without JAX.
"""
import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu.parallel.env import DistEnv as JDistEnv
from ray_lightning_tpu.parallel.logical import (
    DEFAULT_RULES as J_RULES,
    spec_from_logical as j_spec,
)
from ray_lightning_tpu.strategies import GSPMDStrategy as JGSPMD
from ray_lightning_tpu_torch.models.gpt import GPTConfig, gpt_logical_axes
from ray_lightning_tpu_torch.parallel.env import DistEnv
from ray_lightning_tpu_torch.parallel.logical import (
    DEFAULT_RULES,
    block_index,
    shard_of,
    spec_from_logical,
    tree_logical_specs,
    unshard,
)
from ray_lightning_tpu_torch.parallel.mesh import AXES, mesh_coords
from ray_lightning_tpu_torch.strategies import GSPMDStrategy
from tests import _torch_dist_worker as W

BASE = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, max_seq=64,
            attn_impl="reference")
CONFIGS = {
    "mha": BASE,
    "gqa_swiglu_untied_rope": dataclasses.asdict(GPTConfig.llama(
        vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
        d_ff=96, max_seq=64, attn_impl="reference")),
    "odd_vocab": dict(BASE, vocab_size=257),
    "gpt2_small": dataclasses.asdict(GPTConfig.gpt2_small()),
}
MESHES = [{"model": 2}, {"model": 4}, {"data": 2, "model": 2},
          {"fsdp": 2, "model": 2}, {"fsdp": 4}, {"data": 2, "fsdp": 2,
                                                 "model": 2}, {"data": 8}]


def _fake_mesh(shape):
    """What the JAX rule reads of a mesh: its axis sizes."""
    return SimpleNamespace(shape={ax: shape.get(ax, 1) for ax in AXES})


def _walk(tree, axes):
    if isinstance(tree, dict):
        for k in tree:
            yield from ((f"{k}/{p}", s, a) for p, s, a in
                        _walk(tree[k], axes[k]))
    else:
        yield "", tree, axes


def test_default_rules_are_the_jax_rules():
    assert DEFAULT_RULES == tuple(J_RULES)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
@pytest.mark.parametrize("mesh_i", range(len(MESHES)))
def test_gpt_leaf_specs_match_jax(cfg_name, mesh_i):
    """Every leaf of the GPT resolves to the JAX package's spec: the port's
    ``gpt_logical_axes`` is JAX's and the resolution is the same, the
    fall-throughs (an odd vocab, GPT-2 small's 50257) included."""
    kw = CONFIGS[cfg_name]
    shape = MESHES[mesh_i]
    jaxes = jgpt.gpt_logical_axes(jgpt.GPTConfig(**kw))
    taxes = gpt_logical_axes(GPTConfig(**kw))
    assert taxes == jaxes
    shapes = jax.eval_shape(
        lambda: jgpt.init_gpt_params(jax.random.PRNGKey(0),
                                     jgpt.GPTConfig(**kw)))
    specs = tree_logical_specs(shapes, taxes, shape)
    n = 0
    for (path, leaf, axes), (_, spec, _) in zip(_walk(shapes, jaxes),
                                                _walk(specs, taxes)):
        want = j_spec(leaf.shape, axes, J_RULES, _fake_mesh(shape))
        assert spec == tuple(want), (path, spec, want)
        n += 1
    assert n > 10
    if cfg_name == "gpt2_small" and shape.get("model", 1) > 1:
        assert specs["wte"][0] is None  # 50257 rows: replicated


def test_jax_rule_cases():
    """JAX ``tests/test_gpt.py:231-300``: an indivisible dim stays
    replicated, a mesh axis is used once per spec, a length mismatch
    raises, and a prepended ``(name, None)`` rule pins the axis
    replicated (terminal, first match wins)."""
    mesh = {"data": 2, "fsdp": 2, "model": 2}
    fake = _fake_mesh(mesh)
    for shape, axes in (((3, 32), ("heads", "embed")),
                        ((32, 32), ("embed", "embed")),
                        ((8, 16, 4), ("vocab", "embed", "mlp")),
                        ((2, 32, 3, 4, 8), ("layers", "embed", None, "heads",
                                            "kv"))):
        assert spec_from_logical(shape, axes, DEFAULT_RULES, mesh) == tuple(
            j_spec(shape, axes, J_RULES, fake))
    assert spec_from_logical((3, 32), ("heads", "embed"), DEFAULT_RULES,
                             mesh) == (None, "fsdp")
    assert spec_from_logical((32, 32), ("embed", "embed"), DEFAULT_RULES,
                             mesh) == ("fsdp", None)
    with pytest.raises(ValueError, match="logical axes"):
        spec_from_logical((32,), ("embed", "mlp"), DEFAULT_RULES, mesh)
    rules = [("heads", None)] + list(DEFAULT_RULES)
    shape, axes = (2, 32, 3, 4, 8), ("layers", "embed", None, "heads", "kv")
    got = spec_from_logical(shape, axes, rules, mesh)
    assert got == tuple(j_spec(shape, axes, rules, fake))
    assert got == (None, "fsdp", None, None, None)


def test_opt_specs_follow_structure_not_shape():
    """At d_ff == d_model, ``wi`` and ``wo2`` have one shape and two
    layouts: each moment takes its own parameter's spec (JAX
    ``tests/test_gpt.py:270-300``)."""
    from ray_lightning_tpu_torch.models.gpt import GPTLM, init_gpt_params

    cfg = GPTConfig(vocab_size=64, n_layer=2, n_head=2, d_model=32, d_ff=32,
                    max_seq=32, attn_impl="reference")
    s = GSPMDStrategy(num_workers=8, use_gpu=False,
                      mesh_shape={"fsdp": 4, "model": 2})
    s._module = GPTLM(cfg)
    g = torch.Generator()
    g.manual_seed(0)
    params = init_gpt_params(g, cfg)
    leaves = W._paths(params)
    opt = torch.optim.AdamW([p for _, p in leaves])
    for _, p in leaves:
        p.grad = torch.zeros_like(p)
    opt.step()
    psh = s.param_sharding(params)
    osh = s.opt_sharding(opt.state_dict(), params)
    names = [k for k, _ in leaves]
    wi, wo2 = names.index("blocks/wi"), names.index("blocks/wo2")
    assert osh[wi]["exp_avg"] == psh["blocks"]["wi"] == (None, "fsdp", "model")
    assert osh[wo2]["exp_avg_sq"] == psh["blocks"]["wo2"] == (None, "model",
                                                               "fsdp")
    assert osh[wi]["step"] == ()


SLICE_SPECS = [(None, None, None), ("model", None, None),
               (None, "fsdp", "model"), ("data", None, "model"),
               ("fsdp", "model", None)]


@pytest.mark.parametrize("spec", SLICE_SPECS)
def test_shard_of_and_unshard_round_trip(spec):
    """Every rank's slice of a leaf over a ``{"data": 2, "fsdp": 2,
    "model": 2}`` mesh reassembles to the leaf, bitwise; a numpy leaf
    slices the same as a tensor."""
    shape = {"data": 2, "fsdp": 2, "model": 2}
    full = torch.arange(8 * 4 * 12, dtype=torch.float32).reshape(8, 4, 12)
    pieces = {}
    for r in range(8):
        coords = mesh_coords(r, shape)
        piece = shard_of(full, spec, coords, shape)
        np.testing.assert_array_equal(
            piece.numpy(), shard_of(full.numpy(), spec, coords, shape))
        key = block_index(spec, coords, shape)
        if key in pieces:
            assert torch.equal(pieces[key], piece)  # a replica
        pieces[key] = piece
    assert torch.equal(unshard(pieces, spec, shape), full)


def test_rank_coordinates_are_row_major_over_the_axes():
    shape = {"data": 2, "fsdp": 1, "model": 2}
    assert [mesh_coords(r, shape)["model"] for r in range(4)] == [0, 1, 0, 1]
    assert [mesh_coords(r, shape)["data"] for r in range(4)] == [0, 0, 1, 1]
    for r in range(24):
        sizes = {"data": 2, "fsdp": 3, "model": 4}
        c = mesh_coords(r, sizes)
        assert r == np.ravel_multi_index(
            [c[ax] for ax in AXES], [sizes.get(ax, 1) for ax in AXES])


# -- the strategy ----------------------------------------------------------


def test_mesh_shape_validation_matches_jax():
    """JAX ``tests/test_gpt.py:54-66``: the same errors for a shape that
    misses ``num_workers``, an unknown axis, and ``sequence_parallel``
    without a seq axis; the axes the port does not run raise naming item
    13; no shape puts every worker on ``"data"``."""
    cases = [
        (dict(mesh_shape={"data": 4}), "covers"),
        (dict(mesh_shape={"tensor": 8}), "unknown mesh axis"),
        (dict(mesh_shape={"data": 8}, sequence_parallel=True),
         "sequence_parallel"),
        (dict(mesh_shape={"seq": 2, "pp": 4}, sequence_parallel=True),
         "pipeline"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            JGSPMD(num_workers=8, use_tpu=False, **kw)
        with pytest.raises(ValueError, match=match):
            GSPMDStrategy(num_workers=8, use_gpu=False, **kw)
    for kw in (dict(mesh_shape={"seq": 2, "data": 4}),
               dict(mesh_shape={"ep": 8}), dict(mesh_shape={"pp": 2,
                                                            "model": 4}),
               dict(mesh_shape={"seq": 8}, sequence_parallel=True)):
        JGSPMD(num_workers=8, use_tpu=False, **kw)
        with pytest.raises(NotImplementedError, match="item 13"):
            GSPMDStrategy(num_workers=8, use_gpu=False, **kw)
    assert GSPMDStrategy(num_workers=4, use_gpu=False).mesh_shape == {
        "data": 4}
    assert GSPMDStrategy(num_workers=4, use_gpu=False, mesh_shape={
        "fsdp": 2, "model": 2}).mesh_shape == {"fsdp": 2, "model": 2}


@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"fsdp": 4, "model": 2}, {"model": 8},
                                   {"data": 8}, {"data": 2, "fsdp": 2,
                                                 "model": 2}])
def test_sampler_and_batch_multiplier_follow_the_dp_extent(shape):
    """Each rank's sampler shard is JAX's for a host holding that one
    device (JAX ``gspmd.py:189-224``; ``tests/test_gpt.py:301-323``):
    ranks that share a data-parallel shard load the same rows, and the
    batch multiplier is 1."""
    t = GSPMDStrategy(num_workers=8, use_gpu=False, mesh_shape=shape)
    j = JGSPMD(num_workers=8, use_tpu=False, mesh_shape=shape)
    assert t.sampler_kwargs() == {"num_replicas": 1, "rank": 0}
    dp = shape.get("data", 1) * shape.get("fsdp", 1)
    for r in range(8):
        t.dist_env = DistEnv(world_size=8, num_hosts=8, host_rank=r)
        j.dist_env = JDistEnv(world_size=8, num_hosts=8, host_rank=r,
                              local_chips=1)
        assert t.sampler_kwargs() == j.sampler_kwargs()
        assert t.sampler_kwargs()["rank"] == (
            mesh_coords(r, shape)["data"] * shape.get("fsdp", 1)
            + mesh_coords(r, shape)["fsdp"])
        assert t.sampler_kwargs()["num_replicas"] == dp
        assert t.batch_multiplier == j.batch_multiplier == 1


def test_param_sharding_and_gpt_bind_checks():
    """The strategy's specs on the driver, and the model's mesh hook:
    seq/ep/pp larger than 1 and sequence parallelism raise naming item
    13."""
    from ray_lightning_tpu_torch.models.gpt import GPTLM, init_gpt_params

    cfg = GPTConfig(**BASE)
    s = GSPMDStrategy(num_workers=8, use_gpu=False,
                      mesh_shape={"data": 2, "fsdp": 2, "model": 2})
    s._module = GPTLM(cfg)
    g = torch.Generator()
    g.manual_seed(0)
    sh = s.param_sharding(init_gpt_params(g, cfg))
    assert sh["blocks"]["wqkv"] == (None, "fsdp", None, "model", None)
    assert sh["blocks"]["wi"] == (None, "fsdp", "model")
    assert sh["wte"] == ("model", "fsdp") and sh["lnf_g"] == (None,)
    mod = GPTLM(cfg)
    for axis in ("seq", "ep", "pp"):
        fake = SimpleNamespace(size=lambda a, axis=axis: 2 if a == axis else 1,
                               group=lambda a: None)
        with pytest.raises(NotImplementedError, match="item 13"):
            mod.bind_mesh(fake)
    with pytest.raises(NotImplementedError, match="item 13"):
        mod.bind_mesh(None, "seq")


def test_new_modules_import_without_jax():
    """``parallel/logical.py``, ``parallel/tp.py``, ``strategies/gspmd.py``
    and ``trainer/checkpoint_io.py`` import with neither ``jax`` nor the
    JAX package in ``sys.modules``."""
    code = (
        "import sys\n"
        "import ray_lightning_tpu_torch.parallel.logical\n"
        "import ray_lightning_tpu_torch.parallel.tp\n"
        "import ray_lightning_tpu_torch.parallel.mesh\n"
        "import ray_lightning_tpu_torch.strategies.gspmd\n"
        "import ray_lightning_tpu_torch.trainer.checkpoint_io\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ray_lightning_tpu' or m.startswith('ray_lightning_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
