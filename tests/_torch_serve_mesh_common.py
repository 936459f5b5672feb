"""What the tensor-parallel serving test files share
(``tests/test_torch_serve_mesh.py``, ``test_torch_serve_mesh_chunked.py``,
``_spec.py`` and ``_fused.py``, split so that none passes 60 s): the two-rank gloo world, the weights,
the reference engines and the check every mesh case makes. The cases hold
the port against the JAX package's sharded engine
(``tests/test_serve_sharded.py``).

Two fabric actors join one gloo world for the module; every case builds
its ``DecodeEngine(mesh=mesh_from_spec(...))`` on both ranks, each holding
its half of the heads, the KV cache and the MLP columns, and drives it
with the same requests (``tests/_torch_serve_mesh_worker.py``, JAX-free).
Each mesh case holds: both ranks' tokens bitwise equal; greedy tokens equal
to the port's single-rank engine, the JAX single-device engine and the
JAX engine on a mesh of the 8 virtual CPU devices (``(4, 2)``; ``(2, 4)``
for the GQA config, whose 2 KV heads do not split 4 ways); and, on the
model functions, logits within 1e-5 of the single-rank ones (the split
only reorders the out projection's and the MLP's partial sums).

Weights: the JAX ``init_gpt_params`` of the config plus seeded numpy noise
(0.1 * N(0, 1) on every leaf, carried across by ``models/weights.py``'s
layout); the bare init sends every prompt of this width to one repeated
token, which would hold nothing. fp32, ``attn_impl="reference"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
import ray_lightning_tpu.serve.scheduler as j_sched
from ray_lightning_tpu.parallel.mesh import build_mesh as j_build_mesh
from ray_lightning_tpu.serve.engine import DecodeEngine as JEngine
import ray_lightning_tpu_torch.serve.scheduler as t_sched
from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.launchers import TrainWorker
from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from tests import _torch_dist_worker as W
from tests import _torch_serve_mesh_worker as M

T = 60.0  # every wait on the world is bounded by this
WORLD = 2
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
SHARD = dict(vocab_size=97, n_layer=2, n_head=4, d_model=32, max_seq=64,
             attn_impl="reference", compute_dtype="float32")
GQA = dict(SHARD, n_kv_head=2)


@pytest.fixture(scope="module")
def world():
    """Two fabric actors joined into one gloo group; ``run(fn, *args)``
    runs ``fn`` on both ranks and returns their results."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RLT_NUM_GPUS", "0")
    mp.delenv("RLT_REQUIRE_GPU", raising=False)
    fabric.init(num_cpus=WORLD)
    try:
        env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
        actors = [fabric.remote(TrainWorker).options(num_cpus=1, env=env)
                  .remote() for _ in range(WORLD)]
        port = fabric.get(actors[0].find_free_port.remote(), timeout=T)
        envs = [dict(world_size=WORLD, num_hosts=WORLD, host_rank=r,
                     coordinator_address=f"127.0.0.1:{port}", backend="gloo")
                for r in range(WORLD)]
        ranks = fabric.get([a.execute.remote(W.join, e)
                            for a, e in zip(actors, envs)], timeout=T)
        assert ranks == list(range(WORLD))

        def run(fn, *args):
            return fabric.get([a.execute.remote(fn, *args) for a in actors],
                              timeout=T)

        yield run
        run(W.leave)
    finally:
        fabric.shutdown()
        mp.undo()


_WEIGHTS = {}


def weights(cfg_kwargs):
    """(numpy tree, JAX tree) of the JAX init plus seeded noise."""
    key = tuple(sorted(cfg_kwargs.items()))
    if key not in _WEIGHTS:
        init = jgpt.init_gpt_params(jax.random.PRNGKey(0),
                                    jgpt.GPTConfig(**cfg_kwargs))
        rng = np.random.default_rng(0)

        def noisy(x):
            x = np.asarray(x, np.float32)
            return (x + 0.1 * rng.standard_normal(x.shape)).astype(
                np.float32)

        tree = jax.tree_util.tree_map(noisy, init)
        _WEIGHTS[key] = (tree, jax.tree_util.tree_map(jnp.asarray, tree))
    return _WEIGHTS[key]


def jax_tokens(cfg_kwargs, kw, reqs, driver, join=None):
    """The JAX engine's tokens on one device and on a mesh of the 8
    virtual devices (model 4, or 2 where the KV heads do not split 4
    ways)."""
    cfg = jgpt.GPTConfig(**cfg_kwargs)
    _, jparams = weights(cfg_kwargs)
    model = 4 if cfg.kv_head % 4 == 0 else 2
    out = {}
    for label, mesh in (("single", None),
                        ("mesh", j_build_mesh((model, 8 // model),
                                              ("model", "data")))):
        eng = JEngine(jparams, cfg, mesh=mesh, **kw)
        compiled = eng.compiled_count
        if driver == "scheduler":
            out[label] = M.run_scheduler(eng, j_sched, reqs)
        elif driver == "workload":
            out[label] = M.run_workload(eng, list(reqs), join)
        else:
            out[label] = M.run_one_by_one(eng, reqs)
        assert eng.compiled_count == compiled, label
    return out


def port_single(cfg_kwargs, kw, reqs, driver, join=None):
    """The port's single-rank engine, in the test process."""
    tree, _ = weights(cfg_kwargs)
    eng = DecodeEngine(M.to_torch(tree, cfg_kwargs), GPTConfig(**cfg_kwargs),
                       device="cpu", **kw)
    if driver == "scheduler":
        return M.run_scheduler(eng, t_sched, reqs)
    if driver == "workload":
        return M.run_workload(eng, list(reqs), join)
    return M.run_one_by_one(eng, reqs)


def check_mesh_case(world, cfg_kwargs, kw, reqs, driver, join=None,
                    spec="2x1"):
    """Run one workload on the mesh and hold it against the references;
    returns rank 0's record."""
    tree, _ = weights(cfg_kwargs)
    ranks = world(M.engine_case, spec, cfg_kwargs, tree, kw, reqs, driver,
                  join)
    r0, r1 = ranks
    assert r0["tokens"] == r1["tokens"]  # the ranks emit the same tokens
    for name in r0["device_state"]:
        np.testing.assert_array_equal(r0["device_state"][name],
                                      r1["device_state"][name], name)
    for r in ranks:  # gloo: eager, nothing captured, nothing after
        assert r["graphed"] is False and r["compiled"] == (0, 0)
        assert r["mesh"] == spec
    single = port_single(cfg_kwargs, kw, reqs, driver, join)
    assert r0["tokens"] == single
    ref = jax_tokens(cfg_kwargs, kw, reqs, driver, join)
    assert ref["single"] == ref["mesh"]
    assert r0["tokens"] == ref["single"]
    return r0


def reqs_of(seed, sizes):
    """Requests of ``sizes`` (prompt length, new tokens) from ``seed``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 97, size=s).tolist(), n) for s, n in sizes]
