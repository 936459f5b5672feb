"""What the ``GSPMDStrategy`` test files share: the four-rank gloo world
(a module-scoped fixture each file imports), the JAX strategy built in
process over 8 virtual CPU devices as ``tests/test_gpt.py:22-33`` builds
it, the JAX steps the port's are held against, and the bars.

The world is four fabric actors running ``TrainWorker.execute``, joined
once per test module (``tests/_torch_dist_worker.py`` holds what they
run; it imports no JAX); each mesh shape is a set of subgroups of that
world. The JAX mesh takes the port's model (and fsdp) extent, with the
data axis making up the 8: the update is the mean over the same global
batch either way. Bars: the port's model bar, rtol = atol = 1e-4, on the
GPT (logits: atol 1e-4, JAX ``tests/test_gpt.py:116``); 1e-5 / 1e-6 on
``BoringModule``.
"""
import dataclasses

import jax
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu.models.boring import BoringModule as JBoring
from ray_lightning_tpu.parallel.env import DistEnv as JDistEnv
from ray_lightning_tpu.strategies import GSPMDStrategy as JGSPMD
from ray_lightning_tpu.trainer.loop import TrainerSpec as JSpec
from ray_lightning_tpu.trainer.loop import TrainingLoop as JLoop
from ray_lightning_tpu.trainer.module import unpack_optimizers as j_unpack
from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.launchers import TrainWorker
from tests import _torch_dist_worker as W

T = 60.0  # every wait on the world is bounded by this
WORLD = 4
BORING_TOL = dict(rtol=1e-5, atol=1e-6)
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = jgpt.GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                      max_seq=64, attn_impl="reference")
GPT_CFG = dataclasses.asdict(JCFG)
CLIP = 0.3
N_STEPS = 5


@pytest.fixture(scope="module")
def world():
    """Four fabric actors joined into one gloo group; ``run(fn, *args)``
    runs ``fn`` on every rank and returns the ranks' results."""
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


def jax_gspmd(mesh_shape, **kw):
    """The JAX strategy in process over its 8 virtual devices."""
    s = JGSPMD(num_workers=8, use_tpu=False, mesh_shape=mesh_shape, **kw)
    s.dist_env = JDistEnv(world_size=8, num_hosts=1, host_rank=0,
                          local_chips=8)
    s.mesh = s.build_mesh()
    return s


def jax_mesh(port_shape):
    """The JAX mesh of 8 with the port's model and fsdp extents and the
    data axis making up the rest."""
    m, f = port_shape.get("model", 1), port_shape.get("fsdp", 1)
    shape = {"model": m} if m > 1 else {}
    if f > 1:
        shape["fsdp"] = 8 // m
    else:
        shape["data"] = 8 // m
    return shape


def assert_tree(got, want, tol, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_tree(got[k], want[k], tol, f"{what}/{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


def make_batches(kind, n):
    rng = np.random.default_rng(7)
    if kind == "boring":
        return [rng.standard_normal((16, 32)).astype(np.float32)
                for _ in range(n)]
    return [rng.integers(0, JCFG.vocab_size, (8, JCFG.max_seq + 1))
            .astype(np.int32) for _ in range(n)]


def boring_params():
    rng = np.random.default_rng(7)
    return {"w": (0.1 * rng.standard_normal((32, 2))).astype(np.float32),
            "b": np.zeros((2,), np.float32)}


def _jax_steps(strategy, module, params, batches, clip):
    """The JAX strategy's steps on the whole global batches: the params
    after each step and every step's logs."""
    loop = JLoop(JSpec(gradient_clip_val=clip), module, strategy,
                 strategy.dist_env)
    tx = loop._wrap_optimizer(j_unpack(module.configure_optimizers())[0])
    strategy.bind_module(module)
    p = strategy.place_params(params)
    o = strategy.place_opt_state(tx.init(params), params)
    step = strategy.compile_train_step(module, tx, log_grad_norm=True)
    snaps, logs = [], []
    for i, batch in enumerate(batches):
        p, o, lg = step(p, o, strategy.make_global_batch(batch),
                        jax.random.PRNGKey(0), i)
        snaps.append(jax.tree_util.tree_map(np.asarray, p))
        logs.append({k: float(v) for k, v in lg.items()})
    return snaps, logs


_JAX_CACHE = {}


def jax_gspmd_train(shape, kind):
    """The JAX GSPMD step compiled once per mesh and kind and run
    ``N_STEPS`` steps: the params after each step and every step's logs
    (a run of fewer steps reads a prefix)."""
    key = (tuple(sorted(shape.items())), kind)
    if key not in _JAX_CACHE:
        module = (JBoring() if kind == "boring"
                  else jgpt.GPTLM(JCFG, warmup_steps=0))
        params = (boring_params() if kind == "boring"
                  else W.gpt_numpy_params(GPT_CFG))
        _JAX_CACHE[key] = _jax_steps(jax_gspmd(jax_mesh(shape)), module,
                                     params, make_batches(kind, N_STEPS),
                                     CLIP if kind == "gpt" else None)
    return _JAX_CACHE[key]
