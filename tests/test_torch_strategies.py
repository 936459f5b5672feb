"""The port's launched strategies (``ray_lightning_tpu_torch/strategies``,
``parallel/``) held against the JAX package's on the CPU: the ZeRO shard
rule, worker planning and rank math, and the training, eval and predict
steps of ``RayStrategy``, ``HorovodRayStrategy`` and ``RayShardedStrategy``
(stages 1-3) in a two-rank gloo world.

The world is two fabric actors running ``TrainWorker.execute``, joined
once for the whole module (``tests/_torch_dist_worker.py`` holds what
they run; it imports no JAX). Each rank steps on its half of a global
batch; the JAX strategies step on the whole of it over 8 virtual CPU
devices, built in process as ``tests/test_horovod.py`` builds them. The
same numpy weights and batches go to both. Bars: 1e-5 relative and 1e-6
absolute on ``BoringModule`` (``tests/test_horovod.py``'s ring-vs-GSPMD
bar), 1e-4 on the GPT (the model bar).

The port's ring strategy is held against the JAX ``RayTPUStrategy`` step,
the result ``tests/test_horovod.py::test_ring_step_in_process_matches_
gspmd`` requires of the JAX ring: under the JAX this repository pins
(0.9.0), the JAX ``RingTPUStrategy`` train step applies 8 times the
mean gradient on 8 devices (``shard_map``'s autodiff already sums the
gradient of a replicated input over the axis before the explicit
``pmean``), so its SGD update and logged ``grad_norm`` differ from the
data-parallel ones; the port's ring averages as data parallelism does.
"""
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu.models.boring import BoringModule as JBoring
from ray_lightning_tpu.parallel.env import DistEnv as JDistEnv
from ray_lightning_tpu.parallel.zero import (
    sharded_bytes_fraction as j_fraction,
    shard_spec_for,
    tree_shardings,
)
from ray_lightning_tpu.strategies import RayShardedStrategy as JSharded
from ray_lightning_tpu.strategies import RayTPUStrategy as JDDP
from ray_lightning_tpu.strategies import RingTPUStrategy as JRing
from ray_lightning_tpu.trainer import Trainer as JTrainer
from ray_lightning_tpu.trainer.loop import TrainerSpec as JSpec
from ray_lightning_tpu.trainer.loop import TrainingLoop as JLoop
from ray_lightning_tpu.trainer.module import unpack_optimizers as j_unpack
from ray_lightning_tpu_torch import fabric
from ray_lightning_tpu_torch.launchers import GPULauncher, TrainWorker
from ray_lightning_tpu_torch.parallel.env import DistEnv
from ray_lightning_tpu_torch.parallel.zero import (
    shard_dim_for,
    sharded_bytes_fraction,
    tree_shard_dims,
)
from ray_lightning_tpu_torch.strategies import (
    GSPMDStrategy,
    HorovodRayStrategy,
    RayShardedStrategy,
    RayStrategy,
)
from ray_lightning_tpu_torch.trainer.data import DataLoader, DistributedSampler
from tests import _torch_dist_worker as W

T = 60.0  # every wait on the world is bounded by this
BORING_TOL = dict(rtol=1e-5, atol=1e-6)
GPT_TOL = dict(rtol=1e-4, atol=1e-4)
JCFG = jgpt.GPTConfig(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                      max_seq=64, attn_impl="reference")
GPT_CFG = dataclasses.asdict(JCFG)


# -- the shard rule --------------------------------------------------------

SHAPES = [(), (1,), (6,), (8,), (16,), (3, 5), (8, 8), (16, 8), (8, 16),
          (10, 128), (128, 10), (2, 4, 6), (12, 12, 4), (7, 9), (64, 256),
          (256,), (1, 8), (4, 4)]


def _jax_dim(spec):
    dims = [i for i, a in enumerate(spec) if a == "data"]
    return dims[0] if dims else None


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_shard_rule_matches_jax(world):
    """The dim each leaf is split along, or None, is JAX
    ``shard_spec_for``'s (largest dim divisible by and at least the world
    size, the first on a tie)."""
    for shape in SHAPES:
        assert shard_dim_for(shape, world) == _jax_dim(
            shard_spec_for(shape, world)), shape


def test_sharded_fraction_of_the_gpt_tree_matches_jax():
    params = W.gpt_numpy_params(GPT_CFG)
    mesh = jax.make_mesh((8,), ("data",))
    tparams = {k: ({n: torch.as_tensor(x) for n, x in v.items()}
                   if isinstance(v, dict) else torch.as_tensor(v))
               for k, v in params.items()}
    got = sharded_bytes_fraction(tparams, tree_shard_dims(tparams, 8))
    want = j_fraction(params, tree_shardings(params, mesh))
    assert got == pytest.approx(want, abs=1e-12) and 0 < got <= 1


# -- planning and ranks ----------------------------------------------------


def test_plan_workers_resources_and_env(monkeypatch):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    s = RayStrategy(num_workers=2, num_cpus_per_worker=2,
                    resources_per_worker={"extra": 2})
    plans, use_gpu = s.plan_workers()
    assert use_gpu and s.backend == "nccl" and len(plans) == 2
    for rank, p in enumerate(plans):
        assert p.host_rank == rank and p.num_cpus == 2 and p.num_gpus == 1.0
        assert p.resources == {"extra": 2.0}
        assert p.env == {"OMP_NUM_THREADS": "2"}
    cpu = RayStrategy(num_workers=2, use_gpu=False)
    plans, use_gpu = cpu.plan_workers()
    assert not use_gpu and cpu.backend == "gloo"
    assert all(p.num_gpus == 0 and p.env["CUDA_VISIBLE_DEVICES"] == ""
               for p in plans)


def test_plan_divisibility_and_cards_per_process():
    with pytest.raises(ValueError, match="divisible"):
        RayStrategy(num_workers=3, num_hosts=2).plan_workers()
    with pytest.raises(NotImplementedError, match="11b"):
        RayStrategy(num_workers=4, num_hosts=2).plan_workers()
    with pytest.raises(NotImplementedError, match="11b"):
        RayStrategy(num_workers=1, resources_per_worker={"GPU": 2})
    with pytest.raises(ValueError, match="use_gpu=False"):
        RayStrategy(num_workers=1, use_gpu=False,
                    resources_per_worker={"GPU": 1})
    assert len(RayStrategy(num_workers=4, num_hosts=4).plan_workers()[0]) == 4


def test_fractional_gpu_warns_and_joins_over_gloo(caplog):
    s = RayStrategy(num_workers=2, resources_per_worker={"GPU": 0.5})
    with caplog.at_level(logging.WARNING, logger="ray_lightning_tpu_torch"):
        plans, _ = s.plan_workers()
    assert "fractional GPU" in caplog.text and "eagerly" in caplog.text
    assert s.backend == "gloo" and all(p.num_gpus == 0.5 for p in plans)
    with pytest.raises(NotImplementedError, match="11b"):
        RayShardedStrategy(num_workers=2, resources_per_worker={"GPU": 0.5})


class _FakeActor:
    """Mock worker for the rank math (JAX ``tests/test_ddp.py:21-33``)."""

    class _Method:
        def __init__(self, value):
            self._value = value

        def remote(self):
            return self._value  # fabric.get passes plain values through

    def __init__(self, ip):
        self.get_node_ip = self._Method(ip)


def test_get_local_ranks_rank_math():
    launcher = GPULauncher(RayStrategy(num_workers=4, use_gpu=False), None)
    launcher._workers = [_FakeActor(ip) for ip in
                         ("10.0.0.1", "10.0.0.2", "10.0.0.1", "10.0.0.2")]
    assert launcher.get_local_ranks() == {0: (0, 0), 1: (0, 1), 2: (1, 0),
                                          3: (1, 1)}


def test_sampler_kwargs_and_shards():
    from ray_lightning_tpu.trainer.data import (
        DistributedSampler as JSampler,
    )

    s = RayStrategy(num_workers=4, use_gpu=False)
    assert s.sampler_kwargs() == {"num_replicas": 1, "rank": 0}
    s.dist_env = DistEnv(world_size=4, num_hosts=4, host_rank=3)
    assert s.sampler_kwargs() == {"num_replicas": 4, "rank": 3}
    assert s.batch_multiplier == 1 and s.global_rank == 3
    for shuffle in (False, True):
        shards = [DistributedSampler(10, num_replicas=2, rank=r,
                                     shuffle=shuffle, seed=5)
                  for r in range(2)]
        for r, t in enumerate(shards):
            j = JSampler(10, num_replicas=2, rank=r, shuffle=shuffle, seed=5)
            t.set_epoch(1)
            j.set_epoch(1)
            idx, mask = t.indices_and_mask()
            np.testing.assert_array_equal(idx, j.indices())
        both = np.concatenate([sh.indices_and_mask()[0] for sh in shards])
        assert sorted(both.tolist()) == list(range(10))


def test_ctor_surfaces():
    h = HorovodRayStrategy(num_workers=2, num_cpus_per_worker=1, use_gpu=False)
    assert h.strategy_name == "horovod_ray" and h.world_size == 2
    assert h.global_rank == 0 and h.local_rank == 0 and h.node_rank == 0
    assert RayStrategy().use_gpu  # the card by default
    z = RayShardedStrategy(num_workers=2, use_gpu=False)
    assert z.strategy_name == "ddp_sharded_ray" and z.zero_stage == 1
    assert z.gather_is_collective
    with pytest.raises(ValueError, match="zero_stage"):
        RayShardedStrategy(num_workers=2, zero_stage=5)
    with pytest.raises(NotImplementedError, match="11b"):
        GSPMDStrategy(num_workers=2)


# -- the two-rank world ----------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """Two fabric actors joined into one gloo group; ``run(fn, *args)``
    runs ``fn`` on both and returns the ranks' results."""
    mp = pytest.MonkeyPatch()
    mp.setenv("RLT_NUM_GPUS", "0")
    mp.delenv("RLT_REQUIRE_GPU", raising=False)
    fabric.init(num_cpus=2)
    try:
        env = {"CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1"}
        actors = [fabric.remote(TrainWorker).options(num_cpus=1, env=env)
                  .remote() for _ in range(2)]
        port = fabric.get(actors[0].find_free_port.remote(), timeout=T)
        envs = [dict(world_size=2, num_hosts=2, host_rank=r,
                     coordinator_address=f"127.0.0.1:{port}", backend="gloo")
                for r in range(2)]
        ranks = fabric.get([a.execute.remote(W.join, e)
                            for a, e in zip(actors, envs)], timeout=T)
        assert ranks == [0, 1]

        def run(fn, *args):
            return fabric.get([a.execute.remote(fn, *args) for a in actors],
                              timeout=T)

        yield run
        run(W.leave)
    finally:
        fabric.shutdown()
        mp.undo()


def test_world_builds_a_data_mesh(world):
    assert world(W.mesh_shape) == [[(2,), ("data",)]] * 2


_JAX_CACHE = {}


def _jax_strategy(name):
    cls, kw = {"ddp": (JDDP, {}), "horovod": (JDDP, {}), "ring": (JRing, {}),
               "zero1": (JSharded, {"zero_stage": 1}),
               "zero2": (JSharded, {"zero_stage": 2}),
               "zero3": (JSharded, {"zero_stage": 3})}[name]
    s = cls(num_workers=8, use_tpu=False, **kw)
    s.dist_env = JDistEnv(world_size=8, num_hosts=1, host_rank=0,
                          local_chips=8)
    s.mesh = s.build_mesh()
    return s


def _jax_train(name, kind, params, batches, accumulate, clip):
    """The JAX strategy's steps on the whole global batches (cached: the
    ZeRO stages 1 and 2 are one program)."""
    key = ({"zero2": "zero1", "horovod": "ddp"}.get(name, name), kind,
           accumulate)
    if key in _JAX_CACHE:
        return _JAX_CACHE[key]
    s = _jax_strategy(key[0])
    module = JBoring() if kind == "boring" else jgpt.GPTLM(JCFG,
                                                           warmup_steps=0)
    loop = JLoop(JSpec(accumulate_grad_batches=accumulate,
                       gradient_clip_val=clip), module, s, s.dist_env)
    tx = loop._wrap_optimizer(j_unpack(module.configure_optimizers())[0])
    p = s.place_params(params)
    o = s.place_opt_state(tx.init(params), params)
    step = s.compile_train_step(module, tx, log_grad_norm=True)
    logs = []
    for i, batch in enumerate(batches):
        p, o, lg = step(p, o, s.make_global_batch(batch),
                        jax.random.PRNGKey(0), i)
        logs.append({k: float(v) for k, v in lg.items()})
    out = (jax.tree_util.tree_map(np.asarray, p), logs)
    _JAX_CACHE[key] = out
    return out


def _case_data(kind, n_micro):
    rng = np.random.default_rng(7)
    if kind == "boring":
        params = {"w": (0.1 * rng.standard_normal((32, 2))).astype(np.float32),
                  "b": np.zeros((2,), np.float32)}
        batches = [rng.standard_normal((16, 32)).astype(np.float32)
                   for _ in range(n_micro)]
        return params, batches
    batches = [rng.integers(0, JCFG.vocab_size, (8, JCFG.max_seq + 1))
               .astype(np.int32) for _ in range(n_micro)]
    return W.gpt_numpy_params(GPT_CFG), batches


def _assert_tree(got, want, tol, what=""):
    if isinstance(want, dict):
        for k in want:
            _assert_tree(got[k], want[k], tol, f"{what}/{k}")
        return
    np.testing.assert_allclose(got, np.asarray(want), err_msg=what, **tol)


CASES = [(name, kind, case)
         for name in ("ddp", "horovod", "zero1", "zero2", "zero3")
         for kind in ("boring", "gpt")
         for case in ("one_step", "accumulate_clip")]


@pytest.mark.parametrize("name,kind,case", CASES)
def test_step_matches_jax(world, name, kind, case):
    """One step, or a 2-micro-batch accumulation window with global-norm
    clipping, of each strategy from the same weights and global batches:
    params, losses and the logged grad norm (of the all-reduced gradients)
    against the JAX strategy's, identical on both ranks; ZeRO ranks hold
    only their slices' optimizer state and gather the full tree; ZeRO-3
    ranks hold only their slices of the parameters between steps."""
    accumulate, clip = (1, None) if case == "one_step" else (
        2, 0.5 if kind == "boring" else 0.3)
    params, batches = _case_data(kind, accumulate)
    tol = BORING_TOL if kind == "boring" else GPT_TOL
    ranks = world(W.train_case, name, kind, params, batches, accumulate,
                  clip, GPT_CFG)
    j_params, j_logs = _jax_train(name, kind, params, batches, accumulate,
                                  clip)
    _assert_tree(ranks[0]["params"], ranks[1]["params"],
                 dict(rtol=0, atol=0), "rank 1 vs rank 0")
    _assert_tree(ranks[0]["params"], j_params, tol, "params")
    for r in ranks:
        assert len(r["logs"]) == len(j_logs)
        for got, want in zip(r["logs"], j_logs):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)
    assert ranks[0]["logs"] == ranks[1]["logs"]
    # The parameter bytes each rank holds between steps: the full leaves
    # (but the replicated ones at stage 3) and the slices of the others.
    full = slices = replicated = 0
    for x in jax.tree_util.tree_leaves(params):
        full += x.nbytes
        if shard_dim_for(x.shape, 2) is None:
            replicated += x.nbytes
        else:
            slices += x.nbytes // 2
    held = {"zero1": full + slices, "zero2": full + slices,
            "zero3": replicated + slices}.get(name, full)
    assert [r["param_bytes"] for r in ranks] == [held, held]
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert ranks[0]["whole_in_forward"] == [n_leaves] * accumulate
    if name.startswith("zero"):
        for r in ranks:
            _assert_tree(r["gathered"], ranks[0]["params"],
                         dict(rtol=0, atol=0), "gathered")
            if kind == "boring":
                continue  # plain SGD keeps no state
            # The rank's optimizer state has its slices' shapes only, and
            # the gathered state the full leaves'.
            shard = set(map(tuple, r["shard_shapes"]))
            state = set(map(tuple, r["state_shapes"]))
            full = set(np.shape(x) for x in jax.tree_util.tree_leaves(params))
            assert state and state <= shard and state != full
            assert set(map(tuple, r["full_state_shapes"])) == full


def test_zero3_frees_master_weights_before_a_cast_forward(world):
    """Under the trainer's bf16 precision the forward reads cast copies,
    so ZeRO-3 frees the fp32 leaves it sharded before the forward: the
    step is bitwise stage 1's, and holds only the replicated leaves whole
    while the forward runs."""
    params, batches = _case_data("gpt", 1)
    z1, z3 = (world(W.train_case, name, "gpt", params, batches, 1, None,
                    GPT_CFG, "bf16") for name in ("zero1", "zero3"))
    n_replicated = sum(shard_dim_for(x.shape, 2) is None
                       for x in jax.tree_util.tree_leaves(params))
    for r1, r3 in zip(z1, z3):
        _assert_tree(r3["params"], z1[0]["params"], dict(rtol=0, atol=0),
                     "zero3 vs zero1")
        assert r3["logs"] == r1["logs"]
        assert r1["whole_in_forward"] == [len(jax.tree_util.tree_leaves(
            params))]
        assert r3["whole_in_forward"] == [n_replicated]
        assert r3["param_bytes"] < r1["param_bytes"]


EVAL_MASKS = {
    "padding_rows": np.array([True] * 11 + [False] * 5),
    "a_rank_of_padding": np.array([True] * 8 + [False] * 8),
}


@pytest.mark.parametrize("mask_name", list(EVAL_MASKS))
@pytest.mark.parametrize("name,jname", [("ddp", "ddp"), ("horovod", "ring"),
                                        ("zero3", "zero3")])
def test_eval_sums_match_jax(world, name, jname, mask_name):
    """Masked validation ``(sums, count)`` over real rows only, summed
    over ranks, against the JAX strategy's eval step on the whole batch."""
    params, (x,) = _case_data("boring", 1)
    mask = EVAL_MASKS[mask_name]
    ranks = world(W.eval_case, name, params, x, mask)
    s = _jax_strategy(jname)
    sums, count = s.compile_eval_step(JBoring(), "val")(
        s.place_params(params), s.make_global_batch(x),
        s.make_global_batch(mask))
    for r in ranks:
        assert r["count"] == float(count) == float(mask.sum())
        np.testing.assert_allclose(r["sums"]["val_loss"],
                                   float(sums["val_loss"]), **BORING_TOL)


def test_distributed_validate_and_predict_match_jax(world, tmp_path):
    """The loop's validate and predict on two ranks' sampler shards of a
    37-row dataset (wrap-around padding on both the sampler and the tail
    batch): the metrics equal the JAX in-process validate's, rank 0
    returns every row's prediction once, in the rank order of the global
    batches, and each rank's callbacks see the rows it owns, which
    partition the dataset."""
    params, _ = _case_data("boring", 1)
    n, bs = 37, 4
    jm = JBoring(dataset_length=n)
    jm.params = jax.tree_util.tree_map(np.asarray, params)
    jt = JTrainer(default_root_dir=str(tmp_path), enable_checkpointing=False)
    j_metrics = jt.validate(jm)[0]
    j_preds = np.concatenate(jt.predict(jm))
    assert j_preds.shape == (n, 2)

    ranks = world(W.loop_case, "validate", params, n, bs)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["val_loss"],
                                   j_metrics["val_loss"], **BORING_TOL)

    ranks = world(W.loop_case, "predict", params, n, bs)
    # The dataset rows of each global batch, rank 0's then rank 1's.
    base = DataLoader(np.zeros((n, 1)), batch_size=bs)
    sels = [list(base.with_sampler(2, r, seed=0)._iter_selections(1))
            for r in range(2)]
    order, local = [], [[], []]
    for b in range(len(sels[0])):
        for r in range(2):
            sel, m = sels[r][b]
            order.extend(sel[m].tolist())
            local[r].extend(sel[m].tolist())
    assert sorted(order) == list(range(n))
    got = np.concatenate(ranks[0]["preds"])
    np.testing.assert_allclose(got, j_preds[order], **BORING_TOL)
    for r in range(2):
        np.testing.assert_allclose(np.concatenate(ranks[r]["local"]),
                                   j_preds[local[r]], **BORING_TOL)
        own = np.asarray(ranks[r]["owner"])
        assert own.sum() == bs and own[r * bs:(r + 1) * bs].all()
