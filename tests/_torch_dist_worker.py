"""Worker-side cases of ``tests/test_torch_strategies.py``: functions a
fabric actor of a two-rank gloo world runs through
``TrainWorker.execute``. This module imports neither JAX nor the JAX
package (the actors import it by reference), and takes and returns numpy
arrays only.
"""
import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_ENV: Any = None


def join(env_kwargs: Dict[str, Any]) -> int:
    """Join this actor to the world (once per actor)."""
    global _ENV
    from ray_lightning_tpu_torch.parallel.env import DistEnv
    from ray_lightning_tpu_torch.parallel.mesh import setup_distributed

    _ENV = DistEnv(**env_kwargs)
    setup_distributed(_ENV)
    torch.set_num_threads(1)
    return _ENV.host_rank


def leave() -> None:
    from ray_lightning_tpu_torch.parallel.mesh import teardown_distributed

    teardown_distributed()


def mesh_shape() -> List[Any]:
    strategy = _strategy("ddp")
    mesh = strategy.mesh
    return [tuple(mesh.shape.values()), tuple(mesh.mesh_dim_names)]


def _strategy(name: str) -> Any:
    """A strategy of this world, attached to the group the actor already
    joined (what ``setup_worker`` does, without a second rendezvous)."""
    from ray_lightning_tpu_torch.strategies import (
        HorovodRayStrategy,
        RayShardedStrategy,
        RayStrategy,
    )

    world = _ENV.world_size
    if name == "ddp":
        s = RayStrategy(num_workers=world, use_gpu=False)
    elif name == "horovod":
        s = HorovodRayStrategy(num_workers=world, use_gpu=False)
    else:
        s = RayShardedStrategy(num_workers=world, use_gpu=False,
                               zero_stage=int(name[-1]))
    s.dist_env = _ENV
    s.device = torch.device("cpu")
    s._is_remote = True
    return s


def _module(kind: str, gpt_cfg: Optional[Dict[str, Any]]) -> Any:
    if kind == "boring":
        from ray_lightning_tpu_torch.models.boring import BoringModule

        return BoringModule()
    if kind == "bert":
        from ray_lightning_tpu_torch.models.bert import (
            BERTConfig,
            BERTEncoder,
        )

        return BERTEncoder(BERTConfig(**gpt_cfg), warmup_steps=0)
    from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig

    return GPTLM(GPTConfig(**gpt_cfg), warmup_steps=0)


def _to_numpy(tree: Any) -> Any:
    from ray_lightning_tpu_torch.utils.tree import tree_map

    # A copy: an array sharing a leaf's memory would pin its storage.
    return tree_map(lambda t: t.detach().cpu().clone().numpy(), tree)


def _from_numpy(tree: Any) -> Any:
    from ray_lightning_tpu_torch.utils.tree import tree_map

    return tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _rows(x: np.ndarray) -> np.ndarray:
    """This rank's contiguous block of a global batch's rows."""
    per = len(x) // _ENV.world_size
    return x[_ENV.host_rank * per:(_ENV.host_rank + 1) * per]


def train_case(name: str, kind: str, params: Any, batches: List[np.ndarray],
               accumulate: int, clip: Optional[float],
               gpt_cfg: Optional[Dict[str, Any]] = None,
               precision: str = "fp32") -> Dict[str, Any]:
    """Steps of one strategy on this rank's rows of each global batch in
    ``batches``, from the shared ``params``: the params after, every
    step's logs, the parameter bytes the rank holds between steps, the
    leaves whole during each forward, and (sharded strategies) the shapes
    the rank's optimizer state holds and the gathered state."""
    from ray_lightning_tpu_torch.trainer.module import unpack_optimizers
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    strategy = _strategy(name)
    module = _module(kind, gpt_cfg)
    module.precision = precision
    placed = strategy.place_params(_from_numpy(params))
    whole: List[int] = []
    forward = module.training_step

    def counted(p: Any, b: Any, g: Any) -> Any:
        whole.append(sum(bool(t.untyped_storage().nbytes())
                         for t in tree_leaves(placed)))
        return forward(p, b, g)

    module.training_step = counted
    factory, sched = unpack_optimizers(module.configure_optimizers())
    opt = strategy.make_optimizer(factory, tree_leaves(placed), sched, clip,
                                  accumulate)
    program = strategy.compile_train_step(module, opt, seed=0,
                                          log_grad_norm=True)
    logs = []
    for i, batch in enumerate(batches):
        out = program(placed, [_rows(batch)], i)
        logs.append({k: float(v[0]) for k, v in out.items()})
    # The bytes this rank holds for the parameters between steps: the full
    # leaves' storage and the slices the optimizer steps.
    storages = [t.untyped_storage() for t in
                tree_leaves(placed) + list(getattr(opt, "shards", []))]
    at_rest = {st.data_ptr(): st.nbytes() for st in storages}
    with opt.full_params():
        result = {"params": _to_numpy(placed), "logs": logs,
                  "param_bytes": sum(at_rest.values()),
                  "whole_in_forward": whole}
        if strategy.gather_is_collective:
            result["gathered"] = _to_numpy(strategy.gather_state(placed))
    if getattr(opt, "gather_stats", None) is not None:
        result["gather_stats"] = dataclasses.asdict(opt.gather_stats)
    if strategy.gather_is_collective:
        result["state_shapes"] = sorted(
            tuple(v.shape) for st in opt.opt.state.values()
            for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
        result["shard_shapes"] = [tuple(s.shape) for s in opt.shards]
        full = opt.gathered_state_dict()["optimizer"]["state"]
        result["full_state_shapes"] = sorted(
            tuple(v.shape) for st in full.values()
            for v in st.values() if torch.is_tensor(v) and v.dim() > 0)
    return result


def eval_case(name: str, params: Any, x: np.ndarray,
              mask: np.ndarray) -> Dict[str, Any]:
    """One masked validation step of ``BoringModule`` on this rank's rows:
    the (sums, count) the strategy reduced over ranks."""
    from ray_lightning_tpu_torch.models.boring import BoringModule

    strategy = _strategy(name)
    step = strategy.compile_eval_step(BoringModule(), "val")
    placed = strategy.place_params(_from_numpy(params))
    sums, count = step(placed, strategy.place_batch(_rows(x)), _rows(mask))
    return {"sums": {k: float(v) for k, v in sums.items()},
            "count": float(count)}


def loop_case(stage: str, params: Any, dataset_length: int,
              batch_size: int) -> Dict[str, Any]:
    """``TrainingLoop.run_evaluate`` / ``run_predict`` of ``BoringModule``
    on this rank's sampler shard: the metrics, or the predictions the
    rank returns (rank 0: the whole set) and the rows its callbacks got,
    with the dataset indices of the global batches in rank order."""
    from ray_lightning_tpu_torch.models.boring import BoringModule
    from ray_lightning_tpu_torch.trainer import Callback
    from ray_lightning_tpu_torch.trainer.loop import TrainerSpec, TrainingLoop

    class Rows(Callback):
        def __init__(self):
            self.rows = []

        def on_predict_batch_end(self, trainer, module, prediction, idx):
            self.rows.append(prediction.numpy())

    rows = Rows()
    module = BoringModule(dataset_length=dataset_length,
                          batch_size=batch_size)
    module.params = _from_numpy(params)
    loop = TrainingLoop(TrainerSpec(callbacks=[rows], seed=0), module,
                        _strategy("ddp"))
    if stage == "validate":
        return {"metrics": loop.run_evaluate("validate")[0]}
    preds = loop.run_predict()
    return {"preds": [p.numpy() for p in preds], "local": rows.rows,
            "owner": loop._owner_rows(2 * batch_size).tolist()}


# -- launched fits (tests/test_torch_launch.py) ------------------------------

from ray_lightning_tpu_torch.models.gpt import GPTLM, GPTConfig  # noqa: E402
from ray_lightning_tpu_torch.trainer import Callback  # noqa: E402


def gpt_numpy_params(cfg_kwargs: Dict[str, Any], seed: int = 0) -> Any:
    """The GPT's weights as numpy, made from ``seed`` (both packages'
    fits start from them)."""
    from ray_lightning_tpu_torch.models.gpt import param_shapes

    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return 1.0 + 0.1 * x if name.endswith("_g") else 0.05 * x

    return {k: ({n: leaf(n, s) for n, s in v.items()} if isinstance(v, dict)
                else leaf(k, v))
            for k, v in param_shapes(GPTConfig(**cfg_kwargs)).items()}


class SharedGPT(GPTLM):
    """``GPTLM`` on :func:`gpt_numpy_params`. ``stamp_dir``: each process
    appends the time its fit starts to ``<pid>.fit`` there. ``crash_at``:
    the first rank to reach that epoch's start (the one that creates
    ``marker``) exits the process; ``marker=None`` crashes every time."""

    def __init__(self, cfg_kwargs: Dict[str, Any], stamp_dir: str = "",
                 crash_at: int = -1, marker: Optional[str] = None,
                 **kw: Any) -> None:
        super().__init__(GPTConfig(**cfg_kwargs), **kw)
        self.cfg_kwargs = dict(cfg_kwargs)
        self.stamp_dir = stamp_dir
        self.crash_at = crash_at
        self.marker = marker

    def init_params(self, generator, batch):
        from ray_lightning_tpu_torch.models.weights import params_from_jax

        return params_from_jax(gpt_numpy_params(self.cfg_kwargs), self.config,
                               generator.device)

    def on_fit_start(self) -> None:
        import os
        import time

        if self.stamp_dir:
            with open(os.path.join(self.stamp_dir, f"{os.getpid()}.fit"),
                      "a") as f:
                f.write(f"{time.monotonic()}\n")

    def on_train_epoch_start(self, epoch: int) -> None:
        import os

        if epoch != self.crash_at:
            return
        if self.marker is not None:
            try:
                os.close(os.open(self.marker,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY))
            except FileExistsError:
                return  # the crash already happened once
        os._exit(1)


class Record(Callback):
    """Every step's loss, and the loop's ``callback_metrics`` at the fit's
    end; its state is what the driver recovers from rank 0 (and what a
    checkpoint carries into a resumed fit)."""

    def __init__(self) -> None:
        self.losses: List[float] = []
        self.metrics: Dict[str, float] = {}

    def on_train_batch_end(self, trainer, module, logs, batch_idx):
        self.losses.append(float(logs["loss"]))

    def on_fit_end(self, trainer, module):
        self.metrics = {k: float(v) for k, v in trainer.callback_metrics.items()}

    def state_dict(self) -> Dict[str, Any]:
        return {"losses": list(self.losses), "metrics": dict(self.metrics)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.losses = list(state.get("losses", []))
        self.metrics = dict(state.get("metrics", {}))


# -- tensor parallelism (tests/test_torch_gspmd.py) --------------------------


def gspmd(mesh_shape: Dict[str, int], **kw: Any) -> Any:
    """A ``GSPMDStrategy`` over this world's ranks at ``mesh_shape``,
    attached to the group the actor joined; its mesh (a collective the
    first time for a shape) is built here, on every rank at once."""
    from ray_lightning_tpu_torch.strategies import GSPMDStrategy

    s = GSPMDStrategy(num_workers=_ENV.world_size, use_gpu=False,
                      mesh_shape=mesh_shape, **kw)
    s.dist_env = _ENV
    s.device = torch.device("cpu")
    s._is_remote = True
    _ = s.mesh
    return s


def _dp_rows(x: np.ndarray, mesh: Any) -> np.ndarray:
    """The rows of a global batch this rank's data-parallel shard holds
    (contiguous blocks in shard order)."""
    per = len(x) // mesh.dp_size
    return x[mesh.dp_rank * per:(mesh.dp_rank + 1) * per]


def mesh_info(mesh_shape: Dict[str, int]) -> Dict[str, Any]:
    """This rank's coordinates and the members of its groups."""
    import torch.distributed as dist

    mesh = gspmd(mesh_shape).mesh
    groups = {}
    for name in ("data", "fsdp", "model", "dp"):
        g = mesh.group(name)
        groups[name] = (None if g is None else
                        sorted(dist.get_process_group_ranks(g)))
    return {"coords": mesh.coords, "groups": groups, "dp_rank": mesh.dp_rank}


def collectives(mesh_shape: Dict[str, int]) -> Dict[str, Any]:
    """``parallel/mesh.py``'s all-gather over this rank's model group, as
    it is and staged through host buffers (the path a CUDA tensor takes
    on gloo)."""
    from ray_lightning_tpu_torch.parallel import mesh as pmesh

    mesh = gspmd(mesh_shape).mesh
    group, m = mesh.group("model"), mesh.size("model")
    mine = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * _ENV.host_rank
    out = {}
    saved = pmesh._staged
    try:
        for staged in (False, True):
            if staged:
                pmesh._staged = lambda t, g: True
            buf = torch.empty((2 * m, 3))
            pmesh.all_gather(buf, mine, group)
            out[f"gather_staged={staged}"] = buf.numpy()
    finally:
        pmesh._staged = saved
    return out


def tp_forward(mesh_shape: Dict[str, int], gpt_cfg: Dict[str, Any],
               params: Any, tokens: np.ndarray) -> Dict[str, Any]:
    """The GPT's logits on this rank's data-parallel rows, from its slices
    of ``params``: the rows' indices and the logits."""
    s = gspmd(mesh_shape)
    module = _module("gpt", gpt_cfg)
    s.bind_module(module)
    placed = s.place_params(_from_numpy(params))
    rows = _dp_rows(tokens, s.mesh)
    with torch.no_grad():
        logits = module._forward(placed, torch.as_tensor(rows).long())
    return {"dp_rank": s.mesh.dp_rank, "logits": logits.numpy(),
            "wte_rows": int(placed["wte"].shape[0])}


def gspmd_train(mesh_shape: Dict[str, int], kind: str, params: Any,
                batches: List[np.ndarray], clip: Optional[float],
                gpt_cfg: Optional[Dict[str, Any]] = None,
                staged: bool = False, rules: Any = None) -> Dict[str, Any]:
    """Steps of ``GSPMDStrategy`` on this rank's data-parallel rows of each
    global batch: every step's logs, the whole parameters gathered after,
    this rank's replicated leaves as it holds them, and the shapes its
    optimizer state holds. ``staged``: every all-gather goes through host
    buffers (the path CUDA tensors take on gloo); ``rules``: the logical-
    axis rules (the default's when None)."""
    from ray_lightning_tpu_torch.parallel import mesh as pmesh
    from ray_lightning_tpu_torch.strategies.gspmd import _spec_leaves
    from ray_lightning_tpu_torch.trainer.module import unpack_optimizers
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    s = gspmd(mesh_shape, logical_axis_rules=rules)
    module = _module(kind, gpt_cfg)
    module.precision = "fp32"
    s.bind_module(module)
    saved = pmesh._staged
    if staged:
        pmesh._staged = lambda t, g: True
    try:
        placed = s.place_params(_from_numpy(params))
        factory, sched = unpack_optimizers(module.configure_optimizers())
        opt = s.make_optimizer(factory, tree_leaves(placed), sched, clip, 1)
        program = s.compile_train_step(module, opt, seed=0,
                                       log_grad_norm=True)
        logs = []
        for i, batch in enumerate(batches):
            out = program(placed, [_dp_rows(batch, s.mesh)], i)
            logs.append({k: float(v[0]) for k, v in out.items()})
        with opt.full_params():
            gathered = _to_numpy(s.gather_state(placed))
            replicated = {}
            for (path, leaf), spec in zip(_paths(placed),
                                          _spec_leaves(s._param_specs)):
                if all(ax is None for ax in spec):
                    replicated[path] = leaf.detach().clone().numpy()
        full_state = opt.gathered_state_dict()["optimizer"]["state"]
    finally:
        pmesh._staged = saved
    stats = getattr(opt, "gather_stats", None)
    return {
        "logs": logs, "gathered": gathered, "replicated": replicated,
        "coords": s.mesh.coords, "layered": opt.layered,
        "gather_stats": None if stats is None else dataclasses.asdict(stats),
        "specs": {p: sp for (p, _), sp in zip(_paths(placed),
                                              _spec_leaves(s._param_specs))},
        "shard_shapes": [tuple(t.shape) for t in opt.shards],
        "state_shapes": sorted(tuple(v.shape) for st in opt.opt.state.values()
                               for v in st.values()
                               if torch.is_tensor(v) and v.dim() > 0),
        "full_state_shapes": sorted(tuple(v.shape) for st in full_state.values()
                                    for v in st.values()
                                    if torch.is_tensor(v) and v.dim() > 0),
    }


def _paths(tree: Any, prefix: str = "") -> List[Any]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out.extend(_paths(v, f"{prefix}{k}/"))
        else:
            out.append((prefix + k, v))
    return out


def zero3_train(params: Any, batches: List[np.ndarray], staged: bool,
                gpt_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """``RayShardedStrategy(zero_stage=3)`` steps on this rank's rows, its
    gathers host-staged or not: the logs and the gathered parameters."""
    from ray_lightning_tpu_torch.parallel import mesh as pmesh

    saved = pmesh._staged
    if staged:
        pmesh._staged = lambda t, g: True
    try:
        out = train_case("zero3", "gpt", params, batches, 1, None, gpt_cfg)
    finally:
        pmesh._staged = saved
    return {"logs": out["logs"], "gathered": out["gathered"]}


def gspmd_save_sharded(mesh_shape: Dict[str, int], params: Any,
                       batches: List[np.ndarray], gpt_cfg: Dict[str, Any],
                       path: str) -> Dict[str, Any]:
    """Train on ``mesh_shape``, write a sharded checkpoint of the state
    from every rank, and return the whole (gathered) state."""
    from ray_lightning_tpu_torch.trainer.checkpoint_io import (
        ShardedCheckpointIO,
    )
    from ray_lightning_tpu_torch.trainer.module import unpack_optimizers
    from ray_lightning_tpu_torch.utils.tree import tree_leaves, tree_map

    s = gspmd(mesh_shape)
    module = _module("gpt", gpt_cfg)
    s.bind_module(module)
    placed = s.place_params(_from_numpy(params))
    factory, sched = unpack_optimizers(module.configure_optimizers())
    opt = s.make_optimizer(factory, tree_leaves(placed), sched, 0.3, 1)
    program = s.compile_train_step(module, opt, seed=0)
    for i, batch in enumerate(batches):
        program(placed, [_dp_rows(batch, s.mesh)], i)
    skeleton, pieces = opt.sharded_state()
    refs = iter(skeleton["params"])
    skeleton["params"] = tree_map(lambda _: next(refs), placed)
    ShardedCheckpointIO().save(path, skeleton, pieces, s.ckpt_layout(),
                               {"global_step": len(batches)},
                               is_rank_zero=_ENV.host_rank == 0,
                               barrier=s.barrier)
    with opt.full_params():
        params_full = s.gather_state(placed)
    return {"params": _to_numpy(params_full),
            "opt": _state_numpy(opt.gathered_state_dict())}


def _state_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer's whole state's tensors by (index, key), as numpy."""
    return {f"{idx}/{k}": v.detach().cpu().clone().numpy()
            for idx, st in state["optimizer"]["state"].items()
            for k, v in st.items() if torch.is_tensor(v)}


def gspmd_restore_sharded(mesh_shape: Dict[str, int], path: str,
                          gpt_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Restore a sharded checkpoint onto ``mesh_shape`` (place the whole
    parameters, load the whole optimizer state) and return the state
    gathered whole again."""
    from ray_lightning_tpu_torch.trainer.checkpoint_io import (
        ShardedCheckpointIO,
    )
    from ray_lightning_tpu_torch.trainer.module import unpack_optimizers
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    s = gspmd(mesh_shape)
    module = _module("gpt", gpt_cfg)
    s.bind_module(module)
    state, meta = ShardedCheckpointIO().restore(path)
    placed = s.place_params(state["params"])
    factory, sched = unpack_optimizers(module.configure_optimizers())
    opt = s.make_optimizer(factory, tree_leaves(placed), sched, 0.3, 1)
    opt.load_state_dict(state["opt_state"])
    with opt.full_params():
        params_full = s.gather_state(placed)
    return {"params": _to_numpy(params_full),
            "opt": _state_numpy(opt.gathered_state_dict()),
            "step": meta.get("global_step")}


def gspmd_fit(mesh_shape: Dict[str, int], gpt_cfg: Dict[str, Any],
              root: str, epochs: int, ckpt: Optional[str] = None,
              async_ckpt: bool = False, fold: int = 1) -> Dict[str, Any]:
    """``TrainingLoop.run_fit`` of ``SharedGPT`` under ``GSPMDStrategy`` on
    this world, with ``ModelCheckpoint(save_sharded=True, save_last=True)``
    under ``root``, from scratch or from the sharded checkpoint ``ckpt``:
    the last checkpoint's path, the losses and the gathered params."""
    import os

    from ray_lightning_tpu_torch.trainer import ModelCheckpoint
    from ray_lightning_tpu_torch.trainer.loop import TrainerSpec, TrainingLoop

    s = gspmd(mesh_shape)
    module = SharedGPT(gpt_cfg, batch_size=8 // s.mesh.dp_size,
                       n_train=16, warmup_steps=2)
    record = Record()
    ck = ModelCheckpoint(dirpath=os.path.join(root, "ckpts"),
                         save_sharded=True, save_last=True)
    spec = TrainerSpec(max_epochs=epochs, seed=0, log_every_n_steps=1,
                       limit_val_batches=0, num_sanity_val_steps=0,
                       enable_model_summary=False, default_root_dir=root,
                       async_checkpointing=async_ckpt,
                       steps_per_execution=fold,
                       callbacks=[record, ck])
    loop = TrainingLoop(spec, module, s)
    loop.run_fit(None if ckpt is None else {"sharded_path": ckpt})
    with loop.full_params():
        params_full = s.gather_state(loop.params)
    return {"last": ck.last_model_path, "losses": record.losses,
            "params": _to_numpy(params_full), "step": loop.global_step}


def gspmd_eval(mesh_shape: Dict[str, int], gpt_cfg: Dict[str, Any],
               params: Any) -> Dict[str, Any]:
    """``TrainingLoop``'s validate and predict of ``SharedGPT`` under
    ``GSPMDStrategy``: the metrics, the predictions this rank returns
    (rank 0: the whole set) and the rows its callbacks own."""
    from ray_lightning_tpu_torch.trainer.data import DataLoader
    from ray_lightning_tpu_torch.trainer.loop import TrainerSpec, TrainingLoop

    class Predicting(SharedGPT):
        def predict_dataloader(self):
            return DataLoader(self._data(), batch_size=self.batch_size)

    class Rows(Callback):
        def __init__(self):
            self.rows = 0

        def on_predict_batch_end(self, trainer, module, prediction, idx):
            self.rows += len(prediction)

    s = gspmd(mesh_shape)
    module = Predicting(gpt_cfg, batch_size=4 // s.mesh.dp_size, n_train=12)
    module.params = _from_numpy(params)
    rows = Rows()
    spec = TrainerSpec(seed=0, callbacks=[rows], limit_val_batches=1)
    metrics = TrainingLoop(spec, module, s).run_evaluate("validate")[0]
    preds = TrainingLoop(spec, module, s).run_predict()
    return {"metrics": metrics, "preds": [p.numpy() for p in preds],
            "rows": rows.rows}


def zero3_probe(kind: str, params: Any, batches: List[np.ndarray],
                cfg: Dict[str, Any], precision: str = "fp32") -> Dict[str, Any]:
    """ZeRO-3 steps on this rank's rows, watched: at every per-layer
    gather (forward and backward) the layers whose gathered rows are
    alive and the full leaves holding storage; every gradient a layer's
    backward hands its reduction (the largest, against the largest row of
    a stacked leaf); the tensors the step asks autograd for; the shapes of
    the gradients the optimizer takes (against its slices')."""
    from ray_lightning_tpu_torch.parallel import zero
    from ray_lightning_tpu_torch.trainer.module import unpack_optimizers
    from ray_lightning_tpu_torch.utils.tree import tree_leaves

    strategy = _strategy("zero3")
    module = _module(kind, cfg)
    module.precision = precision
    placed = strategy.place_params(_from_numpy(params))
    leaves = tree_leaves(placed)
    factory, sched = unpack_optimizers(module.configure_optimizers())
    opt = strategy.make_optimizer(factory, leaves, sched, 0.3, 1)
    program = strategy.compile_train_step(module, opt, seed=0,
                                          log_grad_norm=True)
    seen: Dict[str, Any] = {"layers": [], "full_bytes": [], "grad_numel": 0,
                            "asked": [], "taken": []}
    gather, reduce_, grad, take = (zero.LayerGather._gather,
                                   zero.LayerGather._reduce,
                                   torch.autograd.grad, opt.take)

    def watched_gather(self, key):
        out = gather(self, key)
        seen["layers"].append(len(self._live) + (key[0] == "row"))
        seen["full_bytes"].append(sum(t.untyped_storage().nbytes()
                                      for t, sp in zip(leaves, opt.splits)
                                      if sp is not None))
        return out

    def watched_reduce(self, key, grads):
        seen["grad_numel"] = max([seen["grad_numel"]]
                                 + [g.numel() for g in grads])
        return reduce_(self, key, grads)

    def watched_grad(outputs, inputs, *a, **kw):
        seen["asked"].append([id(t) for t in inputs])
        return grad(outputs, inputs, *a, **kw)

    def watched_take(grads, *a, **kw):
        seen["taken"].append([tuple(g.shape) for g in grads])
        return take(grads, *a, **kw)

    zero.LayerGather._gather = watched_gather
    zero.LayerGather._reduce = watched_reduce
    torch.autograd.grad = watched_grad
    opt.take = watched_take
    try:
        logs = []
        for i, batch in enumerate(batches):
            out = program(placed, [_rows(batch)], i)
            logs.append({k: float(v[0]) for k, v in out.items()})
    finally:
        zero.LayerGather._gather = gather
        zero.LayerGather._reduce = reduce_
        torch.autograd.grad = grad
    split_ids = {id(t) for t, sp in zip(leaves, opt.splits) if sp is not None}
    rows = [int(np.prod(t.shape[1:])) for t, sp in zip(leaves, opt.splits)
            if sp is not None and t.dim() > 1 and 0 not in sp.dims]
    return {
        "logs": logs,
        "peak_layers": max(seen["layers"]),
        "stats_peak_layers": opt.gather_stats.peak_layers,
        "full_bytes": max(seen["full_bytes"]),
        "grad_numel": seen["grad_numel"],
        "largest_split_leaf": max(t.numel() for t, sp in
                                  zip(leaves, opt.splits) if sp is not None),
        "largest_row": max(rows),
        "asked_split": any(i in split_ids for ids in seen["asked"]
                           for i in ids),
        "taken": seen["taken"],
        "shard_shapes": [tuple(s.shape) for s in opt.shards],
        "regathers": opt.gather_stats.regathers,
        "gathers": opt.gather_stats.gathers,
    }
