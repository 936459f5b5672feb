"""Worker-side cases of ``tests/test_torch_strategies.py``: functions a
fabric actor of a two-rank gloo world runs through
``TrainWorker.execute``. This module imports neither JAX nor the JAX
package (the actors import it by reference), and takes and returns numpy
arrays only.
"""
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
    return [tuple(mesh.shape), tuple(mesh.mesh_dim_names)]


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
