"""The worker actor, the result record and the driver's result loop (the
port of ``ray_lightning_tpu/launchers/utils.py``).

Parity targets from the reference:
- ``RayExecutor`` (``launchers/utils.py:27-52``): a generic "run this
  closure" worker with env-var and node-introspection helpers.
- ``_RayOutput`` (``launchers/utils.py:55-69``): the record rank 0
  returns.
- ``process_results`` (``util.py:49-70``): the driver's wait loop, which
  polls the training futures while draining the worker-to-driver queue.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

from ray_lightning_tpu_torch import fabric


class TrainWorker:
    """Generic worker actor: env plumbing, node introspection, closure
    execution."""

    def set_env_var(self, key: str, value: str) -> None:
        os.environ[key] = str(value)

    def set_env_vars(self, keys: List[str], values: List[str]) -> None:
        for key, value in zip(keys, values):
            self.set_env_var(key, value)

    def get_node_ip(self) -> str:
        return os.environ.get("RLT_NODE_IP", "127.0.0.1")

    def get_node_id(self) -> str:
        return os.environ.get("RLT_NODE_ID", "node-0")

    def find_free_port(self) -> int:
        from ray_lightning_tpu_torch.utils.ports import find_free_port

        return find_free_port()

    def get_local_device_count(self) -> int:
        """The cards this worker sees (those the fabric gave it)."""
        import torch

        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    def execute(self, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        """Run an arbitrary closure: the actor's universal entry point."""
        return fn(*args, **kwargs)


_train_worker_cls = TrainWorker


def get_executable_cls() -> type:
    """The actor class the launcher spawns (a seam for tests, as the
    reference's ``launchers/utils.py:20-24``)."""
    return _train_worker_cls


def set_executable_cls(cls: Optional[type]) -> None:
    global _train_worker_cls
    _train_worker_cls = cls or TrainWorker


class WorkerOutput(NamedTuple):
    """What worker rank 0 ships back to the driver (``_RayOutput``).
    Weights travel as a state stream, bytes rather than a file path, so
    recovery needs no shared filesystem (``ray_launcher.py:332-336``)."""

    best_model_path: Optional[str]
    state_stream: Optional[bytes]
    trainer_state: Dict[str, Any]
    results: Any
    callback_metrics: Dict[str, Any]
    logged_metrics: Dict[str, Any]
    callback_states: Dict[str, Any]


def _handle_queue(queue: Any) -> None:
    """Run every pending (rank, closure) item of the worker queue (the
    tune queue: ROADMAP queue 1 item 14 puts items on it)."""
    if queue is None:
        return
    while not queue.empty():
        try:
            (_actor_rank, item) = queue.get_nowait()
        except Exception:  # noqa: BLE001 - drained concurrently
            return
        if callable(item):
            item()


#: Seconds to wait, once a worker has failed, for a peer's death to show:
#: a rank that dies leaves its peers failing in a collective.
DEATH_GRACE_S = 5.0


def _raise_first_error(failed: Any, others: List[Any]) -> None:
    """Raise ``failed``'s error, unless a peer died: then the death, which
    is the cause (the peers' collectives fail because of it), and which
    ``Trainer.fit``'s restart loop answers."""
    try:
        fabric.get(failed)
    except fabric.ActorDiedError:
        raise
    except Exception as exc:  # noqa: BLE001 - look for the cause first
        done, _ = fabric.wait(others, num_returns=len(others),
                              timeout=DEATH_GRACE_S)
        for ref in done:
            try:
                fabric.get(ref)
            except fabric.ActorDiedError as died:
                raise died from exc
            except Exception:  # noqa: BLE001 - another victim
                continue
        raise


def process_results(training_result_futures: List[Any],
                    queue: Any = None) -> List[Any]:
    """Wait for every worker while servicing the worker-to-driver queue
    (the reference's event loop, ``util.py:57-70``). A worker that fails
    or dies raises here at once, while its peers may still be blocked in
    a collective waiting for it: the launcher then tears them down. A
    death is reported as ``ActorDiedError`` even when a peer's failed
    collective is seen first."""
    futures = list(training_result_futures)
    not_ready = list(futures)
    while not_ready:
        _handle_queue(queue)
        ready, not_ready = fabric.wait(
            not_ready, num_returns=len(not_ready), timeout=0)
        for ref in ready:
            try:
                fabric.get(ref)
            except Exception:  # noqa: BLE001 - re-raised below
                _raise_first_error(ref, [f for f in futures if f is not ref])
        if not_ready:
            time.sleep(0.02)
    _handle_queue(queue)
    return fabric.get(futures)
