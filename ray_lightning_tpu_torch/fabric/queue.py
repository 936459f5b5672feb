"""Cross-process queue for worker -> driver messaging (PyTorch port of
``ray_lightning_tpu/fabric/queue.py``).

Fabric-native stand-in for ``ray.util.queue.Queue`` — the channel the
reference uses to ship Tune callback closures from worker rank 0 back to the
trial driver (ray_launcher.py:101-103, session.py:17-24, util.py:49-54).
Backed by a multiprocessing.Manager queue so the proxy is picklable and can be
handed to actors at spawn time.
"""
from __future__ import annotations

import queue as _queue
from typing import Any, Optional

from ray_lightning_tpu_torch.fabric import core


class Queue:
    def __init__(self, maxsize: int = 0) -> None:
        sess = core._require_session()
        self._q = sess.manager.Queue(maxsize)
        self._closed = False

    def put(self, item: Any, block: bool = True, timeout: Optional[float] = None) -> None:
        # cloudpickle framing: Manager queues use plain pickle internally,
        # which rejects the closures/lambdas this channel exists to carry
        # (tune report closures, session.py contract).
        import cloudpickle

        self._q.put(cloudpickle.dumps(item), block, timeout)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        import cloudpickle

        return cloudpickle.loads(self._q.get(block, timeout))

    def get_nowait(self) -> Any:
        import cloudpickle

        return cloudpickle.loads(self._q.get_nowait())

    def empty(self) -> bool:
        try:
            return self._q.empty()
        except (EOFError, BrokenPipeError, ConnectionError):
            return True

    def qsize(self) -> int:
        return self._q.qsize()

    def shutdown(self) -> None:
        # Manager-backed queues are reclaimed with the manager; just mark closed.
        self._closed = True

    def __getstate__(self) -> dict:
        return {"_q": self._q, "_closed": self._closed}

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)


Empty = _queue.Empty
Full = _queue.Full
