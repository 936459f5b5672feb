"""Tensor-parallel serving on a ``"2x1"`` mesh through the fused
dispatch: piggybacked chunk rows and the fold ladder through the Scheduler,
held against the JAX package's sharded engine
(``tests/test_serve_sharded.py:582``): both ranks bitwise equal, greedy
tokens equal to the port's single-rank engine and to the JAX engine on one
device and on a ``(4, 2)`` mesh (``tests/_torch_serve_mesh_common.py``).
The chunked and the speculative engines are in
``tests/test_torch_serve_mesh_chunked.py`` and ``_spec.py`` (each file
its own world, so that none passes 60 s).
"""
import numpy as np

from tests._torch_serve_mesh_common import (  # noqa: F401 - fixture
    SHARD,
    check_mesh_case,
    world,
)


def test_mesh_piggyback_fold_ladder(world):
    """``:582``: piggybacked chunk rows and the fold ladder through the
    Scheduler under the mesh."""
    rng = np.random.default_rng(47)
    reqs = [(rng.integers(0, 97, size=int(rng.integers(5, 14))).tolist(),
             int(rng.integers(3, 8))) for _ in range(5)]
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=[16],
              prefill_chunk=4, decode_fold=2, piggyback_chunks=2,
              fold_ladder=[1, 2])
    r0 = check_mesh_case(world, SHARD, kw, reqs, "scheduler")
    assert r0["piggyback_rows"] > 0
