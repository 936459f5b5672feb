"""Tensor-parallel serving on a ``"2x1"`` mesh through the chunked,
prefix-cached engine, held against the JAX package's sharded engine
(``tests/test_serve_sharded.py:159``): both ranks bitwise equal, greedy
tokens equal to the port's single-rank engine and to the JAX engine on one
device and on a ``(4, 2)`` mesh (``tests/_torch_serve_mesh_common.py``).
"""
import numpy as np

from tests._torch_serve_mesh_common import (  # noqa: F401 - fixture
    SHARD,
    check_mesh_case,
    world,
)


def test_mesh_chunked_prefix_hit(world):
    """``:159``: chunked prefill and a prefix-pool hit under the mesh: the
    suffix seeds from this rank's half of the pool blocks."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 97, size=8).tolist()
    reqs = [(prefix + rng.integers(0, 97, size=3).tolist(), 6),
            (prefix + rng.integers(0, 97, size=5).tolist(), 7),
            (rng.integers(0, 97, size=20).tolist(), 5)]
    kw = dict(num_slots=2, max_seq=64, prefill_buckets=[8, 16],
              prefill_chunk=4, prefix_blocks=8, prefix_block=4,
              decode_fold=2)
    r0 = check_mesh_case(world, SHARD, kw, reqs, "one_by_one")
    assert r0["hit_tokens"] >= len(prefix)
