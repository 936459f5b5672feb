"""Tensor-parallel serving on a ``"2x1"`` mesh through the n-gram
speculative engine, held against the JAX package's sharded engine
(``tests/test_serve_sharded.py:194``): both ranks bitwise equal, greedy
tokens equal to the port's single-rank engine and to the JAX engine on one
device and on a ``(4, 2)`` mesh (``tests/_torch_serve_mesh_common.py``).
"""
from tests._torch_serve_mesh_common import (  # noqa: F401 - fixture
    SHARD,
    check_mesh_case,
    reqs_of,
    world,
)


def test_mesh_spec_ngram(world):
    """``:194``: n-gram speculation under the mesh; verifies ran."""
    reqs = reqs_of(5, ((5, 7), (8, 6)))
    kw = dict(num_slots=2, max_seq=64, prefill_buckets=[8, 16],
              decode_fold=2, spec="ngram", spec_depth=3)
    r0 = check_mesh_case(world, SHARD, kw, reqs, "workload")
    assert r0["verifies"] > 0
