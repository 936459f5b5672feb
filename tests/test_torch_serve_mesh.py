"""Tensor-parallel serving on a ``"MODELxDATA"`` mesh, held against the JAX
package's sharded engine (``tests/test_serve_sharded.py``): the plain
workload (MHA and GQA), a data mesh, the model functions' logits, memory,
the construction checks and the spec vocabulary. The chunked, the
speculative and the fused workloads are in
``tests/test_torch_serve_mesh_chunked.py``, ``_spec.py`` and ``_fused.py``;
what the four share (the world, the weights, the references and the check every
mesh case makes) is ``tests/_torch_serve_mesh_common.py``.
"""
import numpy as np
import pytest

from ray_lightning_tpu_torch.models.gpt import GPTConfig
from ray_lightning_tpu_torch.parallel.mesh import (
    Mesh,
    mesh_from_spec,
    parse_mesh_spec,
)
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from tests import _torch_serve_mesh_worker as M
from tests._torch_serve_mesh_common import (  # noqa: F401 - fixture
    GQA,
    LOGIT_TOL,
    SHARD,
    check_mesh_case,
    port_single,
    reqs_of,
    weights,
    world,
)


@pytest.mark.parametrize("cfg_kwargs", [SHARD, GQA], ids=["mha", "gqa"])
def test_mesh_plain_workload_with_a_join(world, cfg_kwargs):
    """``test_serve_sharded.py:121``: mixed lengths and a mid-flight join
    through the split engine, bitwise the single-rank engine and both JAX
    engines."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 97, size=5).tolist(), 7),
            (rng.integers(0, 97, size=8).tolist(), 4),
            (rng.integers(0, 97, size=11).tolist(), 9)]
    join = (rng.integers(0, 97, size=6).tolist(), 5)
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=[8, 16],
              decode_fold=2)
    check_mesh_case(world, cfg_kwargs, kw, reqs, "workload", join)


def test_data_mesh_is_bitwise_the_single_rank_engine(world):
    """A ``"1x2"`` mesh: both ranks hold every head and run the same work,
    with no collective; bitwise the single-rank engine."""
    reqs = reqs_of(9, ((5, 6), (9, 5), (12, 4)))
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=[8, 16],
              decode_fold=2)
    tree, _ = weights(SHARD)
    ranks = world(M.engine_case, "1x2", SHARD, tree, kw, reqs, "workload")
    single = port_single(SHARD, kw, reqs, "workload")
    assert [r["tokens"] for r in ranks] == [single, single]
    assert [r["mesh"] for r in ranks] == ["1x2", "1x2"]


@pytest.mark.parametrize("cfg_kwargs", [SHARD, GQA], ids=["mha", "gqa"])
def test_mesh_logits_within_1e5_of_single_rank(world, cfg_kwargs):
    """The model functions on each rank's slices: the chunked prefill's
    hidden states, the decode step's and the verify's logits, dense and
    paged, within 1e-5 of the whole weights' and equal across ranks."""
    tree, _ = weights(cfg_kwargs)
    ranks = world(M.model_case, "2x1", cfg_kwargs, tree)
    whole = M.model_case(None, cfg_kwargs, tree)
    for name, want in whole.items():
        np.testing.assert_array_equal(ranks[0][name], ranks[1][name], name)
        np.testing.assert_allclose(ranks[0][name], want, err_msg=name,
                                   **LOGIT_TOL)
    np.testing.assert_array_equal(ranks[0]["step_paged"],
                                  ranks[0]["step"])
    np.testing.assert_array_equal(ranks[0]["verify_paged"],
                                  ranks[0]["verify"])


def test_mesh_memory_stats_halve_the_kv_cache(world):
    """``:221``: the KV cache's and the prefix pool's per-rank bytes are
    half the whole; the token history is whole on each rank; the registry
    exports the per-rank rows."""
    tree, _ = weights(SHARD)
    kw = dict(num_slots=2, max_seq=64, prefill_buckets=[8],
              prefill_chunk=4, prefix_blocks=4, prefix_block=4,
              spec="ngram", spec_depth=2)
    ranks = world(M.memory_case, "2x1", SHARD, tree, kw)
    single = DecodeEngine(M.to_torch(tree, SHARD), GPTConfig(**SHARD),
                          device="cpu", num_slots=2, max_seq=64,
                          prefill_buckets=[8]).memory_stats()
    for r in ranks:
        mem = r["memory"]
        for comp in ("kv_cache", "prefix_pool"):
            assert mem[comp]["bytes"] > 0
            assert mem[comp]["per_device_bytes"] == mem[comp]["bytes"] // 2
        assert (mem["token_history"]["per_device_bytes"]
                == mem["token_history"]["bytes"] > 0)
        assert mem["total"]["bytes"] == sum(
            mem[c]["bytes"] for c in ("kv_cache", "prefix_pool",
                                      "token_history"))
        assert mem["kv_cache"]["bytes"] == single["kv_cache"]["bytes"]
        assert 'component="kv_cache"' in r["text"]
        assert (r["gauges"]['rlt_serve_hbm_bytes{component="kv_cache"}']
                == mem["kv_cache"]["per_device_bytes"])
    assert (single["kv_cache"]["per_device_bytes"]
            == single["kv_cache"]["bytes"])


def test_mesh_rejects_indivisible_heads_before_allocating():
    """``:280``: a model axis that does not divide the KV heads rejects
    at construction, naming both, before the weights are cut."""
    cfg = GPTConfig(**dict(SHARD, n_kv_head=1))
    split = Mesh({"model": 2}, 0, {"model": object()}, "gloo")
    with pytest.raises(ValueError, match="model axis.*n_kv_head"):
        DecodeEngine({}, cfg, num_slots=2, max_seq=64, prefill_buckets=[8],
                     mesh=split, device="cpu")


def test_mesh_from_spec_names_the_fix_on_a_world_that_does_not_factor(
        world):
    """``:299``: a spec whose ranks are not the world's names the axis
    sizes, both counts and the fix; ``"1x1"`` needs no world."""
    for msg in world(M.mesh_error, "3x1"):
        assert "model=3" in msg and "2" in msg and "multiply" in msg
        assert "hosts_per_replica=3" in msg
    assert mesh_from_spec("1x1") is None and mesh_from_spec(None) is None


def test_parse_mesh_spec_vocabulary():
    """``:317``: the accepted forms normalize, everything else rejects
    naming the vocabulary (the JAX package's messages)."""
    assert parse_mesh_spec("4x2") == (4, 2)
    assert parse_mesh_spec("4X2") == (4, 2)
    assert parse_mesh_spec("8") == (8, 1)
    assert parse_mesh_spec(8) == (8, 1)
    assert parse_mesh_spec(None) == (1, 1)
    from ray_lightning_tpu.parallel.mesh import parse_mesh_spec as j_parse

    for bad in ("potato", "4x", "x4", "0x2", "-1x1", "4x2x1", "", True):
        with pytest.raises(ValueError, match="MODELxDATA") as got:
            parse_mesh_spec(bad)
        with pytest.raises(ValueError) as want:
            j_parse(bad)
        assert str(got.value) == str(want.value)
