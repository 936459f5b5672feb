"""A tensor-parallel gang's KV plane and store (``serve/engine.py``: the
split engine's exports gather every rank's heads of each block over the
model group, its imports keep each rank's heads), held on the CPU against
the solo ``gpt_generate`` and the JAX package's mesh cases of
``tests/test_kvfleet.py`` (``:498`` disaggregated over a split, decode side
exact; ``:1219`` a layer-wise ship from a split falls back to the whole
prompt, exact), and a round trip through the KV object store between a
split engine and an unsplit one.

The two-rank gloo world is ``tests/_torch_serve_mesh_common.py``'s: each
rank builds the same engines (``"2x1"``: half the heads each) and drives
them with the same op stream, so their head gathers pair up
(``tests/_torch_serve_mesh_worker.py``, JAX-free). fp32 weights under
``attn_impl="reference"``: greedy tokens are exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu_torch.models import gpt as tgpt
from tests import _torch_serve_mesh_worker as M
from tests._torch_serve_mesh_common import SHARD, weights, world  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BLOCK = 4
KINDS = {
    "dense": dict(num_slots=3, max_seq=64, prefill_buckets=[16],
                  prefill_chunk=4, prefix_blocks=16, prefix_block=BLOCK,
                  decode_fold=2),
    "paged": dict(num_slots=3, max_seq=64, prefill_buckets=[16],
                  prefill_chunk=4, kv_page=BLOCK, kv_pages=48, decode_fold=2),
}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, SHARD["vocab_size"],
                                                size=n).tolist()


def _solo(prompt, n):
    """The port's and the JAX package's solo greedy runs (equal)."""
    import jax.numpy as jnp

    tree, jparams = weights(SHARD)
    cfg = tgpt.GPTConfig(**SHARD)
    mine = tgpt.gpt_generate(M.to_torch(tree, SHARD), cfg, [prompt], n,
                             device="cpu")[0].tolist()[len(prompt):]
    ref = jgpt.gpt_generate(jparams, jgpt.GPTConfig(**SHARD),
                            jnp.asarray([prompt]), n)
    assert np.asarray(ref)[0, len(prompt):].tolist() == mine
    return mine


CASES = {
    # name: (prefill engine's mesh, decode engine's, kind, layer-wise)
    "split_to_whole_paged": ("2x1", None, "paged", False),
    "whole_to_split_dense": (None, "2x1", "dense", False),
    "split_to_split_paged": ("2x1", "2x1", "paged", False),
    "split_layerwise_falls_back": ("2x1", None, "paged", True),
    "layerwise_into_split": (None, "2x1", "dense", True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gang_disagg_ship_is_exact(world, case):
    """Prefill on engine 0, ship, decode on engine 1: engine 0 emits the
    first token and a ``shipped`` terminal; engine 1 imports the shipped
    blocks, admits warm and emits the solo stream. A split sender's
    blocks are whole (its gather moved every rank's heads); a layer-wise
    plane on a split sender ships the whole prompt (its layer counters
    stay 0, as the JAX package's mesh payloads fall back); an unsplit
    sender's layer-wise ship lands in a split receiver layer by layer."""
    spec_a, spec_b, kind, layerwise = CASES[case]
    prompt, n = _prompt(23 + len(case), 13), 6
    tree, _ = weights(SHARD)
    r0, r1 = world(M.gang_disagg_case, SHARD, tree, KINDS[kind],
                   [spec_a, spec_b], prompt, n, layerwise)
    assert r0 == r1  # the ranks emit and count the same
    assert r0["split"] == (spec_a is not None, spec_b is not None)
    # On gloo and the CPU nothing is captured, before the traffic or by it
    # (the JAX test's compiles_since_init == 0).
    assert r0["compiled"] == [0, 0]
    assert r0["done"] == [("shipped", 1)] and len(r0["first"]) == 1
    full = _solo(prompt, n)
    assert r0["full"] == full and r0["first"][0] == full[0]
    assert r0["ships"] == 1 and r0["hit_tokens"] > 0
    n_blocks = len(prompt) // BLOCK
    assert r0["exports"] == n_blocks
    sender_layers = layerwise and spec_a is None
    assert r0["layer_ships"] == int(sender_layers)
    assert r0["layer_ship_messages"] == (SHARD["n_layer"] if sender_layers
                                         else 0)
    if sender_layers:
        assert r0["layer_block_imports"] == n_blocks
    else:
        assert r0["imports"] == n_blocks and r0["layer_block_imports"] == 0
    # The ship carries whole blocks: an unsplit engine's bytes.
    cfg = tgpt.GPTConfig(**SHARD)
    whole = 2 * cfg.n_layer * BLOCK * cfg.kv_head * cfg.head_dim * 4
    assert r0["ship_bytes"] == n_blocks * whole
    if spec_a is not None:
        assert r0["gather_bytes"][0] >= n_blocks * whole


def test_gang_store_round_trip(world, tmp_path):
    """A split engine's evicted chain reaches the store whole (gathered
    on both ranks, written by rank 0) and an unsplit engine serves it
    warm; an unsplit engine's chain in the store is imported by the split
    engine (each rank its heads) and served warm; the split engine's
    export of that chain is the unsplit engine's, bitwise. Every stream
    equals the solo run."""
    # A host tier smaller than one block: every spilled block falls
    # through to the store.
    kw = dict(KINDS["dense"], prefix_blocks=3, prefill_chunk=0,
              prefix_host_mb=0.0001)
    prompts = [_prompt(s, 13) for s in (71, 72, 73)]
    n = 5
    tree, _ = weights(SHARD)
    r0, r1 = world(M.gang_store_case, SHARD, tree, kw, "2x1", prompts, n,
                   str(tmp_path / "store"))
    assert (r0["writer"], r1["writer"]) == (True, False)
    for key in ("split_cold", "whole_warm", "split_warm", "stored",
                "imported_whole", "imported_split", "whole_hits",
                "split_hits", "export_bitwise"):
        assert r0[key] == r1[key], key
    solo = [_solo(p, n) for p in prompts]
    assert r0["split_cold"] == {"r0": solo[0], "r1": solo[1]}
    assert r0["stored"] == r0["imported_whole"] == 3
    assert r0["whole_warm"] == {"r0": solo[0]} and r0["whole_hits"] == 12
    assert r0["imported_split"] == 3
    assert r0["split_warm"] == {"r0": solo[2]} and r0["split_hits"] == 12
    assert r0["export_bitwise"] is True
    assert r0["gather_bytes"] > 0
