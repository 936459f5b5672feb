"""ZeRO-3's per-layer gathers (``parallel/zero.py:LayerGather``,
``strategies/sharded.py``, the layer loops of ``models/gpt.py`` and
``models/bert.py``) on a two-rank gloo world: the forward and the
backward hold at most two layers' gathered rows and never a full leaf, no
gradient of the whole tree is computed (each layer's is reduced into the
rank's slice, and the optimizer takes slices), and a stage-3 step is
bitwise stage 1's, with ``remat``, under the trainer's bf16 precision and
on BERT. ``tests/test_torch_strategies.py`` holds stage 3 against the JAX
ZeRO-3 step and ``tests/test_torch_gspmd_axes.py`` the fsdp axis against
the JAX GSPMD step.

The world is ``tests/test_torch_strategies.py``'s (two fabric actors,
``tests/_torch_dist_worker.py``, which imports no JAX); weights and
batches are made with numpy from a seed.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ray_lightning_tpu_torch.models.bert import BERTConfig, init_bert_params
from ray_lightning_tpu_torch.utils.tree import tree_leaves
from tests import _torch_dist_worker as W
from tests.test_torch_strategies import GPT_CFG, world  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

BERT_CFG = dataclasses.asdict(BERTConfig(vocab_size=128, n_layer=3, n_head=4,
                                         d_model=32, max_seq=32,
                                         attn_impl="reference"))


def _gpt(**overrides):
    cfg = dict(GPT_CFG, n_layer=3, **overrides)
    return cfg, W.gpt_numpy_params(cfg)


def _bert():
    """The port's BERT init from a seed, as numpy."""
    import torch

    return W._to_numpy(init_bert_params(torch.Generator().manual_seed(0),
                                        BERTConfig(**BERT_CFG)))


def _batches(vocab, seq, n, rows=4):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, (rows, seq)).astype(np.int32)
            for _ in range(n)]


PROBES = {
    "gpt": lambda: ("gpt", *_gpt(), 65),
    "gpt_remat": lambda: ("gpt", *_gpt(remat=True), 65),
    "bert": lambda: ("bert", BERT_CFG, _bert(), 32),
}


@pytest.mark.parametrize("case", list(PROBES))
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_zero3_holds_two_layers_and_no_full_gradient(world, case, precision):
    """Two steps watched on both ranks: at every gather, forward and
    backward, at most two layers' gathered rows are alive and every full
    leaf the optimizer splits has no storage; every gradient a reduction
    takes is one layer row's or one leaf's, never more; autograd is never
    asked for a split leaf's gradient; the optimizer takes gradients of
    its slices' shapes; the backward gathers again (without ``remat`` the
    saved-tensor hooks, with it the recomputed blocks)."""
    kind, cfg, params, seq = PROBES[case]()
    batches = _batches(cfg["vocab_size"], seq, 2, rows=4)
    ranks = world(W.zero3_probe, kind, params, batches, cfg, precision)
    assert ranks[0]["logs"] == ranks[1]["logs"]
    for r in ranks:
        assert 1 <= r["peak_layers"] <= 2
        assert 1 <= r["stats_peak_layers"] <= 2
        assert r["full_bytes"] == 0
        assert not r["asked_split"]
        assert r["grad_numel"] <= max(r["largest_row"],
                                      r["largest_split_leaf"])
        total = sum(x.size for x in tree_leaves(params))
        assert r["grad_numel"] < total
        assert r["taken"] == [[tuple(s) for s in r["shard_shapes"]]] * 2
        assert r["regathers"] > 0 or cfg.get("remat")
        n_layer = cfg["n_layer"]
        assert r["gathers"] >= 2 * n_layer * (2 if cfg.get("remat") else 1)


STEPS = {
    # name: (kind, config, params, sequence, micro-batches, clip, precision)
    "gpt_accumulate_clip": lambda: ("gpt", *_gpt(), 65, 2, 0.3, "fp32"),
    "gpt_remat_bf16": lambda: ("gpt", *_gpt(remat=True), 65, 1, None,
                               "bf16"),
    "bert_clip": lambda: ("bert", BERT_CFG, _bert(), 32, 1, 0.3, "fp32"),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_zero3_step_is_bitwise_zero1(world, case):
    """A stage-3 step (gathered layer by layer, each layer's gradient
    reduced into the slices, the norm from the slices) is bitwise stage
    1's (full leaves, one coalesced all-reduce) at world 2: parameters,
    losses and the logged grad norm, on both ranks."""
    kind, cfg, params, seq, accumulate, clip, precision = STEPS[case]()
    batches = _batches(cfg["vocab_size"], seq, accumulate, rows=8)
    z1, z3 = (world(W.train_case, name, kind, params, batches, accumulate,
                    clip, cfg, precision) for name in ("zero1", "zero3"))
    for r1, r3 in zip(z1, z3):
        assert r3["logs"] == r1["logs"]
        for a, b in zip(tree_leaves(r3["params"]), tree_leaves(r1["params"])):
            np.testing.assert_array_equal(a, b)
        assert r3["param_bytes"] < r1["param_bytes"]
    assert z3[0]["logs"] == z3[1]["logs"]


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_reduce_scatter_layout_hands_each_rank_its_slice(dim):
    """The NCCL path's reduce-scatter input (``blocks_first``) holds rank
    r's slice (``Split.shard`` at index r) at position r, for a split
    along any dim: what gloo's all-reduce-and-slice gives each rank."""
    from dataclasses import replace

    from ray_lightning_tpu_torch.parallel.zero import Split, blocks_first

    g = torch.arange(4 * 8 * 12, dtype=torch.float32).reshape(4, 8, 12)
    split = Split((dim,), (4,), (0,))
    stacked = blocks_first(g, split)
    for r in range(4):
        assert torch.equal(stacked[r], replace(split, index=(r,)).shard(g))
