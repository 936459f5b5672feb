"""The ``GSPMDStrategy`` axes ported last (``strategies/gspmd.py``,
``parallel/zero.py``, ``models/gpt.py:chunked_lm_loss``) held against the
JAX package's ``GSPMDStrategy`` on the CPU, at the bars of
``tests/test_torch_gspmd_train.py``: parameters split over ``"data"`` by
a logical rule (with the model axis, and with fsdp splitting the same
leaves, gathered over data x fsdp), the fsdp axis gathered layer by layer,
and ``loss_chunk`` under a model axis (the vocab-parallel head).

The four-rank gloo world and the JAX strategy over 8 virtual devices come
from ``tests/_torch_gspmd_common.py``; the JAX mesh keeps the port's axes
and the data (or fsdp) axis makes up the 8, which leaves the update the
mean over the same global batch.
"""
import dataclasses

import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from tests import _torch_dist_worker as W
from tests._torch_gspmd_common import (  # noqa: F401
    CLIP,
    GPT_CFG,
    GPT_TOL,
    JCFG,
    _jax_steps,
    assert_tree,
    jax_gspmd,
    make_batches,
    world,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

N = 2  # steps per case

#: The default rules with "embed" onto "data" (and "mlp" onto "fsdp" in the
#: data x fsdp case, so both axes split ``wi`` and ``wo2``).
DATA_RULES = (("vocab", "model"), ("heads", "model"), ("mlp", "model"),
              ("embed", "data"), ("kv", None), ("layers", None))
BOTH_RULES = (("vocab", "model"), ("heads", "model"), ("mlp", "fsdp"),
              ("embed", "data"), ("kv", None), ("layers", None))

CASES = {
    # name: (port mesh, JAX mesh, rules, config overrides)
    "data_rule_model2": ({"data": 2, "model": 2}, {"data": 4, "model": 2},
                         DATA_RULES, {}),
    "data_and_fsdp_rule": ({"data": 2, "fsdp": 2}, {"data": 2, "fsdp": 4},
                           BOTH_RULES, {}),
    "fsdp4_layers": ({"fsdp": 4}, {"fsdp": 8}, None, {}),
    "loss_chunk_model2": ({"data": 2, "model": 2}, {"data": 4, "model": 2},
                          None, {"loss_chunk": 16}),
    "loss_chunk_model2_remat": ({"data": 2, "model": 2},
                                {"data": 4, "model": 2}, None,
                                {"loss_chunk": 24, "remat": True}),
}


def _jax(jshape, rules, overrides):
    kw = {} if rules is None else {"logical_axis_rules": rules}
    module = jgpt.GPTLM(dataclasses.replace(JCFG, **overrides),
                        warmup_steps=0)
    return _jax_steps(jax_gspmd(jshape, **kw), module,
                      W.gpt_numpy_params(GPT_CFG), make_batches("gpt", N),
                      CLIP)


@pytest.mark.parametrize("case", list(CASES))
def test_axes_match_jax(world, case):
    """``N`` AdamW steps with global-norm clipping: every rank's losses,
    logged grad norms and whole gathered parameters against the JAX
    strategy's on the same rules, weights and batches; every rank logs the
    same values. A leaf the rules split over ``"data"`` rests as a slice
    (the optimizer's, gathered layer by layer, at most two layers alive);
    the fsdp-only mesh gathers layer by layer too."""
    shape, jshape, rules, overrides = CASES[case]
    cfg = dict(GPT_CFG, **overrides)
    ranks = world(W.gspmd_train, shape, "gpt", W.gpt_numpy_params(GPT_CFG),
                  make_batches("gpt", N), CLIP, cfg, False,
                  None if rules is None else [list(r) for r in rules])
    snaps, j_logs = _jax(jshape, rules, overrides)
    for r in ranks:
        assert_tree(r["gathered"], snaps[N - 1], GPT_TOL, "params")
        for got, want in zip(r["logs"], j_logs):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                           **GPT_TOL)
        assert r["logs"] == ranks[0]["logs"]
    specs = ranks[0]["specs"]
    if case.startswith("data"):
        assert specs["blocks/wi"][1] == "data"
        assert specs["wte"] == (("model", "data") if "model" in shape
                                else (None, "data"))
    if case == "data_and_fsdp_rule":
        assert specs["blocks/wi"] == (None, "data", "fsdp")
        assert specs["blocks/wo2"] == (None, "fsdp", "data")
    layered = any(ax in ("data", "fsdp") for sp in specs.values()
                  for ax in sp)
    for r in ranks:
        assert r["layered"] is layered
        if layered:
            st = r["gather_stats"]
            assert 1 <= st["peak_layers"] <= 2
            # Each step: a gather per layer in the forward, the layer's
            # gradient reduced as the backward leaves it.
            assert st["gathers"] >= N * JCFG.n_layer
            assert st["reductions"] >= N * JCFG.n_layer


def test_bert_loss_chunk_under_a_model_axis_matches_the_dense_loss(world):
    """BERT's ``loss_chunk`` at data=2 x model=2 (the vocab split over the
    model group, so the chunked head is vocab-parallel) against its dense
    masked-LM loss on the same mesh, weights, batches and masks (the JAX
    package's threefry masks cannot be reproduced, so this pair is the
    port's own): losses and grad norms at ``tests/test_gpt.py:766``'s bar
    (rtol 1e-5), parameters after two clipped AdamW steps at
    ``GPT_TOL``."""
    import torch as _torch

    from ray_lightning_tpu_torch.models.bert import (
        BERTConfig,
        init_bert_params,
    )

    cfg = dataclasses.asdict(BERTConfig(vocab_size=128, n_layer=2, n_head=4,
                                        d_model=32, max_seq=32,
                                        attn_impl="reference"))
    params = W._to_numpy(init_bert_params(_torch.Generator().manual_seed(0),
                                          BERTConfig(**cfg)))
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 127, (8, 32)).astype(np.int32)
               for _ in range(N)]
    shape = {"data": 2, "model": 2}
    dense, chunked = (world(W.gspmd_train, shape, "bert", params, batches,
                            CLIP, dict(cfg, loss_chunk=c))
                      for c in (0, 8))
    assert chunked[0]["specs"]["wte"][0] == "model"
    for d, c in zip(dense, chunked):
        for got, want in zip(c["logs"], d["logs"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=k)
        assert_tree(c["gathered"], d["gathered"], GPT_TOL, "params")
