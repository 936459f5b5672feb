"""PyTorch port, model zoo: the Hugging Face GPT-2 and Llama import
(``models/hf_import.py``) held against ``transformers`` and against the JAX
package's loader on the CPU (``tests/test_hf_import.py`` is the bar).

Every HF model is built here from ``GPT2Config`` / ``LlamaConfig`` with a
seeded random init: nothing is downloaded. Tolerances are the JAX tests'
own: 2e-4 against GPT-2's logits, 3e-4 against Llama's; the port's leaves
equal the JAX loader's exactly (both are copies of the same state dict).
"""
import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from ray_lightning_tpu.models import hf_import as jhf  # noqa: E402
from ray_lightning_tpu_torch.models import GPTLM  # noqa: E402
from ray_lightning_tpu_torch.models.gpt import gpt_forward, gpt_generate  # noqa: E402
from ray_lightning_tpu_torch.models.hf_import import (  # noqa: E402
    hf_gpt2_logits,
    load_hf_gpt2,
    load_hf_llama,
)
from ray_lightning_tpu_torch.models.weights import params_to_numpy  # noqa: E402
from ray_lightning_tpu_torch.trainer import Trainer  # noqa: E402
from ray_lightning_tpu_torch.utils.state_stream import to_state_stream  # noqa: E402

GPT2_TOL = dict(atol=2e-4, rtol=2e-4)
LLAMA_TOL = dict(atol=3e-4, rtol=3e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's thread pool in each of them
    oversubscribed the cores (see tests/test_torch_bert.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_gpt2(seed=0, **kw):
    from transformers import GPT2Config, GPT2LMHeadModel

    torch.manual_seed(seed)
    args = dict(vocab_size=96, n_positions=64, n_embd=48, n_layer=2,
                n_head=4, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    args.update(kw)
    return GPT2LMHeadModel(GPT2Config(**args))


def _tiny_llama(seed=0, kv_heads=2, tie=False):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=96, hidden_size=48, intermediate_size=80,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-5, rope_theta=10000.0, tie_word_embeddings=tie,
        attention_dropout=0.0,
    ))


def _logits(params, cfg, toks):
    with torch.no_grad():
        return gpt_forward(params, torch.from_numpy(toks).long(), cfg).numpy()


def _same_as_jax(params, cfg, j_out):
    """The port's tree equals the JAX loader's leaf for leaf, and the
    configs agree field for field."""
    j_params, j_cfg = j_out
    got = params_to_numpy(params)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, j_params))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(j_params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    import dataclasses

    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_cfg)


@pytest.mark.parametrize("family", ["gpt2", "llama_gqa", "llama_mha_tied"])
def test_logits_match_transformers_and_the_jax_loader(family):
    """``test_hf_import.py:27,113,130``: the converted tree reproduces the
    HF forward's logits (GPT-2; Llama with GQA, RMSNorm, SwiGLU, RoPE and
    an untied head; Llama MHA with a tied head, which takes the fused
    ``wqkv`` and no ``lm_head``), and equals the JAX loader's tree."""
    if family == "gpt2":
        model, load, j_load, tol = _tiny_gpt2(), load_hf_gpt2, jhf.load_hf_gpt2, GPT2_TOL
    else:
        model = (_tiny_llama() if family == "llama_gqa"
                 else _tiny_llama(kv_heads=4, tie=True))
        load, j_load, tol = load_hf_llama, jhf.load_hf_llama, LLAMA_TOL
    params, cfg = load(model, device="cpu", attn_impl="reference")
    if family == "gpt2":
        assert cfg.vocab_size == 96 and cfg.n_layer == 2 and cfg.d_ff == 4 * 48
    elif family == "llama_gqa":
        assert cfg.norm_impl == "rmsnorm" and cfg.mlp_variant == "swiglu"
        assert cfg.pos_embed == "rope" and cfg.kv_head == 2
        assert not cfg.tie_word_embeddings and "lm_head" in params
    else:
        assert cfg.tie_word_embeddings and "lm_head" not in params
        assert "wqkv" in params["blocks"]
    assert all(v.device.type == "cpu" for v in jax.tree_util.tree_leaves(params))
    toks = np.random.default_rng(1).integers(0, 96, (2, 17)).astype(np.int32)
    np.testing.assert_allclose(_logits(params, cfg, toks),
                               hf_gpt2_logits(model, toks), **tol)
    _same_as_jax(params, cfg, j_load(model, attn_impl="reference"))


def test_architecture_and_numerics_fields_locked():
    """``test_hf_import.py:66,231``: shape, structure and numerics fields
    come from the checkpoint on both loaders."""
    for bad in ({"n_layer": 4}, {"n_kv_head": 2}, {"norm_impl": "rmsnorm"},
                {"mlp_variant": "swiglu"}, {"tie_word_embeddings": False}):
        with pytest.raises(ValueError, match="cannot be overridden"):
            load_hf_gpt2(_tiny_gpt2(), device="cpu", **bad)
    with pytest.raises(ValueError, match="cannot be overridden"):
        load_hf_llama(_tiny_llama(), device="cpu", norm_impl="layernorm")


def test_unsupported_variants_and_a_bare_model_fail_fast():
    """``test_hf_import.py:74,248``: variants whose numerics the port's
    forward does not implement are rejected at import, and an untied
    checkpoint without ``lm_head`` (a bare ``LlamaModel``) names the fix."""
    from transformers import LlamaConfig, LlamaModel

    with pytest.raises(ValueError, match="activation_function"):
        load_hf_gpt2(_tiny_gpt2(activation_function="relu"), device="cpu")
    torch.manual_seed(0)
    bare = LlamaModel(LlamaConfig(
        vocab_size=48, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=32,
    ))
    with pytest.raises(ValueError, match="LlamaForCausalLM"):
        load_hf_llama(bare, device="cpu")


def test_path_like_accepted(tmp_path):
    """``test_hf_import.py:93``: a local checkpoint directory given as a
    ``Path`` loads with ``local_files_only``."""
    from pathlib import Path

    model = _tiny_gpt2()
    model.save_pretrained(str(tmp_path))
    params, cfg = load_hf_gpt2(Path(tmp_path), device="cpu",
                               attn_impl="reference")
    toks = np.random.default_rng(2).integers(0, 96, (1, 9)).astype(np.int32)
    np.testing.assert_allclose(_logits(params, cfg, toks),
                               hf_gpt2_logits(model, toks), **GPT2_TOL)


def test_llama_generate_matches_transformers_and_trains():
    """``test_hf_import.py:147,262``: greedy decode from a long prompt is
    token-identical to ``transformers``' ``generate``, its first new token
    is the forward's argmax, ``max_new_tokens=0`` returns the prompt, and
    the imported tree takes a finite training step through ``GPTLM``."""
    model = _tiny_llama(seed=11)
    params, cfg = load_hf_llama(model, device="cpu", attn_impl="reference")
    prompt = np.random.default_rng(9).integers(0, 96, (2, 23)).astype(np.int32)
    hf_out = model.generate(torch.from_numpy(prompt.astype(np.int64)),
                            max_new_tokens=6, do_sample=False).numpy()
    ours = gpt_generate(params, cfg, prompt, 6, device="cpu").numpy()
    np.testing.assert_array_equal(ours, hf_out)
    assert int(ours[0, 23]) == int(_logits(params, cfg, prompt)[0, -1].argmax())
    unchanged = gpt_generate(params, cfg, prompt, 0, device="cpu").numpy()
    np.testing.assert_array_equal(unchanged, prompt)

    module = GPTLM(config=cfg, batch_size=2, n_train=16, lr=1e-4)
    toks = np.random.default_rng(5).integers(0, 96, (2, 17)).astype(np.int32)
    loss, _ = module.training_step(params, (torch.from_numpy(toks),),
                                   torch.Generator())
    assert np.isfinite(float(loss))


def test_gpt2_into_trainer_module(tmp_path):
    """``test_hf_import.py:40``: imported weights drop into GPTLM through
    a checkpoint and keep training (loss finite, params move)."""
    params, cfg = load_hf_gpt2(_tiny_gpt2(), device="cpu",
                               attn_impl="reference")
    module = GPTLM(config=cfg, batch_size=4, n_train=64, lr=1e-4)
    before = params["wte"].clone()
    path = str(tmp_path / "hf.ckpt")
    with open(path, "wb") as f:
        f.write(to_state_stream({"params": params}))
    trainer = Trainer(max_epochs=1, enable_checkpointing=False, seed=0,
                      num_sanity_val_steps=0, limit_val_batches=1,
                      device="cpu")
    trainer.fit(module, ckpt_path=path)
    assert np.isfinite(trainer.callback_metrics["loss_epoch"])
    assert not torch.equal(module.params["wte"], before)
