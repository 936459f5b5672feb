"""PyTorch port, GPT serving half: the weight bridge, prefill, cached decode,
generate and the sampling filters held against the JAX package on the CPU.

Weights and inputs are made with numpy and cross over as numpy arrays (the
JAX functions run jitted, so each config compiles once). fp32 throughout: prefill hidden
states, K/V and decode logits agree at 1e-4, greedy tokens exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy

TOL = dict(atol=1e-4, rtol=1e-4)

#: GPT-2-shaped (learned positions, gelu, layernorm, MHA, tied head),
#: llama()-shaped (rope, rmsnorm, swiglu, GQA, untied head), and a
#: sliding window with sinks.
CONFIGS = {
    "gpt2": jgpt.GPTConfig(
        vocab_size=128, n_layer=2, n_head=4, d_model=32, max_seq=64
    ),
    "llama": jgpt.GPTConfig.llama(
        vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
        max_seq=64,
    ),
    "window_sinks": jgpt.GPTConfig(
        vocab_size=128, n_layer=2, n_head=4, d_model=32, max_seq=64,
        attn_window=6, attn_sinks=2,
    ),
}


def _torch_cfg(cfg):
    return tgpt.GPTConfig(**dataclasses.asdict(cfg))


_prefill = jax.jit(jgpt.gpt_prefill, static_argnums=1)
_decode_step = jax.jit(jgpt.gpt_decode_step, static_argnums=1)
_generate = jax.jit(jgpt.gpt_generate, static_argnums=(1, 3))


def _numpy_params(cfg, seed=0):
    """A parameter tree in the JAX layout, from numpy: random weights,
    biases and norm gains (so every bias and gain path is exercised)."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        x = rng.standard_normal(shape).astype(np.float32)
        if name.endswith("_g"):
            return 1.0 + 0.1 * x
        return 0.02 * x

    return {
        k: (
            {n: leaf(n, s) for n, s in v.items()}
            if isinstance(v, dict)
            else leaf(k, v)
        )
        for k, v in tgpt.param_shapes(_torch_cfg(cfg)).items()
    }


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    cfg = CONFIGS[request.param]
    np_params = _numpy_params(cfg)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    t_cfg = _torch_cfg(cfg)
    return cfg, j_params, t_cfg, params_from_jax(np_params, t_cfg, "cpu")


def test_weight_bridge_round_trips(model):
    cfg, j_params, t_cfg, t_params = model
    back = params_to_numpy(t_params)
    flat_j = jax.tree_util.tree_leaves_with_path(j_params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], np.asarray(leaf))
    # The JAX init's tree, the bridge's expected tree and the port's own
    # init agree leaf for leaf, shape for shape.
    jax_shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg)),
    )
    mine = tgpt.init_gpt_params(torch.Generator().manual_seed(0), t_cfg)
    assert jax.tree_util.tree_map(np.shape, params_to_numpy(mine)) == jax_shapes
    assert jax.tree_util.tree_map(np.shape, back) == jax_shapes


def test_weight_bridge_refuses_bad_trees(model):
    cfg, j_params, t_cfg, _ = model
    np_params = _numpy_params(cfg)
    bad = dict(np_params, wte=np_params["wte"][:, :-1])
    with pytest.raises(ValueError, match="wte"):
        params_from_jax(bad, t_cfg, "cpu")
    # An int8 node converts (q int8, s fp32, shapes kept); a malformed one
    # (q not int8 of the leaf's shape, or scales that do not broadcast) is
    # refused naming its leaf.
    wo = np_params["blocks"]["wo"]
    s = np.abs(wo).max(axis=(1, 2), keepdims=True) / 127.0
    q = np.clip(np.round(wo / s), -127, 127).astype(np.int8)
    blocks = dict(np_params["blocks"], wo={"q": q, "s": s})
    out = params_from_jax(dict(np_params, blocks=blocks), t_cfg, "cpu")
    node = out["blocks"]["wo"]
    assert node["q"].dtype == torch.int8 and node["s"].dtype == torch.float32
    assert tuple(node["q"].shape) == wo.shape
    assert tuple(node["s"].shape) == s.shape
    for bad_node in ({"q": 0, "s": 1}, {"q": q.astype(np.int32), "s": s},
                     {"q": q, "s": s[:, :, :, :1].repeat(2, 3)}):
        blocks = dict(np_params["blocks"], wo=bad_node)
        with pytest.raises(ValueError, match="wo"):
            params_from_jax(dict(np_params, blocks=blocks), t_cfg, "cpu")


def test_prefill_and_decode_step_match_jax(model):
    cfg, j_params, t_cfg, t_params = model
    rng = np.random.default_rng(0)
    B, P, S = 2, 16, 32
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jh, jk, jv = _prefill(j_params, cfg, jnp.asarray(prompt))
    with torch.inference_mode():
        th, tk, tv = tgpt.gpt_prefill(
            t_params, t_cfg, torch.from_numpy(prompt).long()
        )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)

    # One decode step at different per-slot positions over caches holding
    # the prefill's K/V (stale rows past each position must stay masked).
    L, Hkv, hd = cfg.n_layer, cfg.kv_head, cfg.head_dim
    kc = np.zeros((L, B, S, Hkv, hd), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :P], vc[:, :, :P] = np.asarray(jk), np.asarray(jv)
    cur = rng.integers(0, cfg.vocab_size, B).astype(np.int32)
    pos = np.array([P, P - 5], np.int32)
    jl, jkc, jvc = _decode_step(
        j_params, cfg, jnp.asarray(cur), jnp.asarray(pos), jnp.asarray(kc),
        jnp.asarray(vc),
    )
    with torch.inference_mode():
        tl, tkc, tvc = tgpt.gpt_decode_step(
            t_params, t_cfg, torch.from_numpy(cur).long(),
            torch.from_numpy(pos).long(), torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()),
        )
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tkc.numpy(), np.asarray(jkc), **TOL)
    np.testing.assert_allclose(tvc.numpy(), np.asarray(jvc), **TOL)


def test_generate_greedy_tokens_match_jax(model):
    cfg, j_params, t_cfg, t_params = model
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    ref = np.asarray(_generate(j_params, cfg, jnp.asarray(prompt), 12))
    out = tgpt.gpt_generate(t_params, t_cfg, prompt, 12, device="cpu")
    np.testing.assert_array_equal(out.numpy(), ref)


def _jax_support_sizes(logits, temps, top_ks, top_ps, monkeypatch):
    """Tokens each row of the JAX batched sampler can draw, counted from
    the filtered logits it hands to ``jax.random.categorical``."""
    monkeypatch.setattr(
        jax.random,
        "categorical",
        lambda key, lg: jnp.sum(jnp.isfinite(lg)).astype(jnp.int32),
    )
    keys = jax.random.split(jax.random.PRNGKey(0), logits.shape[0])
    with jax.disable_jit():
        return np.asarray(
            jgpt.sample_logits_batched(
                keys, jnp.asarray(logits), jnp.asarray(temps),
                jnp.asarray(top_ks), jnp.asarray(top_ps),
            )
        )


def test_sampling_filters_keep_jax_support(monkeypatch):
    """Same logits, same knobs: the port keeps the same tokens as JAX. The
    draws themselves differ by design (the port's counter-based draw is not
    threefry)."""
    rng = np.random.default_rng(2)
    V = 96
    logits = (rng.standard_normal((5, V)) * 3).astype(np.float32)
    temps = np.array([0.7, 1.0, 0.8, 1.3, 0.9], np.float32)
    top_ks = np.array([0, 10, 50, 0, 1], np.int32)
    top_ps = np.array([0.9, 1.0, 0.5, 0.3, 0.9], np.float32)
    jax_sizes = _jax_support_sizes(logits, temps, top_ks, top_ps, monkeypatch)
    filtered = tgpt.filter_logits_batched(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks).long(), torch.from_numpy(top_ps),
    )
    kept = torch.isfinite(filtered).numpy()
    np.testing.assert_array_equal(kept.sum(-1), jax_sizes)
    # Both filters keep a top set by logit value: equal sizes are equal sets.
    for row, n in zip(range(5), jax_sizes):
        top = np.argsort(-logits[row], kind="stable")[:n]
        assert set(np.flatnonzero(kept[row])) == set(top)
    # Draws land inside the support, one stream per row.
    draws = tgpt.sample_logits_batched(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(top_ks).long(), torch.from_numpy(top_ps),
        torch.arange(5), torch.zeros(5, dtype=torch.long),
    ).numpy()
    assert all(kept[r, t] for r, t in enumerate(draws))
