"""PyTorch port, weight-only int8 serving on the CPU: the quantizer bit for
bit against the JAX package's, the int8 forward, prefill and decode against
the JAX int8 path (1e-4, fp32), and the int8 engine against the engine on
the dequantized tree (bitwise: the same operand values), the solo
``gpt_generate`` of both packages and ``build_engine(int8=True)``.

The ``cuda_hw`` tests hold an int8 engine's graph replay bitwise equal to
its eager bodies and read what the dequant adds to the graph pool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
import ray_lightning_tpu.utils.quantize as jq
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax, params_to_numpy
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler
from ray_lightning_tpu_torch.serve.server import build_engine
from ray_lightning_tpu_torch.utils.quantize import (
    dequantize_params,
    is_quantized,
    quantize_params_int8,
    quantize_tensor,
    weight_bytes,
)
from ray_lightning_tpu_torch.utils.state_stream import (
    state_stream_to_file,
    to_state_stream,
)

TOL = dict(atol=1e-4, rtol=1e-4)
cuda_hw = pytest.mark.cuda_hw

CONFIGS = {
    "gpt2-tied": jgpt.GPTConfig(
        vocab_size=97, n_layer=2, n_head=4, d_model=32, max_seq=64,
        attn_impl="reference", compute_dtype="float32",
    ),
    "llama-gqa-untied": dataclasses.replace(
        jgpt.GPTConfig.llama(
            vocab_size=64, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
            d_ff=48, max_seq=64,
        ),
        attn_impl="reference", compute_dtype="float32",
    ),
}
#: The serving config of the engine tests (GQA, tied head).
JAX_CFG = jgpt.GPTConfig(
    vocab_size=97, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq=64,
    attn_impl="reference", compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))
SAMPLED = SamplingParams(max_new_tokens=8, temperature=0.9, top_k=20,
                         top_p=0.9, seed=11)


def _torch_cfg(cfg):
    return tgpt.GPTConfig(**dataclasses.asdict(cfg))


def _numpy_tree(cfg, seed=0, scale=0.1):
    rng = np.random.default_rng(seed)

    def leaf(shape):
        return scale * rng.standard_normal(shape).astype(np.float32)

    return {
        k: ({n: leaf(s) for n, s in v.items()} if isinstance(v, dict)
            else leaf(v))
        for k, v in tgpt.param_shapes(_torch_cfg(cfg)).items()
    }


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def weights():
    """(numpy fp32 tree, JAX int8 tree, port int8 tree, port fp32 tree)
    of the engine config."""
    tree = _numpy_tree(JAX_CFG)
    j_q = jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    fp = params_from_jax(tree, CFG, "cpu")
    return tree, j_q, quantize_params_int8(fp), fp


def _serve(eng, reqs, **sched_kw):
    sched = Scheduler(eng, max_prefills_per_step=2, **sched_kw)
    outs = {}
    for rid, p, sp in reqs:
        sched.submit(p, sp, request_id=rid)
        outs[rid] = []
    for ev in sched.run_until_idle():
        if ev.token is not None:
            outs[ev.request_id].append(ev.token)
    return outs


def _reqs(seed=3):
    rng = np.random.default_rng(seed)
    return [("s", rng.integers(0, 97, 9).tolist(), SAMPLED)] + [
        (f"g{i}", rng.integers(0, 97, n).tolist(),
         SamplingParams(max_new_tokens=7)) for i, n in enumerate((5, 12, 14))
    ]


# -- the quantizer ---------------------------------------------------------
def test_quantize_tensor_roundtrip_bound():
    """tests/test_quantize.py:24: symmetric per-channel int8 keeps
    |w - dequant(q)| <= s/2 everywhere, and all-zero channels stay zero."""
    w = 0.05 * np.random.default_rng(0).standard_normal((32, 3, 8)).astype(
        np.float32)
    w[:, 1, 2] = 0.0  # a dead output channel
    node = quantize_tensor(torch.from_numpy(w), (0,))
    assert node["q"].dtype == torch.int8 and node["s"].dtype == torch.float32
    deq = (node["q"].float() * node["s"]).numpy()
    assert (np.abs(deq - w) <= node["s"].numpy() / 2 + 1e-8).all()
    assert (deq[:, 1, 2] == 0).all()


@pytest.mark.parametrize("name", [*CONFIGS, "moe"])
def test_quantized_tree_is_bitwise_the_jax_one(name):
    """The same fp32 tree quantizes to bit-identical q and s in both
    packages (fp32 scale and division, round half to even, the 1e-12
    floor), every leaf of the tree; a MoE tree (tests/test_quantize.py:159)
    keeps its expert and router leaves fp32."""
    if name == "moe":
        cfg = jgpt.GPTConfig(vocab_size=64, n_layer=2, n_head=4, d_model=32,
                             max_seq=32, n_experts=4, d_ff=32)
        tree = _np(jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg))
    else:
        tree = _numpy_tree(CONFIGS[name], seed=1)
    # A channel with scale exactly 1 and quotients at halves (round half
    # to even), and a dead channel (the 1e-12 floor).
    wo = tree["blocks"]["wo"]  # (L, H, hd, D): contract H, hd
    wo[0, 0, :5, 0] = [127.0, 0.5, -0.5, 1.5, 2.5]
    wo[1, :, :, 3] = 0.0
    j_q = _np(jq.quantize_params_int8(
        jax.tree_util.tree_map(jnp.asarray, tree)))
    t_q = quantize_params_int8(
        jax.tree_util.tree_map(torch.from_numpy, tree))
    flat_j = dict(jax.tree_util.tree_leaves_with_path(j_q))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), t_q)))
    assert flat_j.keys() == flat_t.keys()
    for path, leaf in flat_j.items():
        assert flat_t[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_t[path], leaf, err_msg=str(path))
    if name == "moe":
        for leaf in ("wi", "wo2", "router"):
            assert not is_quantized(t_q["blocks"][leaf])
        assert is_quantized(t_q["blocks"]["wqkv"])
        with pytest.raises(NotImplementedError, match="item 13"):
            tgpt.gpt_forward(t_q, torch.zeros((1, 4), dtype=torch.long),
                             _torch_cfg(cfg))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantized_path_equals_dequantized_oracle(name):
    """tests/test_quantize.py:65: the forward on the int8 tree equals the
    forward on its dequantized fp32 tree bit for bit (the same operand
    values), agrees with the JAX int8 forward at 1e-4, and differs from the
    original weights' forward by a small, nonzero error."""
    cfg = CONFIGS[name]
    t_cfg = _torch_cfg(cfg)
    tree = _numpy_tree(cfg, scale=0.05)
    fp = params_from_jax(tree, t_cfg, "cpu")
    qp = quantize_params_int8(fp)
    keys = {k for k, v in qp.items() if is_quantized(v)} | {
        f"blocks.{k}" for k, v in qp["blocks"].items() if is_quantized(v)}
    assert "wte" in keys and "blocks.wo2" in keys
    assert ("lm_head" in keys) == (not cfg.tie_word_embeddings)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16))
    with torch.inference_mode():
        out = tgpt.gpt_forward(qp, torch.from_numpy(toks), t_cfg)
        oracle = tgpt.gpt_forward(dequantize_params(qp),
                                  torch.from_numpy(toks), t_cfg)
        ref = tgpt.gpt_forward(fp, torch.from_numpy(toks), t_cfg)
    assert torch.equal(out, oracle)
    j_out = jgpt.gpt_forward(
        jq.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree)),
        jnp.asarray(toks, jnp.int32), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), **TOL)
    rel = (out - ref).abs().max() / ref.abs().max()
    assert 0 < rel < 0.05, rel


@pytest.mark.parametrize("name", list(CONFIGS))
def test_quantized_decode_matches_quantized_forward(name):
    """tests/test_quantize.py:107: greedy decode from the int8 tree
    (prefill + cached steps) agrees with argmax over the int8 parallel
    forward at every position."""
    cfg = CONFIGS[name]
    t_cfg = _torch_cfg(cfg)
    qp = quantize_params_int8(
        params_from_jax(_numpy_tree(cfg, seed=3, scale=0.05), t_cfg, "cpu"))
    out = tgpt.gpt_generate(qp, t_cfg, [[5, 2, 7, 1]], 6, device="cpu")
    assert tuple(out.shape) == (1, 10)
    with torch.inference_mode():
        for p in range(3, 9):
            logits = tgpt.gpt_forward(qp, out[:, : p + 1], t_cfg)
            assert logits[:, -1].argmax(-1).tolist() == out[:, p + 1].tolist()


def test_quantized_chunked_loss():
    """tests/test_quantize.py:128 (its zigzag half waits for sequence
    parallelism, ROADMAP queue 1 item 12): the fused chunked head takes an
    int8 table and agrees with the dense head's loss."""
    cfg = _torch_cfg(CONFIGS["gpt2-tied"])
    qp = quantize_params_int8(params_from_jax(
        _numpy_tree(CONFIGS["gpt2-tied"], scale=0.05), cfg, "cpu"))
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17)))
    with torch.inference_mode():
        hidden = tgpt.gpt_forward(qp, toks[:, :-1], cfg, return_hidden=True)
        loss_c, acc_c = tgpt.chunked_lm_loss(hidden, qp["wte"], toks[:, 1:], 4)
        loss_d, acc_d = tgpt.lm_loss(tgpt.gpt_forward(qp, toks[:, :-1], cfg),
                                     toks[:, 1:])
    np.testing.assert_allclose(float(loss_c), float(loss_d), rtol=2e-4)
    assert float(acc_c) == float(acc_d)


def test_int8_prefill_and_decode_logits_match_jax(weights):
    """The serving functions on the int8 tree against the JAX package's on
    its int8 tree (bit-identical q and s): prefill hidden states and K/V,
    and one decode step's logits, at 1e-4."""
    _, j_q, t_q, _ = weights
    rng = np.random.default_rng(0)
    B, P, S = 2, 12, 32
    prompt = rng.integers(0, 97, (B, P)).astype(np.int32)
    jh, jk, jv = jax.jit(jgpt.gpt_prefill, static_argnums=1)(
        j_q, JAX_CFG, jnp.asarray(prompt))
    with torch.inference_mode():
        th, tk, tv = tgpt.gpt_prefill(t_q, CFG, torch.from_numpy(prompt).long())
    for a, b in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    L, Hkv, hd = JAX_CFG.n_layer, JAX_CFG.kv_head, JAX_CFG.head_dim
    kc = np.zeros((L, B, S, Hkv, hd), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :P], vc[:, :, :P] = np.asarray(jk), np.asarray(jv)
    cur = rng.integers(0, 97, B).astype(np.int32)
    pos = np.array([P, P - 4], np.int32)
    jl, _, _ = jax.jit(jgpt.gpt_decode_step, static_argnums=1)(
        j_q, JAX_CFG, jnp.asarray(cur), jnp.asarray(pos), jnp.asarray(kc),
        jnp.asarray(vc))
    with torch.inference_mode():
        tl, _, _ = tgpt.gpt_decode_step(
            t_q, CFG, torch.from_numpy(cur).long(),
            torch.from_numpy(pos).long(), torch.from_numpy(kc.copy()),
            torch.from_numpy(vc.copy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_weight_bridge_carries_int8_both_ways(weights):
    """A JAX int8 tree crosses into the port (int8 q, fp32 s) and back
    unchanged, and equals the port's own quantization of the same tree."""
    _, j_q, t_q, _ = weights
    np_q = _np(j_q)
    port = params_from_jax(np_q, CFG, "cpu")
    assert port["blocks"]["wq"]["q"].dtype == torch.int8
    back = params_to_numpy(port)
    flat_j = jax.tree_util.tree_leaves_with_path(np_q)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(params_to_numpy(t_q)))
    assert len(flat_j) == len(flat_b) == len(flat_t)
    for path, leaf in flat_j:
        assert flat_b[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(flat_b[path], leaf)
        np.testing.assert_array_equal(flat_t[path], leaf)


# -- the int8 engine -------------------------------------------------------
ENGINES = {
    "mono": dict(decode_fold=2, prefill_buckets=[8, 16]),
    "paged_pb": dict(kv_page=4, kv_pages=40, piggyback_chunks=2,
                     decode_fold=2, prefill_buckets=[16]),
}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_int8_engine_is_bitwise_the_dequantized_engine(weights, kind):
    """The int8 engine and the engine on dequantize_params of the same tree
    see the same operand values: greedy and sampled tokens equal. The int8
    engine keeps its weights int8 (no compute-dtype copy of an int8 leaf,
    no head_c) and its greedy tokens equal the port's solo gpt_generate on
    the int8 tree and the JAX package's on its int8 tree."""
    _, j_q, t_q, _ = weights
    reqs = _reqs()
    eng = DecodeEngine(t_q, CFG, num_slots=3, max_seq=64, device="cpu",
                       **ENGINES[kind])
    assert "head_c" not in eng.params
    assert all(is_quantized(eng.params["blocks"][k])
               for k in ("wq", "wkv", "wo", "wi", "wo2"))
    assert is_quantized(eng.params["wte"])
    got = _serve(eng, reqs)
    deq = DecodeEngine(dequantize_params(t_q), CFG, num_slots=3, max_seq=64,
                       device="cpu", **ENGINES[kind])
    assert _serve(deq, reqs) == got
    j_gen = jax.jit(jgpt.gpt_generate, static_argnums=(1, 3))
    for rid, p, sp in reqs:
        solo = tgpt.gpt_generate(
            t_q, CFG, [p], sp.max_new_tokens, temperature=sp.temperature,
            top_k=sp.top_k, top_p=sp.top_p, seed=sp.seed, device="cpu",
        )[0, len(p):].tolist()
        assert got[rid] == solo, rid
        if sp.temperature == 0:
            want = np.asarray(j_gen(j_q, JAX_CFG, jnp.asarray([p], jnp.int32),
                                    sp.max_new_tokens))[0, len(p):].tolist()
            assert got[rid] == want, rid


def test_build_engine_int8_equals_quantize_then_construct(weights, tmp_path):
    """build_engine(int8=True) quantizes at load: the same tokens as an
    engine constructed on quantize_params_int8 of the tree, from explicit
    params and from a checkpoint; the resident weights shrink; mesh raises
    naming its ROADMAP item, and ``kvstore_dir`` builds the engine's KV
    object store in the reference's namespace."""
    tree, _, t_q, fp = weights
    reqs = _reqs(4)
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=[8, 16],
              decode_fold=2, device="cpu")
    want = _serve(DecodeEngine(t_q, CFG, **kw), reqs)
    eng = build_engine(params=fp, model_config=dataclasses.asdict(CFG),
                       int8=True, **kw)
    assert _serve(eng, reqs) == want
    ckpt = str(tmp_path / "model.ckpt")
    state_stream_to_file(to_state_stream(
        {"params": fp, "gpt_config": dataclasses.asdict(CFG)}), ckpt)
    eng2 = build_engine(ckpt_path=ckpt, int8=True, mesh="1x1", **kw)
    assert _serve(eng2, reqs) == want
    f_eng = build_engine(ckpt_path=ckpt, **kw)
    assert weight_bytes(eng.params) < 0.5 * weight_bytes(f_eng.params)
    with pytest.raises(NotImplementedError, match="item 11"):
        build_engine(params=fp, model_config=CFG, mesh="2x1", **kw)
    # The KV object store (item 9): the namespace is the given one, else
    # the reference's function of the raw (ckpt_path, model_config).
    from ray_lightning_tpu.serve.kvstore import (
        kvstore_namespace as jax_namespace,
    )

    for store, want in (
            ({"kvstore_dir": str(tmp_path / "kv")},
             jax_namespace(None, dataclasses.asdict(CFG))),
            ({"kvstore_dir": str(tmp_path / "kv"), "kvstore_mb": 64.0},
             jax_namespace(None, dataclasses.asdict(CFG))),
            ({"kvstore_dir": str(tmp_path / "kv"), "kvstore_namespace": "ns"},
             "ns")):
        s_eng = build_engine(params=fp, model_config=dataclasses.asdict(CFG),
                             prefix_blocks=4, **store, **kw)
        assert s_eng.kvstore_namespace == s_eng.kvstore.namespace == want
        assert s_eng.kvstore.budget_bytes == int(
            store.get("kvstore_mb", 0.0) * (1 << 20))
    for store in ({"kvstore_mb": 64.0}, {"kvstore_namespace": "ns"}):
        # Without a directory there is no store, as in the reference.
        assert build_engine(params=fp, model_config=CFG, **store,
                            **kw).kvstore is None
    with pytest.raises(ValueError, match="model_config"):
        build_engine(params=fp, **kw)


def test_int8_draft_emits_the_tokens_of_spec_off(weights, tmp_path):
    """A draft model loaded from a checkpoint and quantized at load
    (spec_draft_int8) drafts for the main model: greedy and sampled
    tokens are spec='off''s."""
    _, _, _, fp = weights
    draft_cfg = dataclasses.replace(CFG, n_layer=1)
    draft = dict(fp, blocks={k: v[:1] for k, v in fp["blocks"].items()})
    ckpt = str(tmp_path / "draft.ckpt")
    state_stream_to_file(to_state_stream(
        {"params": draft, "gpt_config": dataclasses.asdict(draft_cfg)}), ckpt)
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=[8, 16],
              decode_fold=2, device="cpu")
    reqs = _reqs(5)
    off = _serve(build_engine(params=fp, model_config=CFG, **kw), reqs)
    eng = build_engine(params=fp, model_config=CFG, spec="model",
                       spec_depth=2, spec_draft_ckpt=ckpt,
                       spec_draft_int8=True, spec_window=16, **kw)
    assert is_quantized(eng._spec_params["blocks"]["wq"])
    assert _serve(eng, reqs) == off
    assert eng.spec_verifies > 0


# -- on the card -------------------------------------------------------------
@cuda_hw
def test_int8_engine_replay_equals_eager_bodies(weights):
    """On the card an int8 engine's graph replays give its eager bodies'
    tokens, bit for bit, and no dispatch captures a graph afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, t_q, _ = weights
    reqs = _reqs(6)
    outs = []
    for graphs in (True, False):
        eng = DecodeEngine(t_q, CFG, num_slots=3, max_seq=64,
                           prefill_buckets=[16, 32], decode_fold=4,
                           fold_ladder=[1, 4], device="cuda", _graphs=graphs)
        n = eng.compiled_count
        outs.append(_serve(eng, reqs))
        assert eng.compiled_count == n
    assert outs[0] == outs[1]


@cuda_hw
def test_int8_dequant_graph_memory(weights):
    """What the per-use dequant adds to an engine's graph pool: the int8
    engine's pool beside the float engine's (printed; the pool holds the
    dequantized operands of one dispatch), and the resident weights
    smaller."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, t_q, fp = weights
    kw = dict(num_slots=3, max_seq=64, prefill_buckets=[16, 32],
              decode_fold=4, device="cuda")
    f_eng = DecodeEngine(fp, CFG, **kw)
    q_eng = DecodeEngine(t_q, CFG, **kw)
    print("graph pool bytes: float", f_eng.graph_bytes, "int8",
          q_eng.graph_bytes)
    assert q_eng.graph_bytes > 0 and f_eng.graph_bytes > 0
    assert weight_bytes(q_eng.params) < weight_bytes(f_eng.params)
