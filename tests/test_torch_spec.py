"""PyTorch port, speculative decoding, on the CPU.

Under ``attn_impl="reference"`` and fp32 the port's verify matches the JAX
package's at 1e-4 and is bit for bit the port's sequential decode steps;
the n-gram drafter's proposals equal the JAX one's and the draft model's
equal the JAX one's on shared weights. The speculative engine (n-gram or
draft model, dense or paged) serves greedy requests token-identical to the
port's solo ``gpt_generate``, and a sampled request takes one device draw
per emitted token: its tokens do not change with speculation or with
batchmates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

#: GQA: the cache carries Hkv < H heads.
JAX_CFG = jgpt.GPTConfig(
    vocab_size=97,
    n_layer=2,
    n_head=4,
    n_kv_head=2,
    d_model=32,
    max_seq=64,
    attn_impl="reference",
    compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))
#: The draft model of ``tests/test_serve.py:DRAFT_CFG``: another shape and
#: other weights; its proposals owe the main model nothing.
JAX_DRAFT = jgpt.GPTConfig(
    vocab_size=97,
    n_layer=1,
    n_head=2,
    d_model=16,
    max_seq=48,
    attn_impl="reference",
    compute_dtype="float32",
)
DRAFT = tgpt.GPTConfig(**dataclasses.asdict(JAX_DRAFT))
_jax_generate = jax.jit(jgpt.gpt_generate, static_argnums=(1, 3))


def _numpy_tree(cfg, seed):
    rng = np.random.default_rng(seed)
    return {
        k: (
            {n: 0.1 * rng.standard_normal(s).astype(np.float32)
             for n, s in v.items()}
            if isinstance(v, dict)
            else 0.1 * rng.standard_normal(v).astype(np.float32)
        )
        for k, v in tgpt.param_shapes(cfg).items()
    }


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) holding the same numpy weights."""
    tree = _numpy_tree(CFG, 0)
    return (
        jax.tree_util.tree_map(jnp.asarray, tree),
        params_from_jax(tree, CFG, "cpu"),
    )


@pytest.fixture(scope="module")
def draft_weights():
    tree = _numpy_tree(DRAFT, 7)
    return (
        jax.tree_util.tree_map(jnp.asarray, tree),
        params_from_jax(tree, DRAFT, "cpu"),
    )


def _solo(params, prompt, n):
    return tgpt.gpt_generate(params, CFG, [prompt], n, device="cpu")[0].tolist()


def _spec_kw(spec, depth, draft_params):
    kw = dict(spec=spec, spec_depth=depth)
    if spec == "model":
        kw.update(spec_params=draft_params, spec_config=DRAFT, spec_window=16)
    return kw


def _engine(params, **kw):
    kw = {"num_slots": 3, "max_seq": 64, "prefill_buckets": [8, 16], **kw}
    return DecodeEngine(params, CFG, device="cpu", **kw)


def _drain(eng, outs):
    while eng.num_active:
        for _, task, tok, _ in eng.prefill_step(1):
            outs.setdefault(task.request_id, []).append(tok)
        for _, rid, tok, _ in eng.step():
            outs.setdefault(rid, []).append(tok)


# -- (a) verify and the drafters against the JAX package --------------------
_VERIFY_CASES = {
    "learned": {},
    "rope": dict(pos_embed="rope"),
    "window-sinks": dict(attn_window=6, attn_sinks=2),
}


@pytest.mark.parametrize("case", sorted(_VERIFY_CASES))
def test_verify_matches_jax_and_sequential_steps(case):
    """gpt_decode_verify against the JAX one at 1e-4 and bitwise against
    sequential port decode steps, logits and cache rows. Slot 2's block
    runs past max_seq: its rows past the end are dropped, so row S - 1
    keeps the K/V of the token at position S - 1 (a decode step's clamp
    would overwrite it); slot 3 sits at the cache end and writes nothing."""
    kw = _VERIFY_CASES[case]
    jcfg = dataclasses.replace(JAX_CFG, **kw)
    cfg = tgpt.GPTConfig(**dataclasses.asdict(jcfg))
    tree = _numpy_tree(cfg, 1)
    params = tgpt.cast_params(params_from_jax(tree, cfg, "cpu"), cfg)
    rng = np.random.default_rng(2)
    B, Q, S = 4, 4, cfg.max_seq
    shape = (cfg.n_layer, B, S, cfg.kv_head, cfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    toks = rng.integers(0, 97, size=(B, Q))
    toks[2, 2] = (toks[2, 1] + 1) % 97  # the clamped step's row differs
    pos = np.array([3, 29, S - 2, S])
    with torch.no_grad():
        logits, k_v, v_v = tgpt.gpt_decode_verify(
            params, cfg, torch.from_numpy(toks), torch.from_numpy(pos),
            torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
        )
        jl, jk, jv = jgpt.gpt_decode_verify(
            jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
            jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(kc), jnp.asarray(vc),
        )
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(k_v.numpy(), np.asarray(jk), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(v_v.numpy(), np.asarray(jv), atol=1e-4,
                                   rtol=1e-4)
        k_s, v_s = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        for i in range(Q):
            step, k_s, v_s = tgpt.gpt_decode_step(
                params, cfg, torch.from_numpy(toks[:, i]),
                torch.from_numpy(pos + i), k_s, v_s,
            )
            for b in range(B):
                p = int(pos[b]) + i
                if p >= S:
                    continue
                assert torch.equal(logits[b, i], step[b]), (b, i)
                assert torch.equal(k_v[:, b, p], k_s[:, b, p]), (b, i)
                assert torch.equal(v_v[:, b, p], v_s[:, b, p]), (b, i)
    # Rows past the end dropped: slot 2's row S - 1 holds toks[2, 1]'s K/V
    # (checked above at i = 1); slot 3's strip is untouched.
    assert torch.equal(k_v[:, 3], torch.from_numpy(kc[:, 3]))
    assert not torch.equal(k_v[:, 2, S - 1], k_s[:, 2, S - 1])


def test_ngram_propose_matches_jax():
    """The n-gram drafter's proposals equal the JAX one's: bigram hits,
    unigram fallbacks, continuations cut at pos, and no match at all."""
    rng = np.random.default_rng(4)
    B, S = 6, 40
    hist = rng.integers(0, 5, size=(B, S))  # a small alphabet: many repeats
    hist[4] = np.arange(S)  # no earlier occurrence of anything
    pos = np.array([0, 1, 7, 20, 30, S - 1])
    cur = hist[np.arange(B), pos]
    for depth in (1, 3, 6):
        got = tgpt.ngram_propose(torch.from_numpy(hist), torch.from_numpy(pos),
                                 torch.from_numpy(cur), depth=depth)
        want = jgpt.ngram_propose(jnp.asarray(hist, jnp.int32),
                                  jnp.asarray(pos, jnp.int32),
                                  jnp.asarray(cur, jnp.int32), depth=depth)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_model_propose_matches_jax(draft_weights):
    """The draft model's proposals equal the JAX one's on shared weights,
    short histories (left-filled) included."""
    j_draft, draft = draft_weights
    rng = np.random.default_rng(5)
    B, S = 4, 64
    hist = rng.integers(0, 97, size=(B, S))
    pos = np.array([2, 15, 40, 63])
    cur = hist[np.arange(B), pos]
    with torch.no_grad():
        got = tgpt.model_propose(
            tgpt.cast_params(draft, DRAFT), DRAFT, torch.from_numpy(hist),
            torch.from_numpy(pos), torch.from_numpy(cur), depth=4, window=16,
        )
    want = jgpt.model_propose(
        j_draft, JAX_DRAFT, jnp.asarray(hist, jnp.int32),
        jnp.asarray(pos, jnp.int32), jnp.asarray(cur, jnp.int32), depth=4,
        window=16,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- (b) the speculative engine --------------------------------------------
def _sampled_run(params, fold, spec_kw, with_companion):
    """A sampled request's tokens alone or beside a greedy companion."""
    eng = _engine(params, num_slots=2, max_seq=48, prefill_buckets=[8],
                  decode_fold=fold, **spec_kw)
    _, tok, _ = eng.admit(list(range(1, 7)), request_id="s", max_new_tokens=8,
                          temperature=0.8, top_k=20, top_p=0.9, seed=123)
    outs = {"s": [tok]}
    if with_companion:
        eng.admit([9, 8, 7], request_id="c", max_new_tokens=8)
    _drain(eng, outs)
    return outs["s"]


@pytest.mark.parametrize("spec", ["ngram", "model"])
@pytest.mark.parametrize("depth", [2, 4])
@pytest.mark.parametrize("fold", [1, 4])
def test_engine_spec_matches_solo(weights, draft_weights, spec, depth, fold):
    """The speculative matrix (tests/test_serve.py:711): every greedy
    output equals the solo gpt_generate, a mid-flight join included; a
    sampled request gives the same tokens alone, beside a companion and
    under spec="off" (one draw per emitted token)."""
    _, params = weights
    spec_kw = _spec_kw(spec, depth, draft_weights[1])
    eng = _engine(params, decode_fold=fold, **spec_kw)
    rng = np.random.default_rng(0)
    reqs = [
        (rng.integers(0, 97, size=5).tolist(), 7),
        (rng.integers(0, 97, size=8).tolist(), 4),
        (rng.integers(0, 97, size=11).tolist(), 9),
    ]
    outs = {}
    for i, (p, n) in enumerate(reqs):
        _, tok, done = eng.admit(p, request_id=f"r{i}", max_new_tokens=n)
        assert not done
        outs[f"r{i}"] = [tok]
    joined = False
    while eng.num_active:
        for _, rid, tok, _ in eng.step():
            outs[rid].append(tok)
        if not joined and eng.free_slots():
            p4 = rng.integers(0, 97, size=6).tolist()
            _, tok, _ = eng.admit(p4, request_id="r3", max_new_tokens=5)
            outs["r3"] = [tok]
            reqs.append((p4, 5))
            joined = True
    assert joined
    for i, (p, n) in enumerate(reqs):
        assert p + outs[f"r{i}"] == _solo(params, p, n), f"r{i}"
    st = eng.spec_stats()
    assert st["verifies"] > 0 and 0.0 <= st["accept_rate"] <= 1.0
    assert 1.0 <= st["tokens_per_verify"] <= depth + 1
    alone = _sampled_run(params, fold, spec_kw, False)
    assert len(alone) == 8
    assert alone == _sampled_run(params, fold, spec_kw, True)
    assert alone == _sampled_run(params, fold, {}, False)


def _eos_in_accepted_block(params, n_new=20):
    """A prompt whose n-gram spec run emits, inside one verify's block and
    after at least one accepted draft, a token seen nowhere earlier in its
    output: with that token as eos the slot must stop mid-block. Searched,
    not hard-coded: the JAX suite's fixture for this case has drifted
    (ROADMAP queue 3)."""
    rng = np.random.default_rng(3)
    for _ in range(100):
        prompt = rng.integers(1, 97, size=6).tolist()
        eng = _engine(params, num_slots=1, decode_fold=1, spec="ngram",
                      spec_depth=4)
        _, tok, _ = eng.admit(prompt, request_id="e", max_new_tokens=n_new)
        gen = [tok]
        while eng.num_active:
            block = [t for _, _, t, _ in eng.step()]
            for k in range(1, len(block)):
                j = len(gen) + k
                if block[k] not in gen + block[:k]:
                    return prompt, (gen + block)[: j + 1], j
            gen += block
    raise AssertionError("no prompt with an eos inside an accepted block")


def test_engine_spec_eos_inside_accepted_block(weights):
    """EOS inside an accepted block (tests/test_serve.py:786): the slot
    freezes exactly at the eos, with accepted drafts before it in the same
    verify and proposals after it dropped; a batchmate decodes through the
    same speculative folds unperturbed."""
    _, params = weights
    prompt, gen, j = _eos_in_accepted_block(params)
    assert prompt + gen == _solo(params, prompt, 20)[: len(prompt) + j + 1]
    eng = _engine(params, num_slots=2, decode_fold=2, spec="ngram",
                  spec_depth=4)
    _, tok, done = eng.admit(prompt, request_id="e", max_new_tokens=20,
                             eos_token=gen[j])
    assert not done
    mate = list(range(20, 31))
    _, mtok, _ = eng.admit(mate, request_id="m", max_new_tokens=9)
    outs = {"e": [tok], "m": [mtok]}
    _drain(eng, outs)
    assert outs["e"] == gen[: j + 1]
    assert mate + outs["m"] == _solo(params, mate, 9)
    st = eng.spec_stats()
    assert st["accepted_tokens"] >= 1 and st["tokens_per_verify"] > 1.0
    assert not eng.device_state()["active"].any()


def test_engine_spec_cancel_and_recycle_over_stale_history(weights):
    """A cancel between speculative folds (tests/test_serve.py:831,
    without the pipelined dispatch): the released tenant emits nothing
    more, the next tenant of the same slot, admitted over its stale token
    history, decodes exactly, and a sampled batchmate's tokens are those
    of its solo run."""
    _, params = weights
    kw = dict(decode_fold=4, spec="ngram", spec_depth=3, pipeline=False)
    sampled = dict(max_new_tokens=12, temperature=0.8, top_k=20, top_p=0.9,
                   seed=123)
    solo_eng = _engine(params, num_slots=1, **kw)
    _, tok, _ = solo_eng.admit(list(range(1, 7)), request_id="s", **sampled)
    solo = {"s": [tok]}
    _drain(solo_eng, solo)
    eng = _engine(params, num_slots=2, **kw)
    _, tok, _ = eng.admit(list(range(1, 7)), request_id="s", **sampled)
    slot_v, _, _ = eng.admit(list(range(40, 48)), request_id="victim",
                             max_new_tokens=30)
    outs = {"s": [tok]}
    for _, rid, t, _ in eng.step():
        outs.setdefault(rid, []).append(t)
    eng.release(slot_v)
    assert eng.free_slots() == [slot_v]
    victim_tokens = len(outs["victim"])
    nxt = list(range(60, 66))
    slot2, ntok, _ = eng.admit(nxt, request_id="next", max_new_tokens=7)
    assert slot2 == slot_v
    outs["next"] = [ntok]
    _drain(eng, outs)
    assert len(outs["victim"]) == victim_tokens
    assert nxt + outs["next"] == _solo(params, nxt, 7)
    assert outs["s"] == solo["s"]


def test_scheduler_spec_metrics(weights):
    """The scheduler diffs the engine's accept counters into ServeMetrics
    (tests/test_serve.py:894 without the replica): the snapshot carries
    spec_accept_rate in [0, 1] and draft_tokens_per_verify = depth."""
    _, params = weights
    eng = _engine(params, num_slots=2, max_seq=48, decode_fold=2,
                  spec="ngram", spec_depth=3)
    sched = Scheduler(eng, max_prefills_per_step=2)
    rng = np.random.default_rng(2)
    reqs = {}
    for _ in range(4):
        p = rng.integers(0, 97, size=int(rng.integers(3, 12))).tolist()
        n = int(rng.integers(4, 9))
        reqs[sched.submit(p, SamplingParams(max_new_tokens=n))] = (p, n, [])
    for ev in sched.run_until_idle():
        if ev.token is not None:
            reqs[ev.request_id][2].append(ev.token)
    for p, n, toks in reqs.values():
        assert p + toks == _solo(params, p, n)
    snap = sched.metrics.snapshot()
    assert 0.0 <= snap["spec_accept_rate"] <= 1.0
    assert snap["draft_tokens_per_verify"] == 3.0
    st = eng.spec_stats()
    assert snap["spec_accept_rate"] == round(
        st["accepted_tokens"] / st["drafted_tokens"], 4
    )


@pytest.mark.parametrize("spec", ["ngram", "model"])
def test_paged_spec_exact(weights, draft_weights, spec):
    """Speculation over the paged pool (tests/test_serve_paged.py:186):
    greedy output equals the solo run on a repetitive prompt, with real
    accepts for the n-gram drafter, and the pages balance at idle."""
    _, params = weights
    eng = DecodeEngine(
        params, CFG, num_slots=3, max_seq=64, prefill_buckets=[16],
        prefill_chunk=4, kv_page=4, kv_pages=32, decode_fold=2, device="cpu",
        **_spec_kw(spec, 3, draft_weights[1]),
    )
    p = (list(range(6)) * 4)[:14]
    eng.admit(p, request_id="s0", max_new_tokens=12)
    outs = {}
    _drain(eng, outs)
    assert p + outs["s0"] == _solo(params, p, 12)
    if spec == "ngram":
        assert eng.spec_accepted_tokens > 0
    st = eng.kv_page_stats()
    assert st["allocs"] - st["frees"] == st["resident"] and st["aliased"] == 0


def test_spec_knob_validation(weights, draft_weights):
    _, params = weights
    with pytest.raises(ValueError, match="unknown spec mode"):
        _engine(params, spec="tree")
    with pytest.raises(ValueError, match="spec_depth"):
        _engine(params, spec="ngram", spec_depth=0)
    with pytest.raises(ValueError, match="needs spec_params"):
        _engine(params, spec="model")
    bad_vocab = dataclasses.replace(DRAFT, vocab_size=98)
    with pytest.raises(ValueError, match="vocab"):
        _engine(params, spec="model", spec_params=draft_weights[1],
                spec_config=bad_vocab)
    with pytest.raises(ValueError, match="max_seq"):
        _engine(params, spec="model", spec_params=draft_weights[1],
                spec_config=DRAFT, spec_window=46, spec_depth=4)
    eng = _engine(params, spec="model", spec_params=draft_weights[1],
                  spec_config=dataclasses.asdict(DRAFT))
    assert eng.spec == "model" and eng.device_state()["hist"].shape == (3, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.cuda_hw
def test_verify_rows_equal_sequential_steps_on_the_card(weights, dtype):
    """On the card, too, gpt_decode_verify's logits are bitwise those of
    sequential decode steps: the property behind spec's greedy and sampled
    tokens equalling the plain engine's there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    params = tgpt.cast_params(tgpt.params_to(weights[1], torch.device("cuda")),
                              cfg)
    rng = np.random.default_rng(6)
    B, Q, S = 11, 5, cfg.max_seq
    shape = (cfg.n_layer, B, S, cfg.kv_head, cfg.head_dim)
    kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(device="cuda", dtype=tgpt.compute_dtype(cfg))
              for _ in range(2))
    toks = torch.from_numpy(rng.integers(0, 97, size=(B, Q))).cuda()
    pos = torch.from_numpy(rng.integers(0, S - Q, size=B)).cuda()
    with torch.no_grad():
        logits, _, _ = tgpt.gpt_decode_verify(params, cfg, toks, pos,
                                              kc.clone(), vc.clone())
        k_s, v_s = kc.clone(), vc.clone()
        for i in range(Q):
            step, k_s, v_s = tgpt.gpt_decode_step(params, cfg, toks[:, i],
                                                  pos + i, k_s, v_s)
            assert torch.equal(logits[:, i], step), i
