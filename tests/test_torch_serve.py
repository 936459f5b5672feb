"""PyTorch port, serving: the slot engine and the scheduler core on the CPU.

Under ``attn_impl="reference"`` and fp32 (the configuration under which
the JAX package claims exactness) every greedy request the engine serves
is token-identical to the port's solo ``gpt_generate`` and to the JAX
package's ``gpt_generate`` on the same weights, made with numpy.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

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

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: GQA on purpose: the slot cache carries Hkv < H heads, the shape most
#: likely to break slot indexing.
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
_jax_generate = jax.jit(jgpt.gpt_generate, static_argnums=(1, 3))


@pytest.fixture(scope="module")
def weights():
    """(JAX params, port params) holding the same numpy weights."""
    rng = np.random.default_rng(0)
    tree = {
        k: (
            {n: 0.1 * rng.standard_normal(s).astype(np.float32)
             for n, s in v.items()}
            if isinstance(v, dict)
            else 0.1 * rng.standard_normal(v).astype(np.float32)
        )
        for k, v in tgpt.param_shapes(CFG).items()
    }
    return (
        jax.tree_util.tree_map(jnp.asarray, tree),
        params_from_jax(tree, CFG, "cpu"),
    )


def _solo(params, prompt, n):
    out = tgpt.gpt_generate(params, CFG, [prompt], n, device="cpu")
    return out[0].tolist()


def _jax_solo(j_params, prompt, n):
    out = _jax_generate(j_params, JAX_CFG, jnp.asarray([prompt], jnp.int32), n)
    return np.asarray(out)[0].tolist()


def _engine(params, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("prefill_buckets", [8, 16])
    return DecodeEngine(params, CFG, max_seq=64, device="cpu", **kw)


def _drain(eng, outs, join=None):
    """Step until idle; ``join()`` runs once when a slot first frees."""
    while eng.num_active:
        for _, rid, tok, _ in eng.step():
            outs[rid].append(tok)
        if join is not None and eng.free_slots():
            join()
            join = None


def test_engine_concurrent_and_joining_match_solo_and_jax(weights):
    """Different prompt/output lengths admitted together and one request
    joining mid-flight: every output token-identical to the port's solo
    gpt_generate and to the JAX package's gpt_generate."""
    j_params, params = weights
    rng = np.random.default_rng(0)
    reqs = [
        (rng.integers(0, 97, size=5).tolist(), 7),
        (rng.integers(0, 97, size=8).tolist(), 3),
        (rng.integers(0, 97, size=11).tolist(), 9),
    ]
    eng = _engine(params, decode_fold=2)
    outs = {}
    for i, (p, n) in enumerate(reqs):
        _, tok, done = eng.admit(p, request_id=f"r{i}", max_new_tokens=n)
        assert not done
        outs[f"r{i}"] = [tok]
    late = (rng.integers(0, 97, size=6).tolist(), 5)

    def join():
        _, tok, _ = eng.admit(late[0], request_id="r3", max_new_tokens=late[1])
        outs["r3"] = [tok]
        reqs.append(late)

    _drain(eng, outs, join)
    assert len(reqs) == 4 and eng.num_active == 0
    for i, (p, n) in enumerate(reqs):
        solo = _solo(params, p, n)
        assert p + outs[f"r{i}"] == solo, f"r{i}"
        assert solo == _jax_solo(j_params, p, n), f"r{i}"


def test_engine_release_and_recycle(weights):
    """A slot released mid-flight is reusable at once; the new tenant's
    tokens match its solo run and the survivor is unperturbed."""
    _, params = weights
    eng = _engine(params, num_slots=2, decode_fold=3)
    pa, pb, pc = [1, 2, 3, 4], [10, 11, 12, 13, 14, 15, 16], [40, 41, 42]
    sa, ta, _ = eng.admit(pa, request_id="a", max_new_tokens=12)
    _, tb, _ = eng.admit(pb, request_id="b", max_new_tokens=10)
    outs = {"a": [ta], "b": [tb]}
    for _, rid, tok, _ in eng.step():
        outs[rid].append(tok)
    eng.release(sa)
    assert eng.free_slots() == [sa] and not eng.device_state()["active"][sa]
    slot, tc, _ = eng.admit(pc, request_id="c", max_new_tokens=6)
    assert slot == sa
    outs["c"] = [tc]
    _drain(eng, outs)
    assert pb + outs["b"] == _solo(params, pb, 10)
    assert pc + outs["c"] == _solo(params, pc, 6)
    assert outs["a"] == _solo(params, pa, 12)[len(pa):][: len(outs["a"])]


def _eos_case(params, fold, n_new=8):
    """A prompt whose solo greedy run first emits some token at index j
    strictly inside a fold (not its last iteration), so the slot must
    freeze with iterations left to run. Searched, not hard-coded: the
    fixture drift of the JAX suite's eos tests (ROADMAP queue 3) came
    from hard-coded prompts."""
    rng = np.random.default_rng(3)
    for _ in range(200):
        prompt = rng.integers(1, 97, size=6).tolist()
        gen = _solo(params, prompt, n_new)[len(prompt):]
        for j in range(1, n_new - 1):
            in_fold = (j - 1) % fold
            if in_fold < fold - 1 and gen[j] not in gen[:j]:
                return prompt, gen, j
    raise AssertionError("no prompt with a mid-fold first occurrence")


def test_engine_eos_mid_fold_stops_at_eos(weights):
    """EOS landing inside a fold: emission stops exactly at the eos token,
    the device-side active mask drops, and a batchmate decodes through
    the same folds unperturbed."""
    j_params, params = weights
    fold = 4
    prompt, gen, j = _eos_case(params, fold)
    assert prompt + gen == _jax_solo(j_params, prompt, len(gen))
    eos = gen[j]
    eng = _engine(params, num_slots=2, decode_fold=fold)
    _, tok, done = eng.admit(
        prompt, request_id="e", max_new_tokens=len(gen), eos_token=eos
    )
    assert not done
    mate = list(range(20, 31))
    _, mtok, _ = eng.admit(mate, request_id="m", max_new_tokens=9)
    outs = {"e": [tok], "m": [mtok]}
    _drain(eng, outs)
    assert outs["e"] == gen[: j + 1]
    assert mate + outs["m"] == _solo(params, mate, 9)
    assert not eng.device_state()["active"].any()


def test_sampled_request_independent_of_batchmates(weights):
    _, params = weights
    kw = dict(temperature=0.9, top_k=20, top_p=0.9, seed=7, max_new_tokens=10)
    prompt = [5, 6, 7, 8, 9]
    alone = _engine(params, decode_fold=3)
    _, tok, _ = alone.admit(prompt, request_id="s", **kw)
    outs = {"s": [tok]}
    _drain(alone, outs)
    crowd = _engine(params, decode_fold=3)
    _, m0, _ = crowd.admit([1, 2, 3], request_id="m0", max_new_tokens=12)
    _, tok, _ = crowd.admit(prompt, request_id="s", **kw)
    _, m1, _ = crowd.admit(
        [9, 9, 9, 9], request_id="m1", max_new_tokens=7, temperature=1.0,
        seed=1,
    )
    crowd_outs = {"s": [tok], "m0": [m0], "m1": [m1]}
    _drain(crowd, crowd_outs)
    assert crowd_outs["s"] == outs["s"] and len(outs["s"]) == 10


def _tokens(events):
    out = {}
    for ev in events:
        if ev.token is not None:
            out.setdefault(ev.request_id, []).append(ev.token)
    return out


def test_scheduler_submit_cancel_deadline_priority(weights):
    _, params = weights
    sched = Scheduler(_engine(params, num_slots=1, decode_fold=2))
    # Priority: one slot; the later, higher-priority request goes first.
    low = sched.submit([1, 2, 3], SamplingParams(max_new_tokens=4), priority=1)
    high = sched.submit([4, 5, 6], SamplingParams(max_new_tokens=4), priority=0)
    gone = sched.submit([7, 8], SamplingParams(max_new_tokens=4), priority=2)
    late = sched.submit(
        [9, 9], SamplingParams(max_new_tokens=4), priority=3, deadline_s=0.0
    )
    assert sched.cancel(gone) and not sched.cancel("nope")
    events = sched.run_until_idle()
    order = [ev.request_id for ev in events if ev.token is not None]
    assert order.index(high) < order.index(low)
    reasons = {ev.request_id: ev.reason for ev in events if ev.done}
    assert reasons == {
        high: "finished", low: "finished", gone: "cancelled", late: "expired",
    }
    toks = _tokens(events)
    assert [4, 5, 6] + toks[high] == _solo(params, [4, 5, 6], 4)
    assert [1, 2, 3] + toks[low] == _solo(params, [1, 2, 3], 4)
    snap = sched.metrics.snapshot()
    assert (snap["finished"], snap["cancelled"], snap["expired"]) == (2, 1, 1)
    assert snap["queue_depth"] == 0 and snap["ttft_p50_s"] > 0


def test_scheduler_priority_aging_restores_fifo(weights):
    """With aging, long-queued work drifts to priority 0, where FIFO
    order (submission sequence) decides."""
    _, params = weights
    sched = Scheduler(
        _engine(params, num_slots=1, decode_fold=4), priority_age_s=1e-9
    )
    first = sched.submit([1, 2, 3], SamplingParams(max_new_tokens=2), priority=5)
    second = sched.submit([4, 5, 6], SamplingParams(max_new_tokens=2))
    order = [ev.request_id for ev in sched.run_until_idle() if ev.done]
    assert order == [first, second]


def test_scheduler_cancel_in_flight_frees_the_slot(weights):
    _, params = weights
    sched = Scheduler(_engine(params, num_slots=1, decode_fold=1))
    rid = sched.submit([1, 2, 3, 4], SamplingParams(max_new_tokens=20))
    nxt = sched.submit([5, 6, 7], SamplingParams(max_new_tokens=3))
    first = sched.step()
    assert [ev.request_id for ev in first] == [rid, rid]
    assert sched.cancel(rid)
    events = sched.run_until_idle()
    assert events[0].request_id == rid and events[0].reason == "cancelled"
    assert [5, 6, 7] + _tokens(events)[nxt] == _solo(params, [5, 6, 7], 3)
    with pytest.raises(ValueError, match="exceeds"):
        sched.submit(list(range(20)), SamplingParams(max_new_tokens=3))


def test_engine_options_not_ported_raise(weights):
    _, params = weights
    for kw in (
        {"prefill_chunk": 8}, {"prefix_blocks": 4}, {"kv_pages": 8},
        {"spec": "ngram"}, {"piggyback_chunks": 1}, {"fold_ladder": [1, 2]},
        {"kvstore_dir": "x"}, {"mesh": object()}, {"pipeline": True},
    ):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _engine(params, **kw)
    with pytest.raises(TypeError):
        _engine(params, no_such_option=1)
    # The JAX defaults of the unported options are accepted.
    _engine(params, prefix_block=16, spec="off", fold_ladder=None)


def test_entry_points_need_cuda_unless_cpu_is_asked(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, params = weights
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine(params, CFG, num_slots=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgpt.gpt_generate(params, CFG, [[1, 2]], 2)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    """No card here (or no repo beside the script): chip_smoke.py exits
    non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = REPO_ROOT
    if where == "alone":
        shutil.copy(os.path.join(REPO_ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    proc = _run_smoke(cwd)
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except json.JSONDecodeError:
            last = None
        assert not (isinstance(last, dict) and last.get("ok"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda_hw)]
)
def test_decode_step_rows_do_not_depend_on_batch_or_cache_length(
    weights, dtype, device
):
    """One decode step gives a slot bitwise the same logits and new cache
    row alone, in a cache just long enough, as among ten batchmates in a
    longer cache: the property that lets the engine's greedy tokens equal
    solo gpt_generate's on the card. Slots 0 and 9 sit in the first and
    the second block of DECODE_ROWS rows."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    params = tgpt.cast_params(tgpt.params_to(weights[1], torch.device(device)),
                              cfg)
    cdt = tgpt.compute_dtype(cfg)
    rng = np.random.default_rng(3)
    B, S = 11, CFG.max_seq
    shape = (cfg.n_layer, B, S, cfg.kv_head, cfg.head_dim)
    kc, vc = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              .to(device=device, dtype=cdt) for _ in range(2))
    cur = torch.from_numpy(rng.integers(0, cfg.vocab_size, B)).to(device)
    pos = torch.from_numpy(rng.integers(4, 40, B)).to(device)
    with torch.no_grad():
        full, k_full, _ = tgpt.gpt_decode_step(params, cfg, cur, pos,
                                               kc.clone(), vc.clone())
        for b in (0, 9):
            n = int(pos[b]) + 1
            alone, k_alone, _ = tgpt.gpt_decode_step(
                params, cfg, cur[b:b + 1], pos[b:b + 1],
                kc[:, b:b + 1, :n].clone(), vc[:, b:b + 1, :n].clone(),
            )
            assert torch.equal(alone[0], full[b]), b
            assert torch.equal(k_alone[:, 0], k_full[:, b, :n]), b


def test_default_buckets_leave_flash_lengths_unpadded(weights):
    """The default prefill buckets are the lengths the flash kernel takes,
    so the engine pads such a prompt not at all (its prefill shapes are
    solo gpt_generate's) and any other prompt to the next of them."""
    from ray_lightning_tpu_torch.ops.flash_attention import takes_reference_path
    from ray_lightning_tpu_torch.serve.engine import default_buckets

    assert default_buckets(1024) == (
        tuple(range(8, 129, 8)) + tuple(range(256, 1025, 128))
    )
    assert default_buckets(100)[-1] == 100
    assert not any(takes_reference_path(n, n, causal=True)
                   for n in default_buckets(1024))
    eng = DecodeEngine(weights[1], CFG, num_slots=1, device="cpu")
    assert [eng.bucket_for(n) for n in (5, 40, 41, 64)] == [8, 40, 48, 64]
