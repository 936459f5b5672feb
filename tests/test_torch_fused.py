"""PyTorch port, fused dispatch on the CPU: piggybacked prefill chunks, the
fold-depth ladder and the pipelined (double-buffered) engine.

The piggybacked fold runs each chunk row with the separate chunk's own
code after the fold's iterations, so under ``attn_impl="reference"`` and
fp32 it matches the JAX fold with ``piggyback=`` at 1e-4 and the port's
fold followed by a separate chunk bit for bit. Through ``Scheduler`` ->
``DecodeEngine``, piggyback on or off and pipelined or not, dense and
paged, spec off and n-gram, every greedy request equals the port's solo
``gpt_generate`` and the JAX package's, and a sampled one its run alone.
A cancel that races a fold in flight surfaces no token of the cancelled
tenant and leaves a sampled batchmate's tokens as they were. The
piggyback, rung and page decisions equal the pipelined JAX engine's on
the same op stream.
"""
import dataclasses
import functools

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

#: GQA, as ``tests/test_serve.py:SERVE_CFG``: the caches carry Hkv < H heads.
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

#: ``tests/test_serve.py:PB_KW``: a chunked engine with two chunk rows
#: riding each decode dispatch.
PB_KW = dict(
    num_slots=3, max_seq=64, prefill_buckets=[16], prefill_chunk=4,
    decode_fold=2, piggyback_chunks=2,
)
#: The paged engine of ``tests/test_serve_paged.py:_paged``.
PAGED_KW = dict(kv_page=4, kv_pages=32)


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


_SOLO = {}


def _solo(weights, prompt, n, jax_too=False):
    """The port's solo ``gpt_generate`` (prompt and new tokens); with
    ``jax_too`` held once against the JAX package's (a compile per
    prompt length, so only the matrix below asks for it)."""
    key = (tuple(prompt), n)
    j_params, params = weights
    if key not in _SOLO:
        out = tgpt.gpt_generate(params, CFG, [prompt], n, device="cpu")
        _SOLO[key] = [out[0].tolist(), False]
    if jax_too and not _SOLO[key][1]:
        want = _jax_generate(j_params, JAX_CFG,
                             jnp.asarray([prompt], jnp.int32), n)
        assert _SOLO[key][0] == np.asarray(want)[0].tolist(), prompt
        _SOLO[key][1] = True
    return _SOLO[key][0]


def _engine(params, **kw):
    return DecodeEngine(params, CFG, device="cpu", **{**PB_KW, **kw})


# -- (a) the piggybacked fold -----------------------------------------------
_B, _S, _PAGE, _CB, _DEPTH, _FOLD = 3, 64, 4, 8, 2, 2


def _fold_case(paged: bool, spec: bool):
    """Slot 0 decodes; slot 1 takes a middle chunk (4 tokens at 4) and
    slot 2 its final chunk (3 tokens at 8, 5 new tokens); both are parked
    at the chunk's first row, where the fold's iterations write. Caches
    (or pools and a table of distinct pages) and the history are random.
    Returns numpy arrays and the rows as (slot, chunk, start, length,
    final, n_new)."""
    rng = np.random.default_rng(5)
    L, Hkv, hd = CFG.n_layer, CFG.kv_head, CFG.head_dim
    n_pages = 1 + _B * (_S // _PAGE)
    shape = (L, n_pages, _PAGE, Hkv, hd) if paged else (L, _B, _S, Hkv, hd)
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = (rng.permutation(np.arange(1, n_pages))
             .reshape(_B, _S // _PAGE).astype(np.int64)) if paged else None
    rows = [
        (1, rng.integers(0, 97, size=_CB), 4, 4, False, 0),
        (2, rng.integers(0, 97, size=_CB), 8, 3, True, 5),
    ]
    state = dict(
        cur=np.array([17, 0, 0]), pos=np.array([12, 4, 8]),
        active=np.array([True, False, False]), remaining=np.array([9, 0, 0]),
        eos=np.array([-1, -1, -1]),
        hist=rng.integers(0, 97, size=(_B, _S)) if spec else None,
    )
    return k, v, table, rows, state


def _port_fold(params, case, spec, piggyback):
    """The port's fold on the case; with ``piggyback`` the rows ride it,
    else they run afterwards as separate chunks, written out from
    ``gpt_prefill_chunk`` (or the paged one) and the first token's norm,
    head and argmax, as the engine ran a chunk before this slice."""
    k, v, table, rows, st = case
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    cur, pos, active, remaining = (t(st[n]) for n in
                                   ("cur", "pos", "active", "remaining"))
    zeros = torch.zeros(_B)
    tk, tv = t(k), t(v)
    paging = dict(page_table=t(table), page_size=_PAGE) if table is not None else {}
    chunk_rows = [
        tgpt.ChunkRow(slot=s, tokens=c, start=a, length=n, final=f, n_new=m)
        for s, c, a, n, f, m in rows
    ]
    args = (params, CFG, cur, pos, zeros.long(), zeros.long(), zeros,
            zeros.long(), torch.ones(_B), active, remaining, t(st["eos"]))
    pb = None
    if piggyback:
        pb = tgpt.ChunkRows(len(chunk_rows), _CB)
        pb.fill(chunk_rows)
    if spec:
        out = tgpt.gpt_decode_fold_spec(
            *args, t(st["hist"]), tk, tv, fold=_FOLD, depth=_DEPTH,
            draft_fn=functools.partial(tgpt.ngram_propose, depth=_DEPTH),
            piggyback=pb, **paging,
        )
        names = ["tok", "emit", "cur", "pos", "ctrs", "active", "remaining",
                 "hist", "k", "v"]
    else:
        out = tgpt.gpt_decode_fold(*args, tk, tv, fold=_FOLD, piggyback=pb,
                                   **paging)
        names = ["tok", "emit", "cur", "pos", "ctrs", "active", "remaining",
                 "k", "v"]
    res = dict(zip(names + ["pb"], out))
    if piggyback:
        return res
    pb_toks = []
    for r in chunk_rows:
        s = r.slot
        chunk = t(r.tokens)[None]
        if table is None:
            h, _, _ = tgpt.gpt_prefill_chunk(
                params, CFG, chunk, res["k"][:, s : s + 1],
                res["v"][:, s : s + 1], r.start, r.length)
        else:
            h, _, _ = tgpt.gpt_prefill_chunk_paged(
                params, CFG, chunk, res["k"], res["v"],
                paging["page_table"][s : s + 1], r.start, r.length,
                page=_PAGE)
        if spec:
            res["hist"][s, r.start : r.start + r.length] = chunk[0, : r.length]
        res["pos"][s] = r.start + r.length
        if not r.final:
            pb_toks.append(-1)
            continue
        hn = tgpt._make_norm(CFG)(h[:, r.length - 1 : r.length],
                                  params["lnf_g"], params["lnf_b"])
        tok = torch.argmax(tgpt._lm_head(hn[:, 0],
                                         tgpt._head_weight(params, CFG)))
        res["cur"][s] = tok
        res["active"][s] = (r.n_new > 1) & (tok != r.eos)
        res["remaining"][s] = r.n_new - 1
        res["ctrs"][s] = 1
        pb_toks.append(int(tok))
    res["pb"] = torch.tensor(pb_toks)
    return res


def _jax_fold(j_params, case, spec):
    """The JAX fold with ``piggyback=``, one row per chunk row (the JAX
    engine pads to ``piggyback_chunks`` with rows that are no-ops)."""
    k, v, table, rows, st = case
    C = len(rows)
    i32 = lambda x: jnp.asarray(np.asarray(x), jnp.int32)  # noqa: E731
    chunk = np.zeros((C, _CB), np.int32)
    cols = {n: np.zeros(C, np.int32) for n in ("start", "len", "slot", "n_new")}
    final, on = np.zeros(C, bool), np.zeros(C, bool)
    for r, (s, c, a, n, f, m) in enumerate(rows):
        chunk[r], final[r], on[r] = c, f, True
        cols["start"][r], cols["len"][r], cols["slot"][r] = a, n, s
        cols["n_new"][r] = m
    pb = (
        jnp.asarray(chunk), i32(cols["start"]), i32(cols["len"]),
        i32(cols["slot"]), jnp.zeros((C, 2), jnp.uint32),
        jnp.zeros(C, jnp.float32), jnp.zeros(C, jnp.int32),
        jnp.ones(C, jnp.float32), i32(cols["n_new"]), jnp.full(C, -1, jnp.int32),
        jnp.asarray(final), jnp.asarray(on),
    )
    paging = dict(page_table=i32(table), page_size=_PAGE) if table is not None else {}
    args = (j_params, JAX_CFG, i32(st["cur"]), i32(st["pos"]),
            jnp.zeros((_B, 2), jnp.uint32), jnp.zeros(_B, jnp.float32),
            jnp.zeros(_B, jnp.int32), jnp.ones(_B, jnp.float32),
            jnp.asarray(st["active"]), i32(st["remaining"]), i32(st["eos"]))
    if spec:
        out = jgpt.gpt_decode_fold_spec(
            *args, i32(st["hist"]), jnp.asarray(k), jnp.asarray(v),
            fold=_FOLD, depth=_DEPTH,
            draft_fn=functools.partial(jgpt.ngram_propose, depth=_DEPTH),
            piggyback=pb, **paging,
        )
        names = ["tok", "emit", "cur", "pos", "keys", "active", "remaining",
                 "hist", "k", "v", "pb"]
    else:
        out = jgpt.gpt_decode_fold(*args, jnp.asarray(k), jnp.asarray(v),
                                   fold=_FOLD, piggyback=pb, **paging)
        names = ["tok", "emit", "cur", "pos", "keys", "active", "remaining",
                 "k", "v", "pb"]
    return {n: np.asarray(x) for n, x in zip(names, out)}


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "ngram"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_piggybacked_fold_matches_jax_and_fold_then_chunk(weights, paged,
                                                          spec):
    """A fold carrying a middle and a final chunk row: bitwise the port's
    fold followed by those chunks run apart, and within 1e-4 of the JAX
    fold with ``piggyback=`` (tokens, state and history exactly; the
    scratch page, where both send rows nothing reads, is not compared).
    The JAX side runs on the dense plain and the paged n-gram fold, which
    between them reach every piece of the block (a JAX fold costs seconds
    of compiles on the CPU)."""
    j_params, params = weights
    params = tgpt.cast_params(params, CFG)
    fused = _port_fold(params, _fold_case(paged, spec), spec, piggyback=True)
    apart = _port_fold(params, _fold_case(paged, spec), spec, piggyback=False)
    assert fused.keys() == apart.keys()
    for name in fused:
        assert torch.equal(fused[name], apart[name]), name
    assert fused["pb"].tolist()[0] == -1 and fused["pb"].tolist()[1] >= 0
    assert bool(fused["active"][2])
    if paged != spec:
        return
    want = _jax_fold(j_params, _fold_case(paged, spec), spec)
    for name in fused:
        if name == "ctrs":  # the JAX fold returns its PRNG keys here
            continue
        got = fused[name].numpy()
        if name in ("k", "v"):
            got, ref = (got[:, 1:], want[name][:, 1:]) if paged else (
                got, want[name])
            np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        else:
            np.testing.assert_array_equal(got, want[name], err_msg=name)


# -- (b) the fused engine through the scheduler -----------------------------
def _workload(n_reqs=6):
    """``tests/test_serve.py:_run_sched_workload``'s requests (seed 11),
    the last one sampled."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(n_reqs):
        p = rng.integers(0, 97, size=int(rng.integers(5, 14))).tolist()
        sp = SamplingParams(max_new_tokens=int(rng.integers(3, 8)))
        if i == n_reqs - 1:
            sp = dataclasses.replace(sp, temperature=0.8, top_k=20, top_p=0.9,
                                     seed=7)
        reqs.append((f"r{i}", p, sp))
    return reqs


def _serve(eng, reqs, max_prefills=2):
    sched = Scheduler(eng, max_prefills_per_step=max_prefills)
    outs = {}
    for rid, p, sp in reqs:
        sched.submit(p, sp, request_id=rid)
        outs[rid] = []
    for ev in sched.run_until_idle():
        if ev.token is not None:
            outs[ev.request_id].append(ev.token)
    assert not sched.has_work() and eng.num_active == 0
    return outs, sched


def _alone(params, p, sp):
    """A request served alone by a monolithic engine without the pipeline:
    the reference of a sampled request's tokens."""
    eng = DecodeEngine(params, CFG, num_slots=1, max_seq=64,
                       prefill_buckets=[16], pipeline=False, device="cpu")
    return _serve(eng, [("x", p, sp)])[0]["x"]


@pytest.mark.parametrize("pipeline", [True, False], ids=["pipe", "nopipe"])
@pytest.mark.parametrize("pb", [2, 0], ids=["pb", "nopb"])
@pytest.mark.parametrize("spec", ["off", "ngram"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_fused_engine_matches_solo(weights, paged, spec, pb, pipeline):
    """tests/test_serve.py:1133 (piggyback on and off), :1149 (ngram spec
    with piggyback) and tests/test_serve_paged.py:574 (paged piggyback), in
    one matrix with the pipelined dispatch on and off: every greedy request
    equals the solo gpt_generate (the port's and the JAX package's), the
    sampled one its run alone; piggybacked rows ride dispatches only when
    on; at idle no page is referenced."""
    _, params = weights
    kw = dict(piggyback_chunks=pb, pipeline=pipeline)
    if spec == "ngram":
        kw.update(spec="ngram", spec_depth=2)
    if paged:
        kw.update(PAGED_KW, fold_ladder=[1, 2])
    eng = _engine(params, **kw)
    reqs = _workload()
    outs, _ = _serve(eng, reqs)
    for rid, p, sp in reqs:
        if sp.temperature > 0:
            assert outs[rid] == _alone(params, p, sp), rid
        else:
            assert p + outs[rid] == _solo(weights, p, sp.max_new_tokens,
                                          jax_too=True), rid
    if pb:
        assert eng.piggyback_dispatches > 0
        assert eng.piggyback_chunk_rows >= eng.piggyback_dispatches
    else:
        assert eng.piggyback_dispatches == 0
    for m in eng._pool_meta:
        assert m is None or m.refs == 0


def test_fold_ladder_switches_mid_stream(weights):
    """tests/test_serve.py:1160: a second wave lands mid-stream and forces
    the rung down for its piggybacked rows, then deep rungs take over as
    the queue drains: at least two rungs dispatched, every output exact
    (the compile count has no eager counterpart)."""
    _, params = weights
    rng = np.random.default_rng(29)
    wave1 = [(rng.integers(0, 97, size=9).tolist(), 8),
             (rng.integers(0, 97, size=6).tolist(), 7)]
    wave2 = [(rng.integers(0, 97, size=12).tolist(), 6),
             (rng.integers(0, 97, size=7).tolist(), 5)]
    eng = _engine(params, piggyback_chunks=3, fold_ladder=[1, 2, 4])
    sched = Scheduler(eng, max_prefills_per_step=2)
    outs = {}
    for i, (p, n) in enumerate(wave1):
        outs[sched.submit(p, SamplingParams(max_new_tokens=n),
                          request_id=f"w{i}")] = []
    for _ in range(4):
        for ev in sched.step():
            if ev.token is not None:
                outs[ev.request_id].append(ev.token)
    for j, (p, n) in enumerate(wave2):
        outs[sched.submit(p, SamplingParams(max_new_tokens=n),
                          request_id=f"w{len(wave1) + j}")] = []
    for ev in sched.run_until_idle():
        if ev.token is not None:
            outs[ev.request_id].append(ev.token)
    rungs = [k for k, v in eng.fold_dispatches.items() if v > 0]
    assert len(rungs) >= 2, eng.fold_dispatches
    for i, (p, n) in enumerate(wave1 + wave2):
        assert p + outs[f"w{i}"] == _solo(weights, p, n), f"w{i}"


def test_piggybacked_prefill_cancelled_between_dispatches(weights):
    """tests/test_serve.py:1216: a request whose chunks ride the fused
    dispatches is cancelled between two of them: its terminal reads
    `cancelled`, it emits nothing, and the survivor stays exact."""
    _, params = weights
    eng = _engine(params)
    sched = Scheduler(eng, max_prefills_per_step=2)
    rng = np.random.default_rng(31)
    p_keep = rng.integers(0, 97, size=5).tolist()
    p_dead = rng.integers(0, 97, size=13).tolist()  # 4 chunks of 4
    keep = sched.submit(p_keep, SamplingParams(max_new_tokens=8),
                        request_id="keep")
    evs = []
    for _ in range(3):
        evs += sched.step()
    dead = sched.submit(p_dead, SamplingParams(max_new_tokens=6),
                        request_id="dead")
    step = sched.step()  # one fused dispatch carries a `dead` chunk row
    assert not any(e.done for e in step if e.request_id == dead)
    assert eng.piggyback_dispatches > 0 and eng.num_prefilling == 1
    assert sched.cancel(dead)
    tail = sched.run_until_idle()
    got = [e.token for e in evs + step + tail
           if e.request_id == keep and e.token is not None]
    assert [e.reason for e in tail if e.request_id == dead] == ["cancelled"]
    assert not any(e.token is not None for e in step + tail
                   if e.request_id == dead)
    assert p_keep + got == _solo(weights, p_keep, 8)
    assert eng.num_active == 0 and not sched.has_work()


def test_piggybacked_final_cancelled_while_its_fold_is_in_flight(weights):
    """A prompt's final chunk rides fold N+1, which the pipelined step
    queues before it harvests fold N; the slot is released before fold
    N+1's harvest. Its first token is dropped there (no chunk event, no
    token), its pages wait in the quarantine until that harvest, and the
    resident decodes exactly."""
    _, params = weights
    eng = _engine(params, **PAGED_KW)
    rng = np.random.default_rng(3)
    p_keep = rng.integers(0, 97, size=6).tolist()
    p_dead = rng.integers(0, 97, size=7).tolist()  # 2 chunks of 4
    outs = {"keep": []}
    eng.admit(p_keep, request_id="keep", max_new_tokens=20)
    outs["keep"] += [t for _, _, t, _ in eng.pop_chunk_events()]
    for _ in range(2):  # keep's final rides the first fold
        outs["keep"] += [t for _, _, t, _ in eng.step()]
        outs["keep"] += [t for _, _, t, _ in eng.pop_chunk_events()]
    slot, _, _ = eng.admit(p_dead, request_id="dead", max_new_tokens=6)
    outs["keep"] += [t for _, _, t, _ in eng.step()]  # dead's 1st chunk
    assert not eng.pop_chunk_events()
    outs["keep"] += [t for _, _, t, _ in eng.step()]  # final now in flight
    assert eng._inflight is not None and eng.num_prefilling == 0
    assert [f[1] for f in eng._inflight.finals] == [slot]
    assert not eng.pop_chunk_events()
    eng.release(slot)
    assert eng._quarantine  # its pages wait for the in-flight fold
    seen = set()
    while eng.num_active:
        for _, rid, t, _ in eng.step():
            seen.add(rid)
            outs["keep"].append(t)
        assert not eng.pop_chunk_events()
    assert "dead" not in seen
    assert p_keep + outs["keep"] == _solo(weights, p_keep, 20)
    assert eng._inflight is None and not eng._quarantine


def test_scheduler_folded_pipelined_under_load(weights):
    """tests/test_serve.py:643: 8 overlapping requests through a folded
    (K=4) pipelined monolithic engine: outputs exact under queueing and
    continuous batching; the snapshot carries the rate, TTFT and
    decode-latency fields the JAX test reads."""
    _, params = weights
    eng = DecodeEngine(params, CFG, num_slots=3, max_seq=48,
                       prefill_buckets=[8, 16], decode_fold=4, device="cpu")
    assert eng.pipeline
    rng = np.random.default_rng(2)
    reqs = []
    for i in range(8):
        p = rng.integers(0, 97, size=int(rng.integers(3, 12))).tolist()
        reqs.append((f"q{i}", p,
                     SamplingParams(max_new_tokens=int(rng.integers(2, 9)))))
    outs, sched = _serve(eng, reqs)
    for rid, p, sp in reqs:
        assert p + outs[rid] == _solo(weights, p, sp.max_new_tokens), rid
    snap = sched.metrics.snapshot()
    assert snap["admitted"] == 8 and snap["finished"] == 8
    assert snap["tokens_per_sec"] > 0 and snap["steps_recorded"] > 0
    assert snap["ttft_max_s"] >= snap["ttft_p95_s"] >= snap["ttft_p50_s"] > 0
    assert snap["decode_tokens_per_sec"] > 0
    assert snap["step_time_p95_s"] >= snap["step_time_p50_s"] > 0
    assert snap["inter_token_p50_s"] > 0


def test_spec_cancel_with_verify_in_flight_and_recycle(weights):
    """tests/test_serve.py:831 with the pipeline on: a batchmate is
    cancelled while the next speculative verify is queued; none of its
    tokens surface or count toward the accept stats, the next tenant of
    its slot (admitted over the stale history) decodes exactly, and a
    sampled survivor's tokens equal its solo run."""
    _, params = weights
    kw = dict(max_seq=64, prefill_buckets=[8, 16], decode_fold=4,
              spec="ngram", spec_depth=3)
    sampled = dict(max_new_tokens=12, temperature=0.8, top_k=20, top_p=0.9,
                   seed=123)

    def run(num_slots, cancel):
        eng = DecodeEngine(params, CFG, num_slots=num_slots, device="cpu",
                           **kw)
        _, tok, _ = eng.admit(list(range(1, 7)), request_id="s", **sampled)
        outs = {"s": [tok]}
        if cancel:
            slot_v, _, _ = eng.admit(list(range(40, 48)), request_id="victim",
                                     max_new_tokens=30)
            for _, rid, t, _ in eng.step():
                outs.setdefault(rid, []).append(t)
            assert eng._inflight is not None  # the next verify is queued
            counted = eng.spec_stats()["emitted_tokens"]
            emitted = sum(len(v) for v in outs.values()) - 1
            assert counted == emitted
            eng.release(slot_v)
            assert eng.free_slots() == [slot_v]
            nxt = list(range(60, 66))
            slot2, ntok, _ = eng.admit(nxt, request_id="next",
                                       max_new_tokens=7)
            assert slot2 == slot_v
            outs["next"] = [ntok]
            outs["victim_after"] = []
        while eng.num_active:
            for _, rid, t, _ in eng.step():
                outs.setdefault(rid if rid != "victim" else "victim_after",
                                []).append(t)
        return eng, outs

    _, solo = run(1, cancel=False)
    eng, outs = run(2, cancel=True)
    assert outs["victim_after"] == []  # no zombie token surfaces
    assert list(range(60, 66)) + outs["next"] == _solo(
        weights, list(range(60, 66)), 7)
    assert outs["s"] == solo["s"]
    st = eng.spec_stats()
    emitted = len(outs["s"]) + len(outs["next"]) - 2 + len(outs["victim"])
    assert st["emitted_tokens"] == emitted  # zombies are not counted


# -- (c) decisions against the pipelined JAX engine -------------------------
def _op_stream():
    """Admissions, steps and a mid-prefill cancel through a paged engine
    with two piggybacked rows and the ladder [1, 2]: (op, args) pairs
    and the requests (none done at its first token)."""
    rng = np.random.default_rng(17)
    shared = rng.integers(0, 97, size=8).tolist()
    w = {
        "a": (shared + rng.integers(0, 97, size=5).tolist(), 9),
        "b": (rng.integers(0, 97, size=14).tolist(), 6),
        "c": (shared + rng.integers(0, 97, size=3).tolist(), 5),
        "d": (rng.integers(0, 97, size=10).tolist(), 12),
        "e": (rng.integers(0, 97, size=6).tolist(), 4),
    }
    ops = [("admit", "a"), ("step",), ("step",), ("step",), ("admit", "b"),
           ("admit", "c"), ("step",), ("step",), ("release", "b"),
           ("step",), ("admit", "d")] + [("step",)] * 6 + [("admit", "e")]
    ops += [("step",)] * 16
    return ops, w


def _run_op_stream(eng):
    """Tokens per request and, after each op, the fused and page
    counters, the rungs, the free pages, the quarantine and the table."""
    ops, w = _op_stream()
    slots, outs, trace = {}, {}, []
    for op, *args in ops:
        if op == "admit":
            p, n = w[args[0]]
            slots[args[0]], _, _ = eng.admit(p, request_id=args[0],
                                             max_new_tokens=n)
        elif op == "release":
            eng.release(slots[args[0]])
        else:
            for _, rid, tok, _ in eng.step():
                outs.setdefault(rid, []).append(tok)
            for _, task, tok, _ in eng.pop_chunk_events():
                outs.setdefault(task.request_id, []).append(tok)
        trace.append((
            op, eng.piggyback_dispatches, eng.piggyback_chunk_rows,
            dict(eng.fold_dispatches), eng.kv_page_counters(),
            eng.free_pages(), sorted(eng._quarantine),
            np.asarray(eng._table).tolist(),
        ))
    return outs, trace


FUSED_PAGED = dict(PB_KW, **PAGED_KW, fold_ladder=[1, 2])


@pytest.fixture(scope="module")
def jax_op_run(weights):
    """The pipelined JAX engine on the op stream (built once: it compiles
    at construction)."""
    from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine

    eng = JaxEngine(weights[0], JAX_CFG, **FUSED_PAGED)
    assert eng.pipeline
    return _run_op_stream(eng)


def test_fused_decisions_match_the_jax_engine(weights, jax_op_run):
    """The same op stream through the port's and the JAX engine, both
    pipelined: after every op the piggybacked dispatches and rows, the
    dispatches per rung, the page allocs, frees and alias hits, the free
    pages, the quarantine (so when it flushes) and the table are equal,
    and so are the tokens."""
    outs, trace = _run_op_stream(_engine(weights[1], **FUSED_PAGED))
    j_outs, j_trace = jax_op_run
    assert len(trace) == len(j_trace)
    for i, (got, want) in enumerate(zip(trace, j_trace)):
        assert got == want, (i, got[0])
    assert outs == j_outs
    assert trace[-1][1] > 0 and trace[-1][4]["alias_hits"] > 0
    assert sum(1 for v in trace[-1][3].values() if v) >= 2
    assert any(t[6] for t in trace)  # the quarantine held pages at times
