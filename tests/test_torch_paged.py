"""PyTorch port, paged KV, on the CPU.

The paged functions gather a slot's pages into the dense layout, run the
dense functions unchanged and scatter the rows they wrote back, so under
``attn_impl="reference"`` and fp32 they match the JAX package's paged
functions at 1e-4 and the port's dense functions bit for bit. The paged
engine serves greedy requests token-identical to the dense engine, to the
port's solo ``gpt_generate`` and to the JAX package's, aliases cached
prefix pages instead of copying them, and takes the same page decisions
(allocations, frees, alias hits, table rows) as the JAX engine on the same
op stream.
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

#: GQA: the page pool carries Hkv < H heads.
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

#: Logical bytes of one K+V page at kv_page=4 under CFG (tier budgets).
PAGE_BYTES = 2 * CFG.n_layer * 4 * CFG.kv_head * CFG.head_dim * 4

#: The paged engine of ``tests/test_serve_paged.py:_paged``.
PAGED = dict(
    num_slots=3, max_seq=64, prefill_buckets=[16], prefill_chunk=4,
    kv_page=4, kv_pages=32, decode_fold=2,
)


def _mb(n_pages: int) -> float:
    return n_pages * PAGE_BYTES / (1 << 20)


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


def _paged(params, **kw):
    return DecodeEngine(params, CFG, device="cpu", **{**PAGED, **kw})


def _dense(params, **kw):
    base = {k: v for k, v in PAGED.items() if not k.startswith("kv_")}
    return DecodeEngine(params, CFG, device="cpu", **{**base, **kw})


def _solo(params, prompt, n):
    return tgpt.gpt_generate(params, CFG, [prompt], n, device="cpu")[0].tolist()


def _jax_solo(j_params, prompt, n):
    out = _jax_generate(j_params, JAX_CFG, jnp.asarray([prompt], jnp.int32), n)
    return np.asarray(out)[0].tolist()


def _drive(eng, outs):
    """Interleave prefill chunks and folds until idle, collecting tokens
    per request id."""
    for _ in range(300):
        if not eng.num_active:
            break
        for _, task, tok, _ in eng.prefill_step(1):
            outs.setdefault(task.request_id, []).append(tok)
        for _, rid, tok, _ in eng.step():
            outs.setdefault(rid, []).append(tok)
    assert eng.num_active == 0


def _drive_one(eng, prompt, n, rid):
    eng.admit(prompt, request_id=rid, max_new_tokens=n)
    outs = {}
    _drive(eng, outs)
    return outs[rid]


def _workload(rng):
    """``tests/test_serve_paged.py:_workload``: cold inserts, alias hits
    (shared full pages), a long prompt and a fresh miss."""
    pA = rng.integers(0, 97, size=10).tolist()  # 2 full pages + tail
    pB = rng.integers(0, 97, size=14).tolist()
    pC = rng.integers(0, 97, size=22).tolist()  # 5 pages + tail
    return [
        ("r0", pA, 5),            # cold insert
        ("r1", pA, 4),            # full-prefix alias (2 pages)
        ("r2", pA + pB[:3], 6),   # shared 2 pages, fresh suffix
        ("r3", pB, 5),            # cold insert
        ("r4", pC, 6),            # long prompt
        ("r5", pB + pC[:2], 4),   # alias pB's pages
    ]


def _assert_idle_ledger(eng):
    for m in eng._pool_meta:
        assert m is None or m.refs == 0
    st = eng.kv_page_stats()
    assert st["aliased"] == 0
    assert st["allocs"] - st["frees"] == st["resident"], st


# -- (a) the paged primitives against the JAX ones and the dense port ------
def _pool_case(seed=0, B=3, n_pages=32, page=4):
    """Random pools and a table of distinct real pages per slot; the
    entries past them stay on the scratch page (0)."""
    rng = np.random.default_rng(seed)
    n = CFG.max_seq // page
    shape = (CFG.n_layer, n_pages, page, CFG.kv_head, CFG.head_dim)
    pk, pv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    table = np.zeros((B, n), np.int64)
    real = rng.permutation(np.arange(1, n_pages))
    table[0, :6], table[1, :16], table[2, :4] = real[:6], real[6:22], real[22:26]
    return rng, pk, pv, table


def _jnp(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize(
    "fn", ["paged_gather", "paged_put_rows", "gpt_decode_step_paged",
           "gpt_prefill_chunk_paged"],
)
def test_paged_primitives_match_jax_and_the_dense_port(weights, fn):
    """Each paged primitive against the JAX one (1e-4; the pure gathers and
    scatters exactly) and bitwise against the port's dense function on the
    gathered view; rows sent to the scratch page (0) are not compared."""
    j_params, params = weights
    page = 4
    rng, pk, pv, table = _pool_case()
    if fn == "paged_gather":
        got = tgpt.paged_gather(_t(pk), _t(table), page)
        want = jgpt.paged_gather(_jnp(pk), _jnp(table), page)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    if fn == "paged_put_rows":
        rows = np.array([[0, 5, 23], [60, 63, 70], [2, 3, 17]])
        valid = np.array([[True, True, False], [True, True, False],
                          [True, True, True]])
        vals = rng.standard_normal(
            (CFG.n_layer, 3, 3, CFG.kv_head, CFG.head_dim)
        ).astype(np.float32)
        got = tgpt.paged_put_rows(_t(pk).clone(), _t(table), _t(rows),
                                  _t(vals), _t(valid), page)
        want = jgpt.paged_put_rows(_jnp(pk), _jnp(table), _jnp(rows),
                                   _jnp(vals), _jnp(valid), page)
        np.testing.assert_array_equal(got[:, 1:].numpy(),
                                      np.asarray(want)[:, 1:])
        return
    cdt_params = tgpt.cast_params(params, CFG)
    if fn == "gpt_decode_step_paged":
        # Slot 1 sits at the cache end (a frozen slot): its write clamps to
        # row S - 1, through its table, as the dense step's does.
        cur = np.array([3, 41, 90])
        pos = np.array([21, 64, 9])
        args = (_t(cur), _t(pos))
        logits, tk, tv = tgpt.gpt_decode_step_paged(
            cdt_params, CFG, *args, _t(pk).clone(), _t(pv).clone(),
            _t(table), page,
        )
        jl, jk, jv = jgpt.gpt_decode_step_paged(
            j_params, JAX_CFG, _jnp(cur.astype(np.int32)),
            _jnp(pos.astype(np.int32)), _jnp(pk), _jnp(pv), _jnp(table),
            page,
        )
        dk = tgpt.paged_gather(_t(pk), _t(table), page)
        dv = tgpt.paged_gather(_t(pv), _t(table), page)
        dl, dk, dv = tgpt.gpt_decode_step(cdt_params, CFG, *args, dk, dv)
        assert torch.equal(logits, dl)
    else:
        # One slot's chunk of 6 rows from position 13, 4 of them real.
        chunk = rng.integers(0, 97, size=(1, 6))
        trow = table[1:2]
        h, tk, tv = tgpt.gpt_prefill_chunk_paged(
            cdt_params, CFG, _t(chunk), _t(pk).clone(), _t(pv).clone(),
            _t(trow), 13, 4, page=page,
        )
        jh, jk, jv = jgpt.gpt_prefill_chunk_paged(
            j_params, JAX_CFG, _jnp(chunk.astype(np.int32)), _jnp(pk),
            _jnp(pv), _jnp(trow), 13, 4, page=page,
        )
        dk = tgpt.paged_gather(_t(pk), _t(trow), page)
        dv = tgpt.paged_gather(_t(pv), _t(trow), page)
        dh, dk, dv = tgpt.gpt_prefill_chunk(cdt_params, CFG, _t(chunk),
                                            dk, dv, 13, 4)
        assert torch.equal(h, dh)
        jl, logits = jh, h
        table = trow
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got[:, 1:].numpy(), np.asarray(want)[:, 1:],
                                   atol=1e-4, rtol=1e-4)
    # Bitwise: the pool's pages seen through the table are the dense rows.
    assert torch.equal(tgpt.paged_gather(tk, _t(table), page), dk)
    assert torch.equal(tgpt.paged_gather(tv, _t(table), page), dv)


# -- (b) the paged engine ---------------------------------------------------
def test_paged_exactness_alias_and_ledger(weights):
    """Cold inserts, copy-free alias hits and a long prompt: every greedy
    output equals the port's solo gpt_generate and the JAX package's; alias
    hits happen; at idle no page is referenced and the ledger balances."""
    j_params, params = weights
    workload = _workload(np.random.default_rng(7))
    eng = _paged(params)
    outs = {rid: _drive_one(eng, p, n, rid) for rid, p, n in workload}
    assert eng.page_alias_hits > 0 and eng.prefix_inserts > 0
    for rid, p, n in workload:
        solo = _solo(params, p, n)
        assert p + outs[rid] == solo, rid
        assert solo == _jax_solo(j_params, p, n), rid
    _assert_idle_ledger(eng)
    assert eng._k is None and eng._v is None  # no dense strips


def test_paged_vs_dense_same_tokens(weights):
    """Paged and dense engines on the same cold, full-alias and
    partial-alias requests give the same tokens."""
    _, params = weights
    workload = _workload(np.random.default_rng(11))[:3]
    paged, dense = _paged(params), _dense(params)
    for rid, p, n in workload:
        assert _drive_one(paged, p, n, rid) == _drive_one(dense, p, n, rid), rid


def test_paged_mid_prefill_cancel_page_recycle(weights):
    """A request cancelled mid-prefill while another aliases the same
    prefix pages: the cancel drops its refs without freeing the shared
    pages, its private pages recycle, and every stream stays exact."""
    _, params = weights
    eng = _paged(params, prefill_chunk=2)
    rng = np.random.default_rng(13)
    shared = rng.integers(0, 97, size=8).tolist()  # exactly 2 pages
    pA = shared + rng.integers(0, 97, size=6).tolist()
    pB = shared + rng.integers(0, 97, size=4).tolist()
    warm = _drive_one(eng, shared + [3], 3, "warm")
    slot_a, _, _ = eng.admit(pA, request_id="victim", max_new_tokens=6)
    eng.admit(pB, request_id="survivor", max_new_tokens=6)
    shared_pages = [i for i, m in enumerate(eng._pool_meta)
                    if m is not None and m.refs == 2]
    assert len(shared_pages) == 2, shared_pages
    eng.prefill_step(1)  # the victim is mid-prefill
    eng.release(slot_a)
    for pg in shared_pages:
        assert eng._pool_meta[pg] is not None and eng._pool_meta[pg].refs == 1
    outs = {}
    _drive(eng, outs)
    assert pB + outs["survivor"] == _solo(params, pB, 6)
    assert shared + [3] + warm == _solo(params, shared + [3], 3)
    _assert_idle_ledger(eng)
    pC = rng.integers(0, 97, size=10).tolist()
    assert pC + _drive_one(eng, pC, 4, "re") == _solo(params, pC, 4)


def test_paged_every_page_referenced_parks_not_deadlocks(weights):
    """Every page referenced: the scheduler's page-aware admission parks
    the queue head (counted in kv_backpressure_steps) until residents
    finish; nothing deadlocks, no admission fails in the engine, and every
    request completes exactly."""
    _, params = weights
    # 9 usable pages; each request needs 3, so three residents fill them.
    eng = _paged(params, num_slots=8, kv_page=8, kv_pages=10,
                 prefill_chunk=8, decode_fold=1)
    sched = Scheduler(eng, max_prefills_per_step=8)
    rng = np.random.default_rng(5)
    outs = {}
    for _ in range(5):
        p = rng.integers(0, 97, size=10).tolist()
        outs[sched.submit(p, SamplingParams(max_new_tokens=6))] = (p, [])
    saw_saturated = False
    for _ in range(400):
        if not sched.has_work():
            break
        for e in sched.step():
            if e.token is not None:
                outs[e.request_id][1].append(e.token)
        if eng.pages_available() == 0 and sched.queue_depth() > 0:
            saw_saturated = True
    assert not sched.has_work(), "deadlocked under page pressure"
    assert saw_saturated and sched.kv_backpressure_steps > 0
    for rid, (p, out) in outs.items():
        assert p + out == _solo(params, p, 6), rid
    _assert_idle_ledger(eng)


def test_paged_tiered_spill_promote_exact(weights, tmp_path):
    """The host and disk tiers work on pages: pool pressure spills evicted
    cache pages into them, a revisit promotes them back and aliases them,
    and every output stays exact."""
    _, params = weights
    # 17 usable pages (the minimum for max_seq 64 / page 4): ten prompts of
    # 2 cache pages each want 20, so round 1 already evicts.
    eng = _paged(params, num_slots=2, kv_pages=18, prefix_host_mb=_mb(4),
                 prefix_disk_dir=str(tmp_path / "disk"), prefix_disk_mb=1.0)
    assert eng.paged and eng._tiered
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, 97, size=10).tolist() for _ in range(10)]
    outs = {f"a{i}": (p, _drive_one(eng, p, 4, f"a{i}"))
            for i, p in enumerate(prompts)}
    # Round 2 revisits the oldest half: their pages were the victims.
    outs.update({f"b{i}": (p, _drive_one(eng, p, 4, f"b{i}"))
                 for i, p in enumerate(prompts[:5])})
    tc = eng.tier_counters
    assert tc["device"]["spills"] > 0, tc
    assert tc["host"]["hits"] + tc["disk"]["hits"] > 0, tc
    assert tc["host"]["promotions"] + tc["disk"]["promotions"] > 0, tc
    assert eng.page_alias_hits > 0
    for rid, (p, out) in outs.items():
        assert p + out == _solo(params, p, 4), rid
    _assert_idle_ledger(eng)


def test_paged_knob_validation(weights):
    _, params = weights
    kw = dict(num_slots=1, max_seq=32, prefill_buckets=[16], device="cpu")
    with pytest.raises(ValueError, match="kv_pages > 0"):
        DecodeEngine(params, CFG, kv_page=4, **kw)
    with pytest.raises(ValueError, match="divide"):
        DecodeEngine(params, CFG, kv_page=5, kv_pages=16, **kw)
    with pytest.raises(ValueError, match="max-length request"):
        DecodeEngine(params, CFG, kv_page=4, kv_pages=4, **kw)
    with pytest.raises(ValueError, match="unifies the prefix pool"):
        DecodeEngine(params, CFG, kv_page=4, kv_pages=16, prefix_blocks=2,
                     **kw)
    eng = DecodeEngine(params, CFG, kv_pages=16, **kw)
    # Paging implies chunked prefill and a 16-position default page; the
    # pool takes the prefix pool's place.
    assert eng.paged and eng.chunked and eng.kv_page == 16
    assert (eng.prefix_blocks, eng.prefix_block) == (16, 16)
    assert eng.free_pages() == 15  # page 0 is scratch
    eng = _paged(params)
    assert eng.pages_for(10, 6) == (10 + 6) // 4 + 1
    # pages_for clamps at the cache end, as the dense write does.
    assert eng.pages_for(50, 14) == (64 - 1) // 4 + 1


def test_paged_residency_beats_dense_at_fixed_budget(weights):
    """At the same KV token budget (256 tokens) the paged engine holds at
    least 1.5x the dense engine's concurrent residents on short requests,
    and both give the same tokens."""
    _, params = weights
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, 97, size=10).tolist() for _ in range(10)]

    def run(paged):
        eng = (
            _paged(params, num_slots=12, kv_page=8, kv_pages=33,
                   prefill_chunk=8)
            if paged
            else _dense(params, num_slots=4, prefill_chunk=8)  # 4 x 64
        )
        sched = Scheduler(eng, max_prefills_per_step=12)
        outs = {sched.submit(p, SamplingParams(max_new_tokens=6)): []
                for p in prompts}
        max_res = 0
        while sched.has_work():
            for e in sched.step():
                if e.token is not None:
                    outs[e.request_id].append(e.token)
            max_res = max(max_res, eng.num_active)
        return max_res, list(outs.values())

    dense_res, dense_out = run(False)
    paged_res, paged_out = run(True)
    assert paged_out == dense_out
    assert paged_res >= 1.5 * dense_res, (paged_res, dense_res)


def test_scheduler_paged_metrics(weights):
    """The scheduler diffs the page counters into ServeMetrics: the
    snapshot's kv_pages block carries the pool's state and counters."""
    _, params = weights
    sched = Scheduler(_paged(params))
    pA = np.random.default_rng(31).integers(0, 97, size=10).tolist()
    for p in (pA, pA):  # insert, then alias
        sched.submit(p, SamplingParams(max_new_tokens=4))
        sched.run_until_idle()
    kv = sched.metrics.snapshot()["kv_pages"]
    assert kv["page_size"] == 4 and kv["pages_total"] == 31
    assert kv["token_budget"] == 31 * 4
    assert kv["alias_hits"] > 0 and kv["allocs"] > 0
    assert kv["fragmentation_tokens"] >= 0
    assert 0.0 <= kv["occupancy"] <= 1.0
    assert kv == sched.engine.kv_page_stats()
    assert "kv_pages" not in Scheduler(_dense(params)).metrics.snapshot()


# -- (c) page decisions against the JAX engine ------------------------------
def _op_stream():
    """Admissions, alias hits, a concurrent pair, a mid-prefill cancel and
    a long prompt, as (op, args) pairs."""
    rng = np.random.default_rng(7)
    w = {rid: (p, n) for rid, p, n in _workload(rng)}
    return [
        ("admit", "r0"), ("drain",), ("admit", "r1"), ("drain",),
        ("admit", "r2"), ("admit", "r3"), ("prefill",), ("release", "r3"),
        ("drain",), ("admit", "r4"), ("admit", "r5"), ("drain",),
        ("admit", "r3"), ("drain",),
    ], w


def _run_op_stream(eng):
    """Tokens per request and, after each op, the page counters, the page
    table and the free-page count."""
    ops, w = _op_stream()
    slots, outs, trace = {}, {}, []
    for op, *args in ops:
        if op == "admit":
            p, n = w[args[0]]
            slots[args[0]], _, _ = eng.admit(p, request_id=args[0],
                                             max_new_tokens=n)
        elif op == "prefill":
            for _, task, tok, _ in eng.prefill_step(1):
                outs.setdefault(task.request_id, []).append(tok)
        elif op == "release":
            eng.release(slots[args[0]])
            outs.pop(args[0], None)
        else:
            _drive(eng, outs)
        trace.append((
            eng.kv_page_counters(), np.asarray(eng._table).tolist(),
            eng.free_pages(),
        ))
    return outs, trace


@pytest.fixture(scope="module")
def jax_op_run(weights):
    """The JAX engine on the op stream (built once: it compiles at
    construction), without the pipelined dispatch, whose quarantine would
    hold freed pages one fold longer than the port does."""
    from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine

    return _run_op_stream(JaxEngine(weights[0], JAX_CFG, pipeline=False,
                                    **PAGED))


def test_page_decisions_match_the_jax_engine(weights, jax_op_run):
    """The same op stream through the port's and the JAX engine, both
    without the pipelined dispatch: after every op the allocs, frees and
    alias hits, each slot's table row and the free pages are equal, and so
    are the tokens."""
    _, params = weights
    outs, trace = _run_op_stream(_paged(params, pipeline=False))
    j_outs, j_trace = jax_op_run
    assert len(trace) == len(j_trace)
    for i, (got, want) in enumerate(zip(trace, j_trace)):
        assert got == want, (i, _op_stream()[0][i])
    assert trace[-1][0]["alias_hits"] > 0
    assert outs == j_outs
