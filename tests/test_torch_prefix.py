"""PyTorch port, chunked prefill and the tiered prefix cache, on the CPU.

Under ``attn_impl="reference"`` and fp32 the port's ``gpt_prefill_chunk``
matches the JAX package's at 1e-5; the chunked, prefix-cached and tiered
engine serves every greedy request token-identical to the port's solo
``gpt_generate`` and to the JAX package's; and the pool's and tiers'
decisions, a function of the op stream alone, give the same per-tier
counters as the JAX engine on the same workload.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.serve.engine import DecodeEngine, chunk_buckets
from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

#: GQA: the slot cache and the pool carry Hkv < H heads.
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

#: Logical bytes of one K+V pool block at prefix_block=4 under CFG.
BLK_BYTES = 2 * CFG.n_layer * 4 * CFG.kv_head * CFG.head_dim * 4

#: The tier workload's engine (``tests/test_serve_tiered.py:_engine``).
TIER_ENGINE = dict(
    num_slots=2, max_seq=64, prefill_buckets=[16], prefill_chunk=4,
    prefix_blocks=2, prefix_block=4, decode_fold=2,
)


def _mb(n_blocks: int) -> float:
    """A MiB budget holding exactly ``n_blocks`` pool blocks."""
    return n_blocks * BLK_BYTES / (1 << 20)


def _numpy_tree(cfg, seed=0):
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
    tree = _numpy_tree(CFG)
    return (
        jax.tree_util.tree_map(jnp.asarray, tree),
        params_from_jax(tree, CFG, "cpu"),
    )


def _solo(params, prompt, n, cfg=CFG):
    return tgpt.gpt_generate(params, cfg, [prompt], n, device="cpu")[0].tolist()


def _jax_solo(j_params, prompt, n):
    out = _jax_generate(j_params, JAX_CFG, jnp.asarray([prompt], jnp.int32), n)
    return np.asarray(out)[0].tolist()


def _engine(params, cfg=CFG, **kw):
    return DecodeEngine(params, cfg, device="cpu", **kw)


def _drive(eng, outs, join=None):
    """Interleave prefill chunks and folds until idle, collecting tokens
    per request id; ``join()`` runs once when a slot first frees."""
    for _ in range(300):
        if not eng.num_active:
            break
        for _, task, tok, _ in eng.prefill_step(1):
            outs.setdefault(task.request_id, []).append(tok)
        for _, rid, tok, _ in eng.step():
            outs.setdefault(rid, []).append(tok)
        if join is not None and eng.free_slots():
            join()
            join = None
    assert eng.num_active == 0


def _drive_one(eng, prompt, n, rid):
    """Admit one request and drive the engine to idle; its tokens."""
    eng.admit(prompt, request_id=rid, max_new_tokens=n)
    outs = {}
    _drive(eng, outs)
    return outs[rid]


# -- (a) the chunk function against the JAX package ------------------------
_CHUNK_CASES = {
    "learned-start0-full": dict(start=0, true_len=8),
    "learned-start13-ragged": dict(start=13, true_len=5),
    "rope-start13-ragged": dict(start=13, true_len=5, pos_embed="rope"),
    "window-sinks-start21": dict(start=21, true_len=6, attn_window=6,
                                 attn_sinks=2),
    "learned-past-the-end": dict(start=58, true_len=6),
}


@pytest.mark.parametrize("case", sorted(_CHUNK_CASES))
def test_prefill_chunk_matches_jax(case):
    """Hidden states and both caches at 1e-5: a chunk at position 0 and
    past it, ragged (``true_len < C``), learned and rope positions, window
    and sinks, and a chunk whose padded rows run past the cache end."""
    kw = dict(_CHUNK_CASES[case])
    start, tl = kw.pop("start"), kw.pop("true_len")
    jcfg = dataclasses.replace(JAX_CFG, **kw)
    cfg = tgpt.GPTConfig(**dataclasses.asdict(jcfg))
    tree = _numpy_tree(cfg, seed=1)
    rng = np.random.default_rng(2)
    C, S = 8, cfg.max_seq
    chunk = rng.integers(0, cfg.vocab_size, (1, C))
    shape = (cfg.n_layer, 1, S, cfg.kv_head, cfg.head_dim)
    kc, vc = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jh, jk, jv = jax.jit(jgpt.gpt_prefill_chunk, static_argnums=1)(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        jnp.asarray(chunk, jnp.int32), jnp.asarray(kc), jnp.asarray(vc),
        jnp.int32(start), jnp.int32(tl),
    )
    th, tk, tv = tgpt.gpt_prefill_chunk(
        params_from_jax(tree, cfg, "cpu"), cfg, torch.from_numpy(chunk),
        torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()), start, tl,
    )
    np.testing.assert_allclose(th[:, :tl].numpy(), np.asarray(jh)[:, :tl],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    # Only rows [start, start + true_len) were written.
    end = min(S, start + tl)
    untouched = np.ones(S, bool)
    untouched[start:end] = False
    assert np.array_equal(tk.numpy()[:, :, untouched], kc[:, :, untouched])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda_hw)]
)
def test_prefill_rows_do_not_depend_on_the_chunking(weights, dtype, device):
    """A prompt's cache rows and last hidden state are bitwise the same
    prefilled whole (``gpt_prefill`` under the reference attention) or in
    chunks of 5, 16 and 3 rows: what lets a chunked or prefix-seeded slot
    match a solo run, on the card too."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dataclasses.replace(CFG, compute_dtype=dtype)
    dev = torch.device(device)
    params = tgpt.cast_params(tgpt.params_to(weights[1], dev), cfg)
    prompt = torch.from_numpy(
        np.random.default_rng(4).integers(0, 97, (1, 24))
    ).to(dev)
    h, k, v = tgpt.gpt_prefill(params, cfg, prompt)
    shape = (cfg.n_layer, 1, cfg.max_seq, cfg.kv_head, cfg.head_dim)
    kc = torch.zeros(shape, dtype=tgpt.compute_dtype(cfg), device=dev)
    vc = torch.zeros_like(kc)
    start = 0
    for n in (5, 16, 3):
        hc, _, _ = tgpt.gpt_prefill_chunk(
            params, cfg, prompt[:, start : start + n], kc, vc, start
        )
        start += n
    assert torch.equal(kc[:, :, :24], k) and torch.equal(vc[:, :, :24], v)
    assert torch.equal(hc[:, -1], h[:, -1])


# -- (b) chunked engine against solo runs -----------------------------------
@pytest.mark.parametrize("chunk", [4, 8, 64])
def test_engine_chunked_prefill_matches_solo_and_jax(weights, chunk):
    """Chunks smaller than, comparable to and covering the prompt bucket;
    a prompt over the largest prompt bucket; a request joining mid-flight:
    every greedy output equals the port's solo and the JAX gpt_generate."""
    j_params, params = weights
    eng = _engine(params, num_slots=3, max_seq=64, prefill_buckets=[8, 16],
                  prefill_chunk=chunk, decode_fold=2)
    rng = np.random.default_rng(0)
    reqs = [
        (rng.integers(0, 97, size=5).tolist(), 7),
        (rng.integers(0, 97, size=11).tolist(), 4),
        # Over the largest (16) prompt bucket: only chunking admits this.
        (rng.integers(0, 97, size=20).tolist(), 6),
    ]
    for i, (p, n) in enumerate(reqs):
        slot, tok, done = eng.admit(p, request_id=f"r{i}", max_new_tokens=n)
        assert tok is None and not done  # the first token rides prefill_step
    assert eng.num_prefilling == 3 and not eng.free_slots()
    late = (rng.integers(0, 97, size=6).tolist(), 5)

    def join():
        eng.admit(late[0], request_id="r3", max_new_tokens=late[1])
        reqs.append(late)

    outs = {}
    _drive(eng, outs, join)
    assert len(reqs) == 4
    for i, (p, n) in enumerate(reqs):
        solo = _solo(params, p, n)
        assert p + outs[f"r{i}"] == solo, f"r{i}"
        assert solo == _jax_solo(j_params, p, n), f"r{i}"


# -- (c) the device prefix pool ---------------------------------------------
def test_prefix_cache_hit_and_miss_exact(weights):
    """A request sharing a prefix seeds its rows from the pool and
    prefills only the suffix; outputs equal solo on hit and miss, and the
    seeded rows are bitwise the pool's blocks."""
    _, params = weights
    eng = _engine(params, num_slots=2, max_seq=64, prefill_buckets=[8, 16],
                  prefill_chunk=4, prefix_blocks=8, prefix_block=4,
                  decode_fold=2)
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, 97, size=8).tolist()
    a = prefix + rng.integers(0, 97, size=3).tolist()
    b = prefix + rng.integers(0, 97, size=5).tolist()
    c = rng.integers(0, 97, size=9).tolist()  # unrelated: a miss
    for rid, (p, n) in zip("abc", [(a, 6), (b, 7), (c, 5)]):
        hits = eng.tier_counters["device"]["hits"]
        slot, _, _ = eng.admit(p, request_id=rid, max_new_tokens=n)
        if rid == "b":
            assert eng.tier_counters["device"]["hits"] == hits + 2
            assert eng._prefills[slot].next == 8
            for j, d in enumerate(eng._block_digests(np.asarray(prefix))):
                blk = eng._pool_map[d]
                assert torch.equal(eng._k[:, slot, 4 * j : 4 * j + 4],
                                   eng._pool_k[:, blk])
        outs = {}
        _drive(eng, outs)
        assert p + outs[rid] == _solo(params, p, n), rid
    stats = eng.prefix_stats()
    assert stats["hit_tokens"] == len(prefix)
    # a: 2 full blocks; b: 1 past the shared 2; c: 2.
    assert stats["lookups"] == 3 and stats["inserts"] == 2 + 1 + 2
    assert eng.prefix_hit_tokens / eng.prefix_prompt_tokens > 0


def test_prefix_cache_lru_eviction_and_refcounts(weights):
    """Distinct prefixes overflow a 3-block pool: LRU eviction of
    unpinned blocks, refcounts back at 0, and an evicted prefix misses and
    still decodes exactly."""
    _, params = weights
    eng = _engine(params, num_slots=1, max_seq=64, prefill_buckets=[8, 16],
                  prefill_chunk=4, prefix_blocks=3, prefix_block=4,
                  decode_fold=1)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 97, size=12).tolist() for _ in range(4)]
    for i, p in enumerate(prompts):
        assert p + _drive_one(eng, p, 4, f"p{i}") == _solo(params, p, 4)
    stats = eng.prefix_stats()
    assert stats["evictions"] > 0
    assert stats["blocks_used"] == stats["blocks_total"] == 3
    assert all(m is None or m.refs == 0 for m in eng._pool_meta)
    # The last prompt's blocks are the pool's newest.
    newest = eng._block_digests(np.asarray(prompts[-1]))
    assert all(d in eng._pool_map for d in newest)
    assert not any(
        d in eng._pool_map for d in eng._block_digests(np.asarray(prompts[0]))
    )
    assert prompts[0] + _drive_one(eng, prompts[0], 6, "again") == _solo(
        params, prompts[0], 6
    )


def test_mid_prefill_cancel_and_recycle(weights):
    """A release strictly inside a chunked prefill drops the state
    machine, unpins the prefix blocks and frees the slot; the next tenant
    of that half-prefilled slot decodes exactly."""
    _, params = weights
    eng = _engine(params, num_slots=1, max_seq=64, prefill_buckets=[8, 16],
                  prefill_chunk=4, prefix_blocks=4, prefix_block=4,
                  decode_fold=2)
    rng = np.random.default_rng(5)
    victim = rng.integers(0, 97, size=16).tolist()
    _drive_one(eng, victim[:9], 2, "warm")  # pool holds victim's 2 blocks
    slot, tok, done = eng.admit(victim, request_id="victim", max_new_tokens=8)
    assert tok is None and not done
    assert [m.refs for m in eng._pool_meta if m is not None] == [1, 1]
    assert eng.prefill_step(1) == []  # one chunk in, prefill unfinished
    eng.release(slot)  # mid-prefill cancel
    assert eng.num_active == 0 and eng.free_slots() == [0]
    assert all(m is None or m.refs == 0 for m in eng._pool_meta)
    assert not eng.device_state()["active"][slot]
    nxt = rng.integers(0, 97, size=7).tolist()
    assert nxt + _drive_one(eng, nxt, 7, "next") == _solo(params, nxt, 7)


# -- (d) the spill tiers ----------------------------------------------------
def _tier_workload():
    """``tests/test_serve_tiered.py:_tier_workload``: device hits (r1),
    host hits (r3), disk hits (r6) and a miss through every tier (r7),
    through a 2-block pool, a 4-block host tier and a disk tier."""
    rng = np.random.default_rng(7)
    pA, pB, pC, pD, pE = (rng.integers(0, 97, size=10).tolist()
                          for _ in range(5))
    return [
        ("r0", pA, 5), ("r1", pA + pD[:1], 4), ("r2", pB, 5), ("r3", pA, 5),
        ("r4", pC, 5), ("r5", pD, 5), ("r6", pB, 5), ("r7", pE, 5),
    ]


def _run_tier_workload(eng):
    """Tokens per request id, and the per-tier counters after each."""
    outs, counters = {}, []
    for rid, p, n in _tier_workload():
        outs[rid] = _drive_one(eng, p, n, rid)
        counters.append(eng.prefix_tier_counters())
    return outs, counters


def _tier_kw(path):
    return dict(prefix_host_mb=_mb(4), prefix_disk_dir=str(path),
                prefix_disk_mb=1.0)


def _disk_form(path):
    """{file name: (dtype, shape)} of a disk tier, and its keys files."""
    form, keys = {}, {}
    for name in sorted(os.listdir(path)):
        arr = np.load(os.path.join(path, name))
        form[name] = (arr.dtype.str, arr.shape)
        if name.endswith(".keys.npy"):
            keys[name] = arr.tolist()
    return form, keys


@pytest.fixture(scope="module")
def jax_tier_run(weights, tmp_path_factory):
    """The JAX engine on the tier workload, run once (it compiles at
    construction): its tokens and per-tier counters after each request,
    the digests of each prompt and its disk tier's files."""
    from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine

    disk = tmp_path_factory.mktemp("jax-disk")
    eng = JaxEngine(weights[0], JAX_CFG, **TIER_ENGINE, **_tier_kw(disk))
    outs, counters = _run_tier_workload(eng)
    digests = [eng._block_digests(np.asarray(p, np.int32))
               for _, p, _ in _tier_workload()]
    return outs, counters, digests, _disk_form(disk)


def test_tier_workload_matches_the_jax_engine(weights, jax_tier_run, tmp_path):
    """Device, host and disk hits and a miss: the port's tokens equal the
    JAX engine's and its own solo runs, its per-tier counters equal the
    JAX engine's after every request, its digests are the JAX engine's,
    and its disk tier holds the same files in the same form."""
    _, params = weights
    eng = _engine(params, **TIER_ENGINE, **_tier_kw(tmp_path / "disk"))
    outs, counters = _run_tier_workload(eng)
    j_outs, j_counters, j_digests, j_disk = jax_tier_run
    assert counters == j_counters
    assert [eng._block_digests(np.asarray(p)) for _, p, _ in
            _tier_workload()] == j_digests
    assert _disk_form(tmp_path / "disk") == j_disk and j_disk[0]
    tc = eng.tier_counters
    for tier, kind in (("device", "hits"), ("host", "hits"), ("disk", "hits"),
                       ("device", "spills"), ("host", "spills"),
                       ("host", "promotions"), ("disk", "promotions")):
        assert tc[tier][kind] > 0, (tier, kind, tc)
    assert eng.refill_s > 0.0
    assert outs == j_outs
    for rid, p, n in _tier_workload():
        assert p + outs[rid] == _solo(params, p, n), rid


def test_host_and_disk_budgets_never_exceeded(weights, tmp_path):
    """The host tier holds at most its budget, the disk tier at most its
    budget in measured file bytes; the cascade device -> host -> disk ->
    dropped keeps LRU order, and the files on disk are the map's."""
    _, params = weights
    disk_dir = tmp_path / "budget"
    eng = _engine(
        params, **TIER_ENGINE, prefix_host_mb=_mb(2),
        prefix_disk_dir=str(disk_dir),
        # ~2 blocks with the .npy headers and the keys file.
        prefix_disk_mb=(2 * BLK_BYTES + 4096) / (1 << 20),
    )
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 97, size=10).tolist() for _ in range(6)]
    for i, p in enumerate(prompts):
        _drive_one(eng, p, 3, f"r{i}")
        tiers = eng.prefix_tier_stats()
        for tier in ("device", "host", "disk"):
            assert tiers[tier]["bytes"] <= tiers[tier]["budget_bytes"], tier
    digests = [tuple(eng._block_digests(np.asarray(p))) for p in prompts]
    assert all(d in eng._pool_map for d in digests[-1])
    assert all(d in eng._host_map for d in digests[-2])
    assert all(d in eng._disk_map for d in digests[-3])
    assert all(d not in eng._disk_map for d in digests[0])
    assert eng.tier_counters["disk"]["evictions"] > 0
    names = {n.split(".")[0] for n in os.listdir(disk_dir)
             if n.endswith(".npy")}
    assert names == {d.hex() for d in eng._disk_map}


def test_all_blocks_referenced_admission_proceeds_uncached(weights):
    """Every pool block pinned by in-flight prefills: a concurrent
    admission that completes proceeds uncached (no deadlock, no eviction
    of a pinned block) and every output stays exact."""
    _, params = weights
    eng = _engine(params, **dict(TIER_ENGINE, num_slots=3),
                  prefix_host_mb=_mb(4))
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 97, size=8).tolist()  # exactly 2 blocks
    out0 = _drive_one(eng, shared + [1, 2], 3, "seed")
    assert eng.prefix_stats()["blocks_used"] == 2
    inserts0 = eng.prefix_inserts
    fresh = rng.integers(0, 97, size=6).tolist()
    eng.admit(fresh, request_id="fresh", max_new_tokens=3)
    long1 = shared + rng.integers(0, 97, size=3).tolist()
    long2 = shared + rng.integers(0, 97, size=2).tolist()
    eng.admit(long1, request_id="pin1", max_new_tokens=3)
    eng.admit(long2, request_id="pin2", max_new_tokens=3)
    assert all(m is not None and m.refs == 2 for m in eng._pool_meta)
    outs = {}
    for _ in range(2):
        for _, task, tok, _ in eng.prefill_step(1):
            outs.setdefault(task.request_id, []).append(tok)
    assert outs.get("fresh"), "fresh prefill did not complete"
    assert eng.prefix_evictions == 0
    assert eng.tier_counters["device"]["spills"] == 0
    assert eng.prefix_inserts == inserts0
    assert all(m is not None and m.refs == 2 for m in eng._pool_meta)
    _drive(eng, outs)
    assert eng.prefix_evictions == 0
    for m in eng._pool_meta:
        assert m is not None and m.refs == 0
    for rid, p in (("pin1", long1), ("pin2", long2), ("fresh", fresh)):
        assert p + outs[rid] == _solo(params, p, 3), rid
    assert shared + [1, 2] + out0 == _solo(params, shared + [1, 2], 3)


def test_disk_tier_round_trips_bfloat16(tmp_path):
    """bf16 blocks leave the pool for the disk tier and come back bit for
    bit: numpy has no bfloat16, so the files hold the bytes. A promoted
    block equals the block first inserted under its digest, and the bf16
    engine's tokens equal an untiered one's."""
    bcfg = dataclasses.replace(CFG, compute_dtype="bfloat16")
    bparams = params_from_jax(_numpy_tree(bcfg), bcfg, "cpu")
    rng = np.random.default_rng(19)
    pA, pB, pC = (rng.integers(0, 97, size=10).tolist() for _ in range(3))
    reqs = [("r0", pA, 4), ("r1", pB, 4), ("r2", pC, 4), ("r3", pA, 4),
            ("r4", pB, 4)]
    eng = _engine(bparams, bcfg, **TIER_ENGINE,
                  prefix_disk_dir=str(tmp_path / "bf16"), prefix_disk_mb=1.0)
    first = {}
    tiered = {}
    for rid, p, n in reqs:
        tiered[rid] = _drive_one(eng, p, n, rid)
        for d, idx in eng._pool_map.items():
            blk = (eng._pool_k[:, idx].clone(), eng._pool_v[:, idx].clone())
            first.setdefault(d, blk)
            assert all(torch.equal(a, b) for a, b in zip(first[d], blk))
    assert eng._pool_k.dtype == torch.bfloat16
    assert eng.tier_counters["disk"]["promotions"] > 0
    files = sorted(os.listdir(tmp_path / "bf16"))
    k_file = next(f for f in files if f.endswith(".k.npy"))
    assert np.load(tmp_path / "bf16" / k_file).dtype == np.uint8
    plain = _engine(bparams, bcfg, **TIER_ENGINE)
    assert tiered == {rid: _drive_one(plain, p, n, rid) for rid, p, n in reqs}


def test_tier_and_chunk_knob_validation(weights, tmp_path):
    _, params = weights
    with pytest.raises(ValueError, match="prefix_blocks"):
        _engine(params, num_slots=1, max_seq=32, prefill_buckets=[16],
                prefix_blocks=0, prefix_host_mb=1.0)
    with pytest.raises(ValueError, match=">= 0"):
        _engine(params, num_slots=1, max_seq=32, prefill_buckets=[16],
                prefix_blocks=2, prefix_host_mb=-1.0)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        _engine(params, num_slots=1, max_seq=32, prefill_chunk=64)
    with pytest.raises(ValueError, match="prefix_block"):
        _engine(params, num_slots=1, max_seq=32, prefix_blocks=2,
                prefix_block=64)
    # The pool forces chunking at the largest bucket; the disk budget
    # defaults to 1 GiB; power-of-two chunk buckets as in the JAX engine.
    eng = _engine(params, num_slots=1, max_seq=32, prefill_buckets=[16],
                  prefix_blocks=2, prefix_disk_dir=str(tmp_path / "d"))
    assert eng.chunked and eng.prefill_chunk == 16
    assert eng.prefix_disk_mb == 1024.0
    assert eng.chunk_buckets == (16,)
    assert chunk_buckets(256) == (16, 32, 64, 128, 256)
    assert chunk_buckets(20) == (16, 20) and chunk_buckets(4) == (4,)
    # Chunking lifts the prompt-bucket cap up to max_seq - 1.
    eng.check_prompt_len(31)
    with pytest.raises(ValueError, match="no room"):
        eng.check_prompt_len(32)


# -- (e) the scheduler ------------------------------------------------------
def test_scheduler_chunked_under_load_and_prefill_metrics(weights):
    """8 overlapping requests, half sharing a prefix, through a chunked,
    prefix-cached and tiered engine with two chunks per step: outputs
    exact, and the snapshot carries the TTFT queue/prefill split, the
    prefix hit rate, chunks per admission and the per-tier block."""
    _, params = weights
    eng = _engine(params, num_slots=3, max_seq=48, prefill_buckets=[8, 16],
                  prefill_chunk=4, prefix_blocks=8, prefix_block=4,
                  decode_fold=4, prefix_host_mb=_mb(32))
    sched = Scheduler(eng, max_prefills_per_step=2,
                      max_prefill_chunks_per_step=2)
    rng = np.random.default_rng(6)
    shared = rng.integers(0, 97, size=8).tolist()
    reqs = {}
    batch = []
    for i in range(8):
        if i % 2:
            p = shared + rng.integers(0, 97, size=int(rng.integers(2, 6))).tolist()
        else:
            p = rng.integers(0, 97, size=int(rng.integers(3, 12))).tolist()
        batch.append((p, int(rng.integers(2, 9))))

    def run(batch):
        for p, n in batch:
            reqs[sched.submit(p, SamplingParams(max_new_tokens=n))] = (p, n, [])
        for ev in sched.run_until_idle():
            if ev.token is not None:
                reqs[ev.request_id][2].append(ev.token)

    run(batch)
    # Nine new blocks through the 8-block pool push every earlier block
    # to the host tier, where the shared prefix then hits.
    run([(rng.integers(0, 97, size=12).tolist(), 2) for _ in range(3)])
    run([(shared + [1, 2, 3], 3)])
    assert not sched.has_work()
    for rid, (p, n, toks) in reqs.items():
        assert p + toks == _solo(params, p, n), rid
    snap = sched.metrics.snapshot()
    assert snap["admitted"] == 12 and snap["finished"] == 12
    assert snap["ttft_p50_s"] >= snap["ttft_prefill_p50_s"] >= 0
    assert snap["ttft_queue_p50_s"] >= 0
    assert snap["ttft_queue_p95_s"] >= snap["ttft_queue_p50_s"]
    assert snap["ttft_prefill_p95_s"] >= snap["ttft_prefill_p50_s"]
    assert snap["prefix_hit_rate"] > 0
    assert snap["prefill_chunks_per_admit"] >= 1
    assert snap["ttft_p95_s"] >= snap["ttft_p50_s"]
    tiers = snap["prefix_tiers"]
    assert tiers == {
        t: {**kv, "hit_rate": tiers[t]["hit_rate"]}
        for t, kv in eng.prefix_tier_counters().items()
    }
    assert tiers["device"]["spills"] > 0 and tiers["host"]["hits"] > 0
    assert 0.0 < tiers["host"]["hit_rate"] <= 1.0
    probes = tiers["device"]["hits"] + tiers["device"]["misses"]
    assert tiers["device"]["hit_rate"] == tiers["device"]["hits"] / probes
    hits = eng.prefix_hit_tokens
    assert snap["prefix_hit_rate"] == hits / eng.prefix_prompt_tokens


def test_scheduler_cancels_a_prefilling_request(weights):
    """A cancel landing mid-prefill evicts the slot through the engine's
    mid-prefill release; the next request reuses it exactly."""
    _, params = weights
    eng = _engine(params, num_slots=1, max_seq=64, prefill_chunk=4,
                  prefix_blocks=4, prefix_block=4)
    sched = Scheduler(eng)
    long = list(range(1, 21))
    rid = sched.submit(long, SamplingParams(max_new_tokens=4))
    nxt = sched.submit([5, 6, 7], SamplingParams(max_new_tokens=3))
    assert sched.step() == []  # admitted; the first of five chunks run
    assert eng.num_prefilling == 1
    assert sched.cancel(rid)
    events = sched.run_until_idle()
    assert events[0].request_id == rid and events[0].reason == "cancelled"
    toks = [ev.token for ev in events if ev.request_id == nxt and ev.token is not None]
    assert [5, 6, 7] + toks == _solo(params, [5, 6, 7], 3)
    assert all(m is None or m.refs == 0 for m in eng._pool_meta)


# -- (f) sampling and parked slots -----------------------------------------
def test_sampled_chunked_request_alone_and_beside_a_resident(weights):
    """A sampled request prefilled in chunks draws the same tokens alone
    and while a resident decodes through its chunks: a parked slot is
    inactive, so interleaved folds do not advance its draw counter. It also
    draws what the monolithic engine draws for the same seed."""
    _, params = weights
    kw = dict(temperature=0.9, top_k=20, top_p=0.9, seed=7, max_new_tokens=10)
    prompt = list(range(3, 23))  # 20 tokens: five chunks of four

    def sampled(eng, resident):
        outs = {}
        if resident:
            eng.admit([1, 2, 3], request_id="m", max_new_tokens=40)
            outs["m"] = [tok for *_, tok, _ in eng.prefill_step(1)]
            assert eng.num_prefilling == 0
        eng.admit(prompt, request_id="s", **kw)
        _drive(eng, outs)
        if resident:
            assert len(outs["m"]) == 40
        return outs["s"]

    alone = sampled(_engine(params, num_slots=2, prefill_chunk=4,
                            decode_fold=3), resident=False)
    beside = sampled(_engine(params, num_slots=2, prefill_chunk=4,
                             decode_fold=3), resident=True)
    assert alone == beside and len(alone) == 10
    mono = _engine(params, num_slots=2, decode_fold=3)
    _, tok, _ = mono.admit(prompt, request_id="s", **kw)
    outs = {"s": [tok]}
    _drive(mono, outs)
    assert outs["s"] == alone
