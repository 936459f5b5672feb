"""PyTorch port, the workload journal on the CPU: the ring and its JSONL
spill, crash-consistent loading, and bit-exact replay of a recorded serve
session on a fresh engine built from the journal's header through the
port's ``build_engine``. A journal captured by the JAX package's scheduler
(greedy requests, a mid-flight cancel, an expired deadline) replays exact
through the port too: the two packages' greedy tokens agree, and the
header's config and engine knobs build a port engine as they are.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu.obs.journal import WorkloadJournal as JaxJournal
from ray_lightning_tpu.obs.journal import engine_header as jax_engine_header
from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_lightning_tpu.serve.scheduler import SamplingParams as JaxSampling
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.obs.journal import (
    WorkloadJournal,
    build_replay_scheduler,
    engine_header,
    incomplete_requests,
    load_journal,
    replay_journal,
)
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

#: One layer: replay exactness is about the request stream's round trip.
JAX_CFG = jgpt.GPTConfig(
    vocab_size=97, n_layer=1, n_head=4, n_kv_head=2, d_model=32, max_seq=64,
    attn_impl="reference", compute_dtype="float32",
)
CFG = tgpt.GPTConfig(**dataclasses.asdict(JAX_CFG))


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
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_jax(tree, CFG, "cpu"))


# -- ring, spill, loading (pure) -------------------------------------------
def test_journal_ring_bounds_and_spill_rotation(tmp_path):
    """tests/test_journal.py:57."""
    spill = str(tmp_path / "spill")
    jr = WorkloadJournal(capacity=8, spill_dir=spill, spill_max_bytes=600,
                         spill_keep=3)
    jr.set_header({"version": 1, "model_config": {"d_model": 32}})
    for i in range(40):
        jr.record_submit(request_id=f"r{i:03d}", prompt=[1, 2, 3],
                         sampling={"max_new_tokens": 4, "seed": i})
    jr.close()
    d = jr.dump()
    assert len(d["entries"]) == 8
    assert d["entries"][-1]["request_id"] == "r039"
    assert d["header"]["model_config"] == {"d_model": 32}
    assert len(jr.dump(3)["entries"]) == 3
    files = sorted(os.listdir(spill))
    assert 1 < len(files) <= 3, files
    for name in files:
        with open(os.path.join(spill, name)) as f:
            assert json.loads(f.readline())["kind"] == "header"
    loaded = load_journal(spill)
    assert loaded["header"]["version"] == 1
    rids = [e["request_id"] for e in loaded["entries"]]
    assert rids == sorted(rids) and rids[-1] == "r039"
    path = tmp_path / "one.jsonl"
    path.write_text(jr.to_jsonl())
    assert [e["request_id"] for e in load_journal(str(path))["entries"]] == [
        e["request_id"] for e in d["entries"]]


def test_load_journal_crash_consistency_torn_tail_and_incomplete(tmp_path):
    """tests/test_journal.py:101: a torn JSONL tail loads (counted) and the
    outcome-less submit classifies as incomplete."""
    path = tmp_path / "torn.jsonl"
    path.write_text(
        json.dumps({"kind": "header", "version": 1}) + "\n"
        + json.dumps({"kind": "submit", "request_id": "done-1",
                      "prompt": [1, 2],
                      "sampling": {"max_new_tokens": 4, "seed": 0}}) + "\n"
        + json.dumps({"kind": "outcome", "request_id": "done-1",
                      "outcome": "finished", "tokens": [5, 6, 7, 8]}) + "\n"
        + json.dumps({"kind": "submit", "request_id": "stranded-2",
                      "prompt": [3, 4], "priority": 1, "tenant": "acme",
                      "sampling": {"max_new_tokens": 8, "seed": 7}}) + "\n"
        + '{"kind": "outcome", "request_id": "stranded-2", "outc'
    )
    loaded = load_journal(str(path))
    assert loaded["torn_lines"] == 1 and loaded["header"]["version"] == 1
    assert [(e["kind"], e["request_id"]) for e in loaded["entries"]] == [
        ("submit", "done-1"), ("outcome", "done-1"), ("submit", "stranded-2"),
    ]
    (inc,) = incomplete_requests(loaded)
    assert inc["request_id"] == "stranded-2"
    assert inc["sampling"]["seed"] == 7 and inc["tenant"] == "acme"


def test_truncated_ring_classifies_open_submits_incomplete():
    """tests/test_journal.py:142."""
    jr = WorkloadJournal(capacity=3)
    jr.record_submit(request_id="old", prompt=[1],
                     sampling={"max_new_tokens": 2, "seed": 0})
    jr.record_outcome("old", "finished", tokens=[9, 9])
    jr.record_submit(request_id="open-a", prompt=[2],
                     sampling={"max_new_tokens": 2, "seed": 1})
    jr.record_submit(request_id="open-b", prompt=[3],
                     sampling={"max_new_tokens": 2, "seed": 2})
    dump = jr.dump()
    assert [e["request_id"] for e in dump["entries"]] == [
        "old", "open-a", "open-b"]
    assert {e["request_id"] for e in incomplete_requests(dump)} == {
        "open-a", "open-b"}


# -- capture -> bit-exact replay ---------------------------------------------
def _record_session(sched_cls, sp_cls, eng, journal, header, sampled=True):
    """Two greedy requests (one tenant-labelled), a seeded sampled one, a
    mid-flight cancel after 3 tokens and a queued expiry."""
    journal.set_header(header)
    sched = sched_cls(eng, max_prefills_per_step=2, journal=journal)
    g = np.random.default_rng(3)

    def p(n):
        return g.integers(0, 97, size=n).tolist()

    sched.submit(p(6), sp_cls(max_new_tokens=8), request_id="g0")
    sp = (sp_cls(max_new_tokens=8, temperature=0.9, seed=11, top_k=20)
          if sampled else sp_cls(max_new_tokens=8))
    sched.submit(p(7), sp, tenant="acme", request_id="g1")
    sched.submit(p(6), sp_cls(max_new_tokens=16), request_id="cut")
    sched.submit(p(5), sp_cls(max_new_tokens=8), deadline_s=0.0,
                 request_id="late")
    got = 0
    while sched.has_work():
        evs = sched.step()
        got += sum(1 for e in evs if e.request_id == "cut"
                   and e.token is not None)
        if got >= 3:
            sched.cancel("cut")
            break
    sched.run_until_idle()


def test_capture_and_replay_bit_exact(weights, tmp_path):
    """tests/test_journal.py:214: a recorded session (greedy, seeded
    sampling, mid-flight cancel, expired deadline) replays bit-exact on a
    fresh engine built from the header, in virtual time and in wall time
    (with the perf comparison against the recorded ledger)."""
    _, params = weights
    eng = DecodeEngine(params, CFG, num_slots=2, max_seq=64,
                       prefill_buckets=[8], decode_fold=2, device="cpu")
    jr = WorkloadJournal(capacity=256, spill_dir=str(tmp_path / "s"))
    _record_session(Scheduler, SamplingParams, eng, jr,
                    engine_header(eng, max_prefills_per_step=2))
    jr.close()
    j = load_journal(str(tmp_path / "s"))
    outcomes = {e["request_id"]: e for e in j["entries"]
                if e["kind"] == "outcome"}
    assert {o["outcome"] for o in outcomes.values()} == {
        "finished", "cancelled", "expired"}
    assert len(outcomes["cut"]["tokens"]) >= 3
    fin = outcomes["g0"]
    assert fin["cost"]["emitted_tokens"] == len(fin["tokens"])
    assert fin["ttft_s"] > 0
    assert set(fin["phases"]) == {"queue", "prefill", "decode"}
    subs = {e["request_id"]: e for e in j["entries"] if e["kind"] == "submit"}
    assert subs["g1"]["tenant"] == "acme"
    assert subs["g1"]["sampling"]["seed"] == 11
    assert j["header"]["engine"]["mesh"] == "1x1"

    sched_v = build_replay_scheduler(j["header"], params=params, device="cpu")
    res = replay_journal(j, scheduler=sched_v)
    assert res["exact"] is True and res["divergence"] is None
    assert res["compared"] == 4 and res["open"] == 0
    assert res["tokens_compared"] == sum(
        len(o["tokens"]) for o in outcomes.values())
    rows = {r["request_id"]: r for r in res["rows"]}
    assert rows["cut"]["outcome_replayed"] == "cancelled"
    assert rows["late"]["outcome_replayed"] == "expired"
    assert rows["late"]["tokens_replayed"] == 0
    res_w = replay_journal(
        j, scheduler=Scheduler(sched_v.engine, max_prefills_per_step=2),
        timing="wall")
    assert res_w["exact"] is True
    perf = res_w["perf"]
    assert perf["recorded"]["tokens_per_sec"] > 0
    assert perf["replayed"]["tokens_per_sec"] > 0
    assert perf["recorded"]["ttft_p50_s"] > 0
    assert perf["recorded"]["goodput_tokens_per_device_s"] > 0
    assert "tokens_per_sec" in perf["replay_vs_recorded"]
    assert set(perf["phases"]["replayed"]) >= {"queue", "prefill", "decode"}


def test_journal_captured_by_jax_replays_exact_in_the_port(weights, tmp_path):
    """A session captured by the JAX scheduler, spilled as JSONL, replays
    through the port's scheduler exact: the header's model config and
    engine knobs build the port's engine as they are. (Greedy requests
    only: the two packages draw sampled tokens from different
    generators.)"""
    j_params, params = weights
    j_eng = JaxEngine(j_params, JAX_CFG, num_slots=2, max_seq=64,
                      prefill_buckets=[8], decode_fold=2)
    jr = JaxJournal(capacity=256, spill_dir=str(tmp_path / "jax"))
    _record_session(JaxScheduler, JaxSampling, j_eng, jr,
                    jax_engine_header(j_eng, max_prefills_per_step=2),
                    sampled=False)
    jr.close()
    j = load_journal(str(tmp_path / "jax"))
    assert j["header"]["engine"]["kvstore_namespace"] is None
    res = replay_journal(j, params=params, device="cpu")
    assert res["exact"] is True and res["divergence"] is None
    assert res["compared"] == 4
    rows = {r["request_id"]: r for r in res["rows"]}
    assert rows["cut"]["outcome_replayed"] == "cancelled"
    assert rows["late"]["outcome_replayed"] == "expired"


def test_replay_rejects_bad_timing_missing_header_and_unported_knobs(
        weights, tmp_path):
    """tests/test_journal.py:284, and a header knob the port does not have
    is refused naming its ROADMAP item, not ignored; the router, kvfleet
    and kvstore sections are accepted and surface as ``router_config``,
    ``kvfleet_config`` and ``kvstore_config`` (filtered to their known
    keys, as the JAX package filters them), and an engine section's
    ``kvstore_dir`` rebuilds the engine with its store."""
    from ray_lightning_tpu.serve.kvfleet import (
        kvfleet_config_from_header as jax_kvfleet_cfg,
    )
    from ray_lightning_tpu.serve.kvstore import (
        kvstore_config_from_header as jax_kvstore_cfg,
    )

    _, params = weights
    with pytest.raises(ValueError, match="timing"):
        replay_journal({"entries": []}, timing="nope")
    with pytest.raises(ValueError, match="header"):
        replay_journal({"header": None, "entries": []})
    eng = DecodeEngine(params, CFG, num_slots=2, max_seq=64,
                       prefill_buckets=[8], device="cpu")
    header = engine_header(eng)
    for bad, match in (
        (dict(header, engine=dict(header["engine"], mesh="2x1")), "item 11"),
        (dict(header, engine=dict(header["engine"], no_such_knob=1)),
         "no_such_knob"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            build_replay_scheduler(bad, params=params, device="cpu")
    kv_root = str(tmp_path / "kv")
    stored = dict(header, engine=dict(header["engine"], kvstore_dir=kv_root,
                                      prefix_blocks=4))
    sched = build_replay_scheduler(stored, params=params, device="cpu")
    assert sched.engine.kvstore is not None
    assert sched.engine.kvstore.path == kv_root
    # The router section (driver-side policy knobs) rebuilds separately:
    # the replay scheduler builds, and the replay surfaces the knobs.
    routed = dict(header, router={"affinity": False, "bogus": 1},
                  kvfleet={"role": "prefill", "layerwise": True, "bogus": 1},
                  kvstore={"dir": "kv", "writethrough": True, "bogus": 1})
    build_replay_scheduler(routed, params=params, device="cpu")
    res = replay_journal({"header": routed, "entries": []}, params=params,
                         device="cpu")
    assert res["router_config"] == {"affinity": False}
    assert res["kvfleet_config"] == jax_kvfleet_cfg(routed) == {
        "role": "prefill", "layerwise": True}
    assert res["kvstore_config"] == jax_kvstore_cfg(routed) == {
        "dir": "kv", "writethrough": True}


def test_header_carries_fused_dispatch_config_and_replays(weights):
    """tests/test_journal.py:624 (the store's header section is held in
    tests/test_torch_kvstore.py): fold_ladder and piggyback_chunks ride
    the header, the replay engine is built with the same fused config,
    and the replay is exact."""
    _, params = weights
    eng = DecodeEngine(params, CFG, num_slots=3, max_seq=64,
                       prefill_buckets=[16], prefill_chunk=4, decode_fold=2,
                       piggyback_chunks=2, fold_ladder=[1, 2], device="cpu")
    journal = WorkloadJournal(capacity=256)
    journal.set_header(engine_header(eng, max_prefills_per_step=2))
    sched = Scheduler(eng, max_prefills_per_step=2, journal=journal)
    g = np.random.default_rng(67)
    for _ in range(4):
        sched.submit(g.integers(0, 97, size=int(g.integers(5, 13))).tolist(),
                     SamplingParams(max_new_tokens=int(g.integers(3, 7))))
    sched.run_until_idle()
    j = journal.dump()
    h_eng = j["header"]["engine"]
    assert h_eng["fold_ladder"] == [1, 2]
    assert h_eng["piggyback_chunks"] == 2
    sched_v = build_replay_scheduler(j["header"], params=params, device="cpu")
    assert sched_v.engine.piggyback_chunks == 2
    assert tuple(sched_v.engine.fold_ladder) == (1, 2)
    res = replay_journal(j, scheduler=sched_v)
    assert res["exact"] is True and res["divergence"] is None
    assert sched_v.engine.piggyback_dispatches > 0
