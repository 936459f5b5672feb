"""PyTorch port, observability on the CPU: the metrics registry and its
Prometheus text, ServeMetrics' window, and request traces. The port's
tracer is held against the JAX package's: the same op stream through both
schedulers leaves the same ``(span, request_id)`` sequence in the two
rings (timestamps aside), chunk attributes included.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ray_lightning_tpu.models.gpt as jgpt
from ray_lightning_tpu import obs as jobs
from ray_lightning_tpu.serve.engine import DecodeEngine as JaxEngine
from ray_lightning_tpu.serve.scheduler import SamplingParams as JaxSampling
from ray_lightning_tpu.serve.scheduler import Scheduler as JaxScheduler
from ray_lightning_tpu_torch import obs
from ray_lightning_tpu_torch.models import gpt as tgpt
from ray_lightning_tpu_torch.models.weights import params_from_jax
from ray_lightning_tpu_torch.obs import trace as obs_trace
from ray_lightning_tpu_torch.obs.registry import relabel_text
from ray_lightning_tpu_torch.serve.engine import DecodeEngine
from ray_lightning_tpu_torch.serve.metrics import ServeMetrics
from ray_lightning_tpu_torch.serve.scheduler import SamplingParams, Scheduler

JAX_CFG = jgpt.GPTConfig(
    vocab_size=97, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq=64,
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


# -- registry + Prometheus text ---------------------------------------------
def test_registry_render_parse_roundtrip():
    """tests/test_obs.py:48."""
    reg = obs.MetricsRegistry()
    c = reg.counter("rlt_test_events_total", "events")
    c.inc(3)
    c.inc(2, kind="a")
    reg.gauge("rlt_test_depth", "depth").set(7.5)
    h = reg.histogram("rlt_test_latency_seconds", "lat", buckets=[0.1, 1.0])
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    parsed = obs.parse_prometheus_text(reg.render())
    assert parsed["rlt_test_events_total"][""] == 3.0
    assert parsed["rlt_test_events_total"]['{kind="a"}'] == 2.0
    assert parsed["rlt_test_depth"][""] == 7.5
    assert parsed["rlt_test_latency_seconds_bucket"]['{le="0.1"}'] == 1.0
    assert parsed["rlt_test_latency_seconds_bucket"]['{le="1"}'] == 2.0
    assert parsed["rlt_test_latency_seconds_bucket"]['{le="+Inf"}'] == 3.0
    assert parsed["rlt_test_latency_seconds_count"][""] == 3.0
    assert abs(parsed["rlt_test_latency_seconds_sum"][""] - 5.55) < 1e-9
    assert reg.counter("rlt_test_events_total") is c
    with pytest.raises(ValueError):
        reg.gauge("rlt_test_events_total")
    d = reg.to_dict()
    assert d["rlt_test_events_total"] == 3.0
    assert d["rlt_test_latency_seconds_count"] == 3
    # The JAX package parses the port's text the same way.
    assert jobs.parse_prometheus_text(reg.render()) == parsed


def test_relabel_text_adds_labels_everywhere():
    """tests/test_obs.py:79."""
    reg = obs.MetricsRegistry()
    reg.counter("rlt_x_total").inc(1)
    reg.counter("rlt_y_total").inc(2, kind="k")
    parsed = obs.parse_prometheus_text(relabel_text(reg.render(), replica=1))
    assert parsed["rlt_x_total"]['{replica="1"}'] == 1.0
    assert parsed["rlt_y_total"]['{kind="k",replica="1"}'] == 2.0


# -- ServeMetrics -------------------------------------------------------------
def test_ttft_p50_uses_nearest_rank():
    """tests/test_obs.py:118."""
    m = ServeMetrics(num_slots=2)
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        m.record_first_token(v, v / 2, 1, 0, 8)
    assert m.snapshot()["ttft_p50_s"] == 3.0


def test_queue_depth_updates_on_terminal_events():
    """tests/test_obs.py:128."""
    m = ServeMetrics(num_slots=2)
    m.record_submit(queue_depth=2)
    assert m.snapshot()["queue_depth"] == 2
    m.record_finish(queue_depth=1)
    assert m.snapshot()["queue_depth"] == 1
    m.record_cancel(queue_depth=0)
    assert m.snapshot()["queue_depth"] == 0
    m.record_expire()  # no depth observed -> unchanged, not zeroed
    snap = m.snapshot()
    assert snap["queue_depth"] == 0
    assert snap["cancelled"] == 1 and snap["expired"] == 1


def test_scheduler_cancel_of_queued_request_updates_queue_depth(weights):
    """tests/test_obs.py:144, and the registry mirror: the lifecycle
    counters in the Prometheus text equal the snapshot's, and the decode
    latency fields are present."""
    _, params = weights
    reg = obs.MetricsRegistry()
    eng = DecodeEngine(params, CFG, num_slots=2, max_seq=32,
                       prefill_buckets=[8], device="cpu")
    sched = Scheduler(eng, metrics=ServeMetrics(2, registry=reg),
                      max_prefills_per_step=1)
    rng = np.random.default_rng(0)
    r1 = sched.submit(rng.integers(0, 97, size=4).tolist(),
                      SamplingParams(max_new_tokens=20))
    r2 = sched.submit(rng.integers(0, 97, size=4).tolist(),
                      SamplingParams(max_new_tokens=4))
    sched.step()  # r1 admitted (1-per-step budget); r2 still queued
    assert sched.metrics.snapshot()["queue_depth"] == 1
    assert sched.cancel(r2)
    sched.step()
    snap = sched.metrics.snapshot()
    assert snap["queue_depth"] == 0 and snap["cancelled"] == 1
    assert sched.cancel(r1)
    sched.run_until_idle()
    snap = sched.metrics.snapshot()
    parsed = obs.parse_prometheus_text(reg.render())
    life = parsed["rlt_serve_requests_total"]
    for kind in ("submitted", "admitted", "cancelled"):
        assert life[f'{{kind="{kind}"}}'] == snap[kind]
    assert parsed["rlt_serve_engine_steps_total"][""] == snap["steps_recorded"]
    assert parsed["rlt_serve_tokens_emitted_total"][""] == (
        snap["tokens_emitted_window"])
    assert parsed["rlt_serve_queue_depth"][""] == 0
    for key in ("step_time_p50_s", "step_time_p95_s", "inter_token_p50_s",
                "inter_token_p95_s", "decode_tokens_per_sec"):
        assert snap[key] >= 0, key
    assert snap["cost"]["requests"] == 2
    assert snap["cost"]["emitted_tokens"] == snap["tokens_emitted_window"]


# -- trace lifecycle ----------------------------------------------------------
def _spans(evs):
    return [e["span"] for e in evs]


def _assert_well_formed(evs, terminal):
    spans = _spans(evs)
    assert spans[0] == obs_trace.SPAN_SUBMIT, spans
    assert spans[1] == obs_trace.SPAN_QUEUED, spans
    terminals = [s for s in spans if s in obs_trace.TERMINAL_SPANS]
    assert terminals == [terminal], spans
    assert spans[-1] == terminal, spans
    ts = [e["t"] for e in evs]
    assert ts == sorted(ts), "trace timestamps must be monotonic"
    if obs_trace.SPAN_ADMITTED in spans:
        i_adm = spans.index(obs_trace.SPAN_ADMITTED)
        assert i_adm >= 2
        chunk_idxs = [e["index"] for e in evs
                      if e["span"] == obs_trace.SPAN_PREFILL_CHUNK]
        assert chunk_idxs == list(range(len(chunk_idxs))), spans
    if obs_trace.SPAN_FIRST_TOKEN in spans:
        i_ft = spans.index(obs_trace.SPAN_FIRST_TOKEN)
        for i, s in enumerate(spans):
            if s == obs_trace.SPAN_DECODE_FOLD:
                assert i_ft < i < len(spans) - 1, spans


#: The attributes a span sequence is compared on besides (span, rid): the
#: engine's chunk and seed decisions and the prefill mode.
_KEYS = ("index", "tokens", "start", "final", "piggyback", "blocks", "mode",
         "chunks", "prefix_hit_tokens", "bucket")


#: The cost ledger's fields that do not read the host's clock.
COST_KEYS = ("request_id", "tenant", "prompt_tokens", "prefill_chunks",
             "prefix_hit_tokens", "decode_folds", "spec_verifies",
             "spec_accepted_tokens", "emitted_tokens", "outcome")


def _ledgers(sched):
    """The cost records on their clock-free fields and the phase records'
    keys, in the order the requests ended."""
    return ([tuple(r[k] for k in COST_KEYS)
             for r in sched.metrics.cost_records()],
            [sorted(p) for p in sched.metrics.phase_records()])


def _ring(tracer):
    return [
        (span, rid, tuple((k, (attrs or {}).get(k)) for k in _KEYS))
        for rid, span, _, attrs in tracer._scan()
    ]


def _drive(sched_cls, sp_cls, eng, tracer):
    """Test 209's op stream: a cold chunked prefill, the same prefix again,
    then a long request cancelled after its first token."""
    sched = sched_cls(eng, tracer=tracer)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 97, size=24).tolist()
    sched.submit(prefix + rng.integers(0, 97, size=4).tolist(),
                 sp_cls(max_new_tokens=6), request_id="cold")
    sched.run_until_idle()
    sched.submit(prefix + rng.integers(0, 97, size=4).tolist(),
                 sp_cls(max_new_tokens=6), request_id="hit")
    sched.run_until_idle()
    sched.submit(rng.integers(0, 97, size=12).tolist(),
                 sp_cls(max_new_tokens=40), request_id="cut")
    for _ in range(50):
        sched.step()
        if any(e["span"] == obs_trace.SPAN_FIRST_TOKEN
               for e in tracer.trace("cut")):
            break
    assert sched.cancel("cut")
    sched.run_until_idle()
    return sched


ENGINES = {
    # tests/test_obs.py:209's engine.
    "chunked_prefix": dict(prefill_buckets=[32], prefill_chunk=8,
                           prefix_blocks=8, prefix_block=8, decode_fold=2),
    # Pipelined, chunks riding the fold, n-gram speculation: the first
    # token is traced at the harvest (mode "piggyback").
    "piggyback_ngram": dict(prefill_buckets=[32], prefill_chunk=8,
                            prefix_blocks=8, prefix_block=8, decode_fold=2,
                            piggyback_chunks=1, fold_ladder=[1, 2],
                            spec="ngram", spec_depth=2),
}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_trace_lifecycle_matches_the_jax_tracer(weights, kind):
    """tests/test_obs.py:209: cold chunked prefill, prefix-cache hit and a
    mid-decode cancel, every trace well-formed and the Chrome export
    valid; and the JAX scheduler on the same op stream leaves the same
    (span, request_id) sequence, chunk and seed attributes included, and
    the same cost ledger (chunks, prefix hits, folds, speculative shares,
    emitted tokens, outcome) and phase-ledger keys."""
    j_params, params = weights
    kw = dict(num_slots=2, max_seq=64, **ENGINES[kind])
    tracer = obs.RequestTracer(capacity=2048)
    eng = DecodeEngine(params, CFG, device="cpu", **kw)
    sched = _drive(Scheduler, SamplingParams, eng, tracer)
    assert eng.tracer is tracer  # the engine shares the scheduler's tracer
    t_cold, t_hit, t_cut = (tracer.trace(r) for r in ("cold", "hit", "cut"))
    _assert_well_formed(t_cold, obs_trace.SPAN_FINISH)
    _assert_well_formed(t_hit, obs_trace.SPAN_FINISH)
    _assert_well_formed(t_cut, obs_trace.SPAN_CANCEL)
    assert _spans(t_cold).count(obs_trace.SPAN_PREFILL_CHUNK) == 4
    assert obs_trace.SPAN_PREFIX_SEED not in _spans(t_cold)
    seeds = [e for e in t_hit if e["span"] == obs_trace.SPAN_PREFIX_SEED]
    assert len(seeds) == 1 and seeds[0]["tokens"] == 24
    assert _spans(t_hit).count(obs_trace.SPAN_PREFILL_CHUNK) == 1
    if kind == "chunked_prefix":
        assert obs_trace.SPAN_DECODE_FOLD in _spans(t_cut)
    else:
        # Pipelined: the cut's first token came out of the harvest, and
        # the fold queued behind it is dropped by the cancel.
        assert obs_trace.SPAN_SPEC_VERIFY in _spans(t_cold)
        first = [e for e in t_cold if e["span"] == obs_trace.SPAN_FIRST_TOKEN]
        assert first[0]["mode"] == "piggyback"
    chrome = json.loads(json.dumps(obs.to_chrome_trace(tracer.recent_traces(8))))
    events = chrome["traceEvents"]
    assert {"queued", "prefill", "decode"} <= {
        e["name"] for e in events if e["ph"] == "X"}
    assert all("ts" in e and "dur" in e for e in events if e["ph"] == "X")
    i_names = {e["name"] for e in events if e["ph"] == "i"}
    assert {obs_trace.SPAN_PREFILL_CHUNK, obs_trace.SPAN_PREFIX_SEED} <= i_names

    j_tracer = jobs.RequestTracer(capacity=2048)
    j_eng = JaxEngine(j_params, JAX_CFG, **kw)
    j_sched = _drive(JaxScheduler, JaxSampling, j_eng, j_tracer)
    assert _ring(tracer) == _ring(j_tracer)
    costs, phases = _ledgers(sched)
    assert [c[0] for c in costs] == ["cold", "hit", "cut"]
    assert costs[1][COST_KEYS.index("prefix_hit_tokens")] == 24
    assert costs[2][COST_KEYS.index("outcome")] == "cancelled"
    assert (costs, phases) == _ledgers(j_sched)


def test_tracer_ring_buffer_bounded():
    """tests/test_obs.py:288."""
    tracer = obs.RequestTracer(capacity=4)
    for i in range(10):
        tracer.event(f"r{i}", obs_trace.SPAN_SUBMIT)
    assert len(tracer) == 4
    assert tracer.trace("r0") == []
    assert tracer.trace("r9") != []
    tracer.enabled = False
    tracer.event("r10", obs_trace.SPAN_SUBMIT)
    assert tracer.trace("r10") == []


def test_tracer_truncation_honesty():
    """tests/test_obs.py:300: ring wrap that eats part of a request's
    history is reported on its first retained event and in the dump."""
    tracer = obs.RequestTracer(capacity=4)
    tracer.event("old", obs_trace.SPAN_SUBMIT)
    for i in range(4):
        tracer.event("old", obs_trace.SPAN_DECODE_FOLD, attrs={"i": i})
    assert tracer.is_truncated("old")
    tr = tracer.trace("old")
    assert tr and tr[0].get("truncated") is True
    assert all("truncated" not in ev for ev in tr[1:])
    assert "old" in tracer.dump(4)["truncated"]
    tracer2 = obs.RequestTracer(capacity=8)
    tracer2.event("fresh", obs_trace.SPAN_SUBMIT)
    tracer2.event("fresh", obs_trace.SPAN_FINISH)
    assert not tracer2.is_truncated("fresh")
    assert "truncated" not in tracer2.dump(4)
    assert all("truncated" not in ev for ev in tracer2.trace("fresh"))
