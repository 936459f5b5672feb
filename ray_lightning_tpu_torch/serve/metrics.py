"""Serving metrics: queue depth, TTFT and its queue/prefill split,
occupancy, tokens/s, the decode path's step and inter-token latency,
chunks per admission, the prefix cache's tiers, the KV page pool,
speculative decoding's accept rate, the cost ledger and the anatomy phase
ledger (PyTorch port of ``ray_lightning_tpu/serve/metrics.py``).

The serving loop is iteration-level (scheduler.step()), so metrics are
recorded per step and per request-lifecycle event and aggregated over a
bounded sliding window — a long-lived replica's stats reflect recent
traffic, not its whole uptime. ``snapshot()`` is the stats payload (the
port's rates, TTFTs and hit rates unrounded; the JAX package rounds them
for display). With
a ``registry`` (``obs/registry.py``) every record is mirrored into its
Prometheus series. The JAX package's periodic rank-zero log line
(``maybe_log``) belongs to the replica (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import TYPE_CHECKING, Any, Dict, Optional

if TYPE_CHECKING:  # registry import is cheap, but keep the seam explicit
    from ray_lightning_tpu_torch.obs.registry import MetricsRegistry

#: The prefix cache's per-tier event counters.
TIER_COUNTERS = ("hits", "misses", "spills", "promotions", "evictions")


#: The reserved synthetic-probe tenant (obs.watchtower's canary lane).
#: Requests under it ride the REAL serving path but are excluded from
#: organic accounting — the cost ledger, the goodput gauge, per-tenant
#: rows, and the queue-depth gauge the router autoscaler reads — so a
#: canary-only fleet shows zero organic pressure. Probe traffic is
#: counted in its own ``rlt_canary_*`` families instead.
CANARY_TENANT = "_canary"


def _pct(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class ServeMetrics:
    """Thread-safe counters + sliding-window rates for one engine/replica.

    ``window`` bounds how many recent engine steps and finished requests
    feed the rate/occupancy aggregates.
    """

    def __init__(
        self,
        num_slots: int,
        window: int = 512,
        registry: Optional["MetricsRegistry"] = None,
    ) -> None:
        self.num_slots = max(1, int(num_slots))
        self._lock = threading.Lock()
        # Optional Prometheus-side mirror (obs.registry): lifecycle
        # counters, queue-depth gauge, latency histograms. None (the
        # default for bare Scheduler construction in tests/bench) keeps
        # the hot loop free of the extra dict updates; ServeReplica
        # passes the process registry so /metrics sees the serve path.
        self._reg = None
        if registry is not None:
            self._reg = {
                "lifecycle": registry.counter(
                    "rlt_serve_requests_total",
                    "Serve request lifecycle events by kind",
                ),
                "tokens": registry.counter(
                    "rlt_serve_tokens_emitted_total",
                    "Tokens emitted by the engine",
                ),
                "steps": registry.counter(
                    "rlt_serve_engine_steps_total", "Scheduler steps run"
                ),
                "queue": registry.gauge(
                    "rlt_serve_queue_depth", "Requests waiting for a slot"
                ),
                "ttft": registry.histogram(
                    "rlt_serve_ttft_seconds", "Submit-to-first-token latency"
                ),
                "step_time": registry.histogram(
                    "rlt_serve_step_seconds", "Scheduler step wall time"
                ),
                "spec_verifies": registry.counter(
                    "rlt_serve_spec_verifies_total",
                    "Speculative verify forwards run",
                ),
                "spec_drafted": registry.counter(
                    "rlt_serve_spec_drafted_tokens_total",
                    "Draft tokens proposed to verify forwards",
                ),
                "spec_accepted": registry.counter(
                    "rlt_serve_spec_accepted_tokens_total",
                    "Draft tokens accepted by verify forwards",
                ),
                "spec_accept_rate": registry.gauge(
                    "rlt_serve_spec_accept_rate",
                    "Sliding-window draft-token accept rate (0-1)",
                ),
                # Tiered prefix cache: block-probe traffic and resident
                # bytes per tier (device / host / disk) — the scheduler
                # diffs the engine's cumulative tier counters into these
                # once per step.
                "prefix_hits": registry.counter(
                    "rlt_serve_prefix_hits_total",
                    "Prefix-cache block probes served, by tier",
                ),
                "prefix_misses": registry.counter(
                    "rlt_serve_prefix_misses_total",
                    "Prefix-cache block probes that missed, by tier",
                ),
                "prefix_evictions": registry.counter(
                    "rlt_serve_prefix_evictions_total",
                    "Prefix-cache blocks dropped from a tier",
                ),
                "prefix_spills": registry.counter(
                    "rlt_serve_prefix_spills_total",
                    "Prefix-cache blocks spilled one tier down",
                ),
                "prefix_promotions": registry.counter(
                    "rlt_serve_prefix_promotions_total",
                    "Cold-tier prefix blocks promoted back to the "
                    "device pool",
                ),
                "prefix_bytes": registry.gauge(
                    "rlt_serve_prefix_bytes",
                    "Resident prefix-cache bytes by tier",
                ),
                "hbm": registry.gauge(
                    "rlt_serve_hbm_bytes",
                    "Per-device resident bytes of engine device state "
                    "by component",
                ),
                # Paged KV: page-pool occupancy by state and the
                # allocator's event counters — the scheduler diffs the
                # engine's cumulative counters into these once per step
                # that saw page traffic.
                "kv_pages": registry.gauge(
                    "rlt_serve_kv_pages",
                    "KV page-pool pages by state "
                    "(free / resident / aliased)",
                ),
                "kv_page_allocs": registry.counter(
                    "rlt_serve_kv_page_allocs_total",
                    "KV pages allocated (private slot pages, "
                    "promotions, imports)",
                ),
                "kv_page_frees": registry.counter(
                    "rlt_serve_kv_page_frees_total",
                    "KV pages freed (released private pages, evicted "
                    "cache pages)",
                ),
                "kv_page_alias_hits": registry.counter(
                    "rlt_serve_kv_page_alias_hits_total",
                    "Prefix pages aliased copy-free into an admitted "
                    "slot's page table",
                ),
                # Cost ledger: one record per terminal request
                # (finish/cancel/expire), tenant-labelled so a
                # multi-tenant deployment can bill/attribute per key.
                "cost_requests": registry.counter(
                    "rlt_serve_request_cost_requests_total",
                    "Terminal requests in the cost ledger by outcome",
                ),
                "cost_tokens": registry.counter(
                    "rlt_serve_request_cost_tokens_total",
                    "Tokens emitted, attributed per request at terminal",
                ),
                "cost_device_seconds": registry.counter(
                    "rlt_serve_request_cost_device_seconds_total",
                    "Estimated device-seconds consumed per request",
                ),
                "cost_queue_seconds": registry.counter(
                    "rlt_serve_request_cost_queue_seconds_total",
                    "Seconds spent queued before admission per request",
                ),
                "goodput": registry.gauge(
                    "rlt_serve_goodput_tokens_per_device_second",
                    "Sliding-window emitted tokens per estimated "
                    "device-second",
                ),
                # Anatomy ledger: per-request phase durations (queue /
                # kv_fetch / transfer_park / prefill / decode / ship),
                # labelled by phase and this replica's fleet role — the
                # fleet-wide latency decomposition's raw series.
                "phase_seconds": registry.histogram(
                    "rlt_serve_phase_seconds",
                    "Per-request phase durations from the anatomy "
                    "ledger, by phase and replica role",
                ),
                # Canary probes: counted here (by outcome) INSTEAD of
                # in the cost ledger families — synthetic traffic must
                # not look like organic load to billing or autoscaling.
                "canary_requests": registry.counter(
                    "rlt_canary_requests_total",
                    "Canary-tenant terminal requests (excluded from "
                    "the cost ledger), by outcome",
                ),
                "canary_tokens": registry.counter(
                    "rlt_canary_tokens_total",
                    "Tokens emitted for canary-tenant requests",
                ),
            }
        #: Fleet role ("mixed" / "prefill" / "decode") — labels the
        #: phase histogram; the scheduler sets it at construction.
        self.role = "mixed"
        # Lifecycle counters (monotonic).
        self.submitted = 0
        self.admitted = 0
        self.finished = 0
        self.cancelled = 0
        self.expired = 0
        # Sliding windows.
        self._ttft_s: deque = deque(maxlen=window)
        #: TTFT breakdown: time queued (submit -> slot) vs time prefilling
        #: (slot -> first token) — with chunked prefill the two diverge,
        #: and only the second is the prefill path's to improve.
        self._ttft_queue_s: deque = deque(maxlen=window)
        self._ttft_prefill_s: deque = deque(maxlen=window)
        #: Chunk dispatches per admission (1 on the fused monolithic path).
        self._prefill_chunks: deque = deque(maxlen=window)
        #: (prefix_hit_tokens, prompt_tokens) per admission.
        self._prefix_tokens: deque = deque(maxlen=window)
        #: (wall_s, active_slots, tokens_emitted) per engine step.
        self._steps: deque = deque(maxlen=window)
        #: (verifies, drafted, accepted) per engine step with spec on —
        #: the propose-then-verify accounting behind spec_accept_rate.
        self._spec: deque = deque(maxlen=window)
        #: Cost-ledger records (one dict per terminal request — see
        #: Scheduler's ledger): the sliding window behind the ``cost``
        #: stats block and the goodput gauge.
        self._costs: deque = deque(maxlen=window)
        #: Anatomy phase ledgers (one (tenant, {phase: seconds}) per
        #: terminal request): the sliding window behind the ``phases``
        #: stats block — per-phase p50/p95/p99, the hot phase, and the
        #: per-tenant tails the fleet aggregator folds across replicas.
        self._phases: deque = deque(maxlen=window)
        #: Cumulative tiered prefix-cache counters (device/host/disk) —
        #: accumulated from the scheduler's per-step deltas; feeds the
        #: ``prefix_tiers`` stats block and its hit-rate-by-tier.
        self._prefix_tiers: Dict[str, Dict[str, int]] = {}
        #: Latest paged-KV allocator stats block (engine.kv_page_stats,
        #: refreshed by the scheduler) — the snapshot's ``kv_pages``
        #: block; None until a paged engine reports.
        self._kv_pages: Optional[Dict[str, Any]] = None
        self._queue_depth = 0
        self._started = time.monotonic()
        self._last_log = 0.0

    # -- recording -------------------------------------------------------
    def _set_queue_depth(self, queue_depth: Optional[int]) -> None:
        """Under self._lock. Every lifecycle event that can change the
        queue reports the depth it observed — finish/cancel/expire
        included, so the stat can't go stale between submits (a cancel
        of the last queued request must drop it to 0 without waiting for
        the next admission to refresh it)."""
        if queue_depth is None:
            return
        self._queue_depth = int(queue_depth)
        if self._reg is not None:
            self._reg["queue"].set(self._queue_depth)

    def record_submit(self, queue_depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self._set_queue_depth(queue_depth)
        if self._reg is not None:
            self._reg["lifecycle"].inc(1, kind="submitted")

    def record_admit(self, queue_s: float, queue_depth: int) -> None:
        """A request entered a slot after ``queue_s`` in the queue (its
        prefill may still be running — see record_first_token)."""
        with self._lock:
            self.admitted += 1
            self._ttft_queue_s.append(float(queue_s))
            self._set_queue_depth(queue_depth)
        if self._reg is not None:
            self._reg["lifecycle"].inc(1, kind="admitted")

    def record_first_token(
        self,
        ttft_s: float,
        prefill_s: float,
        chunks: int,
        prefix_hit_tokens: int,
        prompt_tokens: int,
    ) -> None:
        """A request produced its first token: full TTFT, its prefill
        component, chunk dispatches spent, and the prefix-cache hit."""
        with self._lock:
            self._ttft_s.append(float(ttft_s))
            self._ttft_prefill_s.append(float(prefill_s))
            self._prefill_chunks.append(int(chunks))
            self._prefix_tokens.append(
                (int(prefix_hit_tokens), int(prompt_tokens))
            )
        if self._reg is not None:
            self._reg["ttft"].observe(float(ttft_s))

    def record_finish(
        self, n: int = 1, queue_depth: Optional[int] = None
    ) -> None:
        with self._lock:
            self.finished += n
            self._set_queue_depth(queue_depth)
        if self._reg is not None:
            self._reg["lifecycle"].inc(n, kind="finished")

    def record_cancel(
        self, n: int = 1, queue_depth: Optional[int] = None
    ) -> None:
        with self._lock:
            self.cancelled += n
            self._set_queue_depth(queue_depth)
        if self._reg is not None:
            self._reg["lifecycle"].inc(n, kind="cancelled")

    def record_expire(
        self, n: int = 1, queue_depth: Optional[int] = None
    ) -> None:
        with self._lock:
            self.expired += n
            self._set_queue_depth(queue_depth)
        if self._reg is not None:
            self._reg["lifecycle"].inc(n, kind="expired")

    def record_step(
        self, wall_s: float, active_slots: int, tokens_emitted: int,
        queue_depth: int,
    ) -> None:
        with self._lock:
            self._steps.append(
                (float(wall_s), int(active_slots), int(tokens_emitted))
            )
            self._set_queue_depth(queue_depth)
        if self._reg is not None:
            self._reg["steps"].inc(1)
            if tokens_emitted:
                self._reg["tokens"].inc(int(tokens_emitted))
            self._reg["step_time"].observe(float(wall_s))

    def record_spec(
        self, verifies: int, drafted: int, accepted: int
    ) -> None:
        """One step's speculative-decoding delta: ``verifies`` verify
        forwards ran, proposing ``drafted`` draft tokens of which
        ``accepted`` matched exactly (engine.spec_stats deltas, recorded
        by the scheduler after each fold)."""
        if not verifies:
            return
        with self._lock:
            self._spec.append(
                (int(verifies), int(drafted), int(accepted))
            )
            if self._reg is not None:
                d = sum(s[1] for s in self._spec)
                a = sum(s[2] for s in self._spec)
                self._reg["spec_accept_rate"].set(
                    round(a / d, 4) if d else 0.0
                )
        if self._reg is not None:
            self._reg["spec_verifies"].inc(int(verifies))
            self._reg["spec_drafted"].inc(int(drafted))
            self._reg["spec_accepted"].inc(int(accepted))

    def record_prefix_tiers(
        self,
        deltas: Dict[str, Dict[str, int]],
        bytes_by_tier: Optional[Dict[str, int]] = None,
    ) -> None:
        """One step's tiered prefix-cache delta (the engine's cumulative
        counters diffed by the scheduler): accumulated for the stats
        ``prefix_tiers`` block and mirrored into the tier-labelled
        ``rlt_serve_prefix_*_total`` counters and the
        ``rlt_serve_prefix_bytes`` gauge."""
        kinds = TIER_COUNTERS
        with self._lock:
            for tier, kv in deltas.items():
                cum = self._prefix_tiers.setdefault(
                    tier, {k: 0 for k in kinds}
                )
                for k in kinds:
                    cum[k] += int(kv.get(k, 0))
        if self._reg is None:
            return
        for tier, kv in deltas.items():
            for kind, key in (
                ("hits", "prefix_hits"),
                ("misses", "prefix_misses"),
                ("spills", "prefix_spills"),
                ("promotions", "prefix_promotions"),
                ("evictions", "prefix_evictions"),
            ):
                n = int(kv.get(kind, 0))
                if n:
                    self._reg[key].inc(n, tier=tier)
        for tier, b in (bytes_by_tier or {}).items():
            self._reg["prefix_bytes"].set(float(b), tier=tier)

    def record_kv_pages(
        self, deltas: Dict[str, int], stats: Dict[str, Any]
    ) -> None:
        """One step's paged-KV allocator delta (the engine's cumulative
        alloc/free/alias counters diffed by the scheduler) plus the
        current pool state block: mirrored into the
        ``rlt_serve_kv_page_*_total`` counters and the state-labelled
        ``rlt_serve_kv_pages`` gauge, and kept for the snapshot's
        ``kv_pages`` block (occupancy, fragmentation)."""
        with self._lock:
            self._kv_pages = dict(stats)
        if self._reg is None:
            return
        for kind, key in (
            ("allocs", "kv_page_allocs"),
            ("frees", "kv_page_frees"),
            ("alias_hits", "kv_page_alias_hits"),
        ):
            n = int(deltas.get(kind, 0))
            if n:
                self._reg[key].inc(n)
        for state in ("free", "resident", "aliased"):
            self._reg["kv_pages"].set(
                float(stats.get(state, 0)), state=state
            )

    def record_cost(self, record: Dict[str, Any]) -> None:
        """One terminal request's accounting record (the scheduler's
        cost ledger emits it at finish/cancel/expire): windowed for the
        stats ``cost`` block, mirrored into the tenant-labelled
        ``rlt_serve_request_cost_*`` counters, and folded into the
        sliding-window goodput gauge (emitted tokens per estimated
        device-second). Canary-tenant records are diverted whole into
        the ``rlt_canary_*`` families: no window entry, no cost
        counters, no goodput contribution — the probe lane must be
        invisible to organic accounting."""
        if record.get("tenant") == CANARY_TENANT:
            if self._reg is not None:
                self._reg["canary_requests"].inc(
                    1, outcome=record.get("outcome", "finished")
                )
                self._reg["canary_tokens"].inc(
                    int(record.get("emitted_tokens", 0))
                )
            return
        with self._lock:
            self._costs.append(dict(record))
            if self._reg is not None:
                toks = sum(r["emitted_tokens"] for r in self._costs)
                dev = sum(r["device_s"] for r in self._costs)
        if self._reg is not None:
            tenant = record.get("tenant") or "default"
            self._reg["cost_requests"].inc(
                1, tenant=tenant, outcome=record.get("outcome", "finished")
            )
            self._reg["cost_tokens"].inc(
                int(record.get("emitted_tokens", 0)), tenant=tenant
            )
            self._reg["cost_device_seconds"].inc(
                float(record.get("device_s", 0.0)), tenant=tenant
            )
            self._reg["cost_queue_seconds"].inc(
                float(record.get("queue_s", 0.0)), tenant=tenant
            )
            self._reg["goodput"].set(
                round(toks / dev, 3) if dev > 0 else 0.0
            )

    def cost_records(self) -> list:
        """The cost-ledger window, oldest first (tests, fleet tooling)."""
        with self._lock:
            return [dict(r) for r in self._costs]

    def set_role(self, role: str) -> None:
        """Label the phase histogram with this replica's fleet role
        (the scheduler calls it once at construction)."""
        self.role = str(role)

    def record_phases(
        self,
        phases: Dict[str, Any],
        tenant: Optional[str] = None,
        outcome: Optional[str] = None,
    ) -> None:
        """One terminal request's compact phase ledger ({phase:
        seconds}; non-numeric detail keys like ``kv_fetch_source`` are
        kept out of the aggregates). Windowed for the stats ``phases``
        block and mirrored into the phase/role-labelled
        ``rlt_serve_phase_seconds`` histogram. Canary-tenant ledgers
        are skipped — the probe's timings live in the watchtower's
        dedicated ``canary.*`` series, not the organic decomposition
        (or its per-tenant rows)."""
        if tenant == CANARY_TENANT:
            return
        durs = {
            k: float(v) for k, v in phases.items()
            if isinstance(v, (int, float))
        }
        if not durs:
            return
        with self._lock:
            self._phases.append((tenant or "default", durs))
        if self._reg is not None:
            for phase, s in durs.items():
                self._reg["phase_seconds"].observe(
                    s, phase=phase, role=self.role
                )

    def phase_records(self) -> list:
        """The phase-ledger window, oldest first (tests, anatomy)."""
        with self._lock:
            return [dict(p) for _, p in self._phases]

    def record_memory(self, mem: Dict[str, Any]) -> None:
        """Resident-footprint gauges from ``engine.memory_stats()``:
        ``rlt_serve_hbm_bytes{component=...}`` carries PER-DEVICE bytes
        after sharding — the number that must shrink ~linearly in the
        serve mesh's model axis (tp=N really dividing the footprint by
        ~N is validated against this series, not assumed). Engine state
        shapes are frozen at construction, so one call per engine is
        enough."""
        if self._reg is None or not mem:
            return
        for comp, row in mem.items():
            if isinstance(row, dict) and "per_device_bytes" in row:
                self._reg["hbm"].set(
                    float(row["per_device_bytes"]), component=comp
                )

    # -- aggregates ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Aggregate view over the sliding window (the stats payload)."""
        with self._lock:
            steps = list(self._steps)
            ttft = sorted(self._ttft_s)
            wall = sum(s[0] for s in steps)
            tokens = sum(s[2] for s in steps)
            occ = (
                sum(s[1] for s in steps) / (len(steps) * self.num_slots)
                if steps
                else 0.0
            )
            out = {
                "num_slots": self.num_slots,
                "queue_depth": self._queue_depth,
                "submitted": self.submitted,
                "admitted": self.admitted,
                "finished": self.finished,
                "cancelled": self.cancelled,
                "expired": self.expired,
                "steps_recorded": len(steps),
                # Mean fraction of slots decoding per step, over the window.
                "occupancy": occ,
                "tokens_emitted_window": tokens,
                "tokens_per_sec": tokens / wall if wall > 0 else 0.0,
                "uptime_s": round(time.monotonic() - self._started, 3),
            }
            if ttft:
                out["ttft_p50_s"] = _pct(ttft, 0.50)
                out["ttft_p95_s"] = _pct(ttft, 0.95)
                out["ttft_max_s"] = ttft[-1]
            # TTFT breakdown: queue wait vs prefill time. A fat
            # ttft_queue_s wants more slots/replicas; a fat
            # ttft_prefill_s wants chunking/prefix-cache tuning.
            queue = sorted(self._ttft_queue_s)
            if queue:
                out["ttft_queue_p50_s"] = _pct(queue, 0.50)
                out["ttft_queue_p95_s"] = _pct(queue, 0.95)
            pf = sorted(self._ttft_prefill_s)
            if pf:
                out["ttft_prefill_p50_s"] = _pct(pf, 0.50)
                out["ttft_prefill_p95_s"] = _pct(pf, 0.95)
            if self._prefill_chunks:
                out["prefill_chunks_per_admit"] = (
                    sum(self._prefill_chunks) / len(self._prefill_chunks)
                )
            if self._prefix_tokens:
                hit = sum(h for h, _ in self._prefix_tokens)
                tot = sum(p for _, p in self._prefix_tokens)
                # Fraction of prompt tokens served from the prefix pool
                # instead of prefill compute (0.0 with the cache off).
                out["prefix_hit_rate"] = hit / tot if tot else 0.0
            # Tiered prefix cache: per-tier probe counters with a
            # hit-rate-by-tier (fraction of ALL block probes each tier
            # served — the tier walk probes device first, so device
            # hits + misses is the probe total).
            if self._prefix_tiers:
                dev = self._prefix_tiers.get("device", {})
                probes = int(dev.get("hits", 0)) + int(dev.get("misses", 0))
                out["prefix_tiers"] = {
                    tier: {
                        **kv,
                        "hit_rate": (
                            kv.get("hits", 0) / probes if probes else 0.0
                        ),
                    }
                    for tier, kv in self._prefix_tiers.items()
                }
            # Paged KV: the allocator's latest state block (occupancy,
            # fragmentation = allocated-but-unusable tokens, and the
            # cumulative alloc/free/alias counters) — absent on dense
            # engines.
            if self._kv_pages is not None:
                out["kv_pages"] = dict(self._kv_pages)
            # Decode-path latency: with a folded engine one step emits up
            # to decode_fold tokens per slot, so step time and per-slot
            # inter-token latency diverge — report both, plus tokens/s
            # over the steps that actually decoded, so the fold's
            # TTFT-vs-throughput tradeoff is observable, not inferred.
            walls = sorted(s[0] for s in steps if s[1] > 0)
            if walls:
                out["step_time_p50_s"] = round(_pct(walls, 0.50), 6)
                out["step_time_p95_s"] = round(_pct(walls, 0.95), 6)
            inter = sorted(
                s[0] * s[1] / s[2] for s in steps if s[1] > 0 and s[2] > 0
            )
            if inter:
                out["inter_token_p50_s"] = round(_pct(inter, 0.50), 6)
                out["inter_token_p95_s"] = round(_pct(inter, 0.95), 6)
            d_wall = sum(s[0] for s in steps if s[2] > 0)
            d_tokens = sum(s[2] for s in steps if s[2] > 0)
            out["decode_tokens_per_sec"] = (
                round(d_tokens / d_wall, 3) if d_wall > 0 else 0.0
            )
            # Speculative decoding (only when spec ran in the window):
            # accept rate in [0, 1] and draft tokens proposed per verify
            # forward — the depth-vs-accept tradeoff, observable.
            if self._spec:
                v = sum(s[0] for s in self._spec)
                d = sum(s[1] for s in self._spec)
                a = sum(s[2] for s in self._spec)
                out["spec_accept_rate"] = round(a / d, 4) if d else 0.0
                out["draft_tokens_per_verify"] = (
                    round(d / v, 4) if v else 0.0
                )
            # Cost ledger: per-request accounting aggregated over the
            # window; goodput = emitted tokens per estimated
            # device-second (sum/sum — the fleet plane rolls replicas up
            # the same way so the fleet ratio stays a true ratio).
            if self._costs:
                costs = list(self._costs)
                c_toks = sum(r["emitted_tokens"] for r in costs)
                c_dev = sum(r["device_s"] for r in costs)
                out["cost"] = {
                    "requests": len(costs),
                    "emitted_tokens": c_toks,
                    "device_seconds": round(c_dev, 6),
                    "goodput_tokens_per_device_s": (
                        round(c_toks / c_dev, 3) if c_dev > 0 else 0.0
                    ),
                    "queue_s_mean": round(
                        sum(r["queue_s"] for r in costs) / len(costs), 6
                    ),
                    "decode_folds": sum(r["decode_folds"] for r in costs),
                    "prefill_chunks": sum(
                        r["prefill_chunks"] for r in costs
                    ),
                    "prefix_hit_tokens": sum(
                        r["prefix_hit_tokens"] for r in costs
                    ),
                    "spec_accepted_tokens": round(
                        sum(r["spec_accepted_tokens"] for r in costs), 3
                    ),
                }
            # Anatomy phases: the windowed latency decomposition — per
            # phase p50/p95/p99/mean over terminal requests, the single
            # hottest phase by p95 (rlt top's hot-spot column), and
            # per-tenant p95 tails when the window saw several tenants.
            if self._phases:
                by_phase: Dict[str, list] = {}
                by_tenant: Dict[str, Dict[str, list]] = {}
                for tenant, durs in self._phases:
                    for phase, s in durs.items():
                        by_phase.setdefault(phase, []).append(s)
                        by_tenant.setdefault(tenant, {}).setdefault(
                            phase, []
                        ).append(s)
                block: Dict[str, Any] = {}
                for phase, vals in by_phase.items():
                    vals = sorted(vals)
                    block[phase] = {
                        "p50_s": round(_pct(vals, 0.50), 6),
                        "p95_s": round(_pct(vals, 0.95), 6),
                        "p99_s": round(_pct(vals, 0.99), 6),
                        "mean_s": round(sum(vals) / len(vals), 6),
                        "count": len(vals),
                    }
                hot = max(
                    block.items(), key=lambda kv: kv[1]["p95_s"]
                )
                out["phases"] = {
                    "role": self.role,
                    "requests": len(self._phases),
                    "by_phase": block,
                    "hot_phase": hot[0],
                    "hot_phase_p95_s": hot[1]["p95_s"],
                }
                if len(by_tenant) > 1:
                    out["phases"]["by_tenant"] = {
                        tenant: {
                            phase: round(_pct(sorted(vals), 0.95), 6)
                            for phase, vals in phases.items()
                        }
                        for tenant, phases in by_tenant.items()
                    }
            return out
