"""Fleet rows: one compact dashboard row per serving replica (the
``summarize_replica`` part of ``ray_lightning_tpu/obs/fleet.py``).

The router's refresh condenses each replica's ``stats()`` snapshot and
``health()`` report into the row schema below. The fleet poller, its
snapshots and roll-ups (``FleetPoller``, ``aggregate_fleet``) are
ROADMAP queue 1 item 14.
"""
from __future__ import annotations

from typing import Any, Dict, Optional


def summarize_replica(
    stats: Dict[str, Any],
    health: Optional[Dict[str, Any]] = None,
    index: int = 0,
) -> Dict[str, Any]:
    """One replica's dashboard row from its stats snapshot + health
    report — the compact, stable schema FleetSnapshot.replicas carries
    (full snapshots stay on the replica; the fleet plane only ships
    what a router/autoscaler/dashboard acts on)."""
    cost = dict(stats.get("cost") or {})
    verdict = (health or {}).get("verdict")
    if verdict is None:
        verdict = stats.get("health", "unknown")
    # Tiered prefix cache: fraction of block probes each tier served
    # (device probes = the walk's total, since device is probed first).
    tiers = dict((stats.get("prefix") or {}).get("tiers") or {})
    dev = tiers.get("device") or {}
    probes = int(dev.get("hits", 0)) + int(dev.get("misses", 0))
    tier_hit = {
        t: (round(int(r.get("hits", 0)) / probes, 4) if probes else 0.0)
        for t, r in tiers.items()
    } or None
    # Effective cache size: resident prefix bytes summed over every
    # enabled tier (device + host + disk) — a replica's capacity to
    # hold warm prefixes, the router's affinity tiebreaker.
    prefix_bytes = sum(int(r.get("bytes", 0)) for r in tiers.values())
    kvf = stats.get("kvfleet")
    kvs = stats.get("kvstore")
    return {
        "replica": int(index),
        "health": str(verdict),
        # Fleet KV plane: the replica's role (prefill/decode/mixed)
        # plus a compact transfer row — what a dashboard's role/fetch
        # columns and the role-aware router/autoscaler consume.
        "role": str(stats.get("role") or "mixed"),
        "kvfleet": (
            {
                k: kvf.get(k, 0)
                for k in (
                    "fetches", "fetch_bytes", "fetch_timeouts",
                    "fetch_stale", "ships", "served_fetches",
                    "pending_fetches", "store_fetches",
                    "store_fetch_misses", "layerwise", "layer_ships",
                    "ship_partial_drops",
                )
            }
            if isinstance(kvf, dict)
            else None
        ),
        # Persistent object-store tier: counters for dashboards PLUS
        # the recent_writes/recent_dropped rings verbatim — the router
        # refresh loop reads those rings off this row to keep the
        # directory's store-held half current, so they must survive
        # summarization.
        "kvstore": (
            {
                k: kvs.get(k)
                for k in (
                    "backend", "budget_mb", "hits", "misses", "writes",
                    "write_errors", "bytes_written", "bytes_read",
                    "evictions", "corrupt", "recent_writes",
                    "recent_dropped",
                )
            }
            if isinstance(kvs, dict)
            else None
        ),
        # Quality signals for the router/autoscaler: cumulative
        # SLO-breach count (the declarative rules) and the engine's
        # dropped-digest report (the directory's eviction feed).
        "slo_breaches": int(stats.get("slo_breaches") or 0),
        "kv_dropped": stats.get("kv_dropped"),
        "queue_depth": int(stats.get("queue_depth", 0)),
        "active_slots": int(stats.get("active_slots", 0)),
        "num_slots": int(stats.get("num_slots", 0)),
        "occupancy": float(stats.get("occupancy", 0.0)),
        "tokens_per_sec": float(stats.get("tokens_per_sec", 0.0)),
        "decode_tokens_per_sec": float(
            stats.get("decode_tokens_per_sec", 0.0)
        ),
        "ttft_p50_s": stats.get("ttft_p50_s"),
        "ttft_p95_s": stats.get("ttft_p95_s"),
        "spec_accept_rate": stats.get("spec_accept_rate"),
        "prefix_hit_rate": stats.get("prefix_hit_rate"),
        "prefix_tier_hit_rate": tier_hit,
        "prefix_bytes": prefix_bytes,
        # Paged KV: pool state + occupancy (None on dense replicas) —
        # the capacity signal a page-aware router/autoscaler reads.
        "kv_pages": (
            {
                k: kv[k]
                for k in (
                    "free", "resident", "aliased", "occupancy",
                    "fragmentation_tokens",
                )
            }
            if isinstance(kv := stats.get("kv_pages"), dict)
            else None
        ),
        # Fused-dispatch row: piggybacked prefill traffic + the fold
        # ladder's per-depth dispatch counts (None when piggyback is
        # off / the ladder has one rung).
        "piggyback": (
            {
                "chunks": pb.get("chunks", 0),
                "dispatches": pb.get("dispatches", 0),
                "chunk_rows": pb.get("chunk_rows", 0),
            }
            if isinstance(pb := stats.get("piggyback"), dict)
            else None
        ),
        "fold_k": (
            {
                "ladder": fk.get("ladder") or [],
                "dispatches": fk.get("dispatches") or {},
            }
            if isinstance(fk := stats.get("fold_k"), dict)
            else None
        ),
        "submitted": int(stats.get("submitted", 0)),
        "finished": int(stats.get("finished", 0)),
        "compiles_since_init": int(stats.get("compiles_since_init", 0)),
        # Anatomy latency decomposition: the replica's windowed
        # per-phase percentile block verbatim (None when the phase
        # ledger is off or idle) — aggregate_fleet folds these into the
        # fleet-wide decomposition.
        "phases": stats.get("phases"),
        # Active SLO-breach reasons (with their phase attribution
        # suffix) — the fleet roll-up surfaces the first one as the
        # dashboard's `why:` line.
        "slo_reasons": [
            reason
            for name, ch in sorted(
                ((health or {}).get("components") or {}).items()
            )
            if name.startswith("slo:")
            and ch.get("verdict") == "unhealthy"
            for reason in ch.get("reasons", [])
        ] or None,
        # Goodput inputs ride along so the fleet ratio can be computed
        # as sum/sum instead of a mean of per-replica ratios.
        "cost_emitted_tokens": int(cost.get("emitted_tokens", 0)),
        "cost_device_seconds": float(cost.get("device_seconds", 0.0)),
        "goodput_tokens_per_device_s": float(
            cost.get("goodput_tokens_per_device_s", 0.0)
        ),
    }
