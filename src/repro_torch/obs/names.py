"""Canonical metric-name registry.

Every counter, gauge, and histogram name used anywhere in the repo is
declared here, in one place.  The R5 lint (``repro.analysis.rules_metrics``)
cross-checks each ``inc``/``observe``/``set_gauge``/``value`` call site —
in src, tests, and benchmarks — against these sets, so a typo'd metric
name (a dashboard silently reading zeros) is a lint failure, not a
production mystery.

Names follow Prometheus conventions loosely: ``*_total``-style counters
keep their historical names, gauges are instantaneous, histograms carry
the unit suffix (``_s``, ``_frac``) where one applies.
"""

from __future__ import annotations

__all__ = ["COUNTERS", "GAUGES", "HISTOGRAMS", "ALL_METRIC_NAMES"]

COUNTERS: frozenset[str] = frozenset(
    {
        # core peel/exec layer
        "batch_bisects",
        "batches_run",
        "deadline_misses",
        "device_seconds_total",
        "dispatch_failures",
        "dispatches",
        "peel_batches",
        "peel_device_seconds_total",
        "peel_dispatches",
        "peel_fused_levels",
        "peel_slots",
        # compile cache
        "cache_bucket_compiles",
        "cache_bucket_hits",
        "cache_compiles",
        "cache_hits",
        # session / query lifecycle
        "queries_failed",
        "queries_quarantined",
        "queries_shed",
        "requests_served",
        # resilience
        "backend_fallbacks",
        "faults_injected",
        "retries",
        # streaming
        "stream_checkpoints",
        "stream_edges_repeeled",
        "stream_enumerations",
        "stream_update_dispatches",
        "stream_updates",
        # serving tier (router + fleet)
        "fleet_replica_restarts",
        "fleet_stream_handoffs",
        "router_affinity_cold",
        "router_affinity_hits",
        "router_affinity_redistributed",
        "router_quarantines",
        "router_queries_shed",
        "router_query_retries",
        "router_replica_spill_in",
        "router_replicas_quarantined",
        "router_spillovers",
    }
)

GAUGES: frozenset[str] = frozenset(
    {
        "queue_depth",
        "replica_compiled_buckets",
        "replica_live_queries",
        "replica_queue_depth",
        # router-side mirrors of replica counters (ingested snapshots land
        # as gauges: the router tracks each replica's latest value, not a
        # monotonic sum of its own)
        "replica_queries_failed",
        "replica_queries_quarantined",
        "replica_queries_shed",
        "replica_requests_served",
        "replica_retries",
    }
)

HISTOGRAMS: frozenset[str] = frozenset(
    {
        "batch_occupancy",
        "peel_batch_imbalance",
        "peel_device_time_s",
        "peel_level_edges",
        "peel_slot_iters",
        "peel_slot_levels",
        "stream_frontier_frac",
    }
)

ALL_METRIC_NAMES: frozenset[str] = COUNTERS | GAUGES | HISTOGRAMS
