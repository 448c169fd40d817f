"""``fused_incremental_trip_pct`` in the stream cell: the share of the
fused level kernel's inner trips that were updates from the last trip's
deaths, over every launch of the traced process (the stream's opening
decompose, its warm updates, the window and the stretch)."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_level_trips_incremental", "peel_level_trips", scale=100.0)
