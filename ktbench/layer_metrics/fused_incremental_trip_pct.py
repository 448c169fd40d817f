"""The share of the fused level kernel's inner trips that took their
supports from the last trip's deaths instead of counting every alive lane
again: 100 x ``peel_level_trips_incremental`` / ``peel_level_trips``, over
the whole traced process.  A program that does not count update trips
reports nothing."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_level_trips_incremental", "peel_level_trips", scale=100.0)
