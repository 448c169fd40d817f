"""Lanes whose supports the fused level kernel counted by a full
intersection, per level launch: ``peel_level_lanes_counted`` over
``peel_fused_levels``, over the whole traced process.  The kernel adds,
once a trip that counts (a launch's first, and any later one that does
not update from the last trip's deaths), the lanes it counted; a split
lane counts once.  A program that does not count them reports nothing."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_level_lanes_counted", "peel_fused_levels")
