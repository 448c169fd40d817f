"""Inner trips per fused level launch: ``peel_level_trips`` over
``peel_fused_levels``, over the whole traced process."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_level_trips", "peel_fused_levels")
