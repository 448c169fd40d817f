"""Lanes the fused level kernel's per-lane passes visited, per level
launch: ``peel_level_lanes_walked`` over ``peel_fused_levels``, over the
whole traced process.  A launch walks the lanes of the slots that can
change (those not done at launch, and the done slots its state out does not
hold yet), ``slot_nnz`` lanes a slot.  A program that does not count them
reports nothing."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_level_lanes_walked", "peel_fused_levels")
