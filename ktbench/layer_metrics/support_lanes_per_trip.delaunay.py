"""Lanes a trip's support pass counts, in the Delaunay graph's cell: the
lanes given to the support passes of the unfused trip loops
(``peel_support_lanes``, the live slots' effective alive lanes of each
trip) over their trips (``peel_trips``), over the whole traced process."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_support_lanes", "peel_trips")
