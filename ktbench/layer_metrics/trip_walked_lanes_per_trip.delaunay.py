"""Lanes a trip's per-lane passes walk, in the Delaunay graph's cell: the
lanes of the slots the unfused trip loops peeled (``peel_trip_lanes_walked``,
each loop's trips times the lanes of its walked slots) over their trips
(``peel_trips``), over the whole traced process.  ``None`` for a program
that does not count the lanes it walks."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_trip_lanes_walked", "peel_trips")
