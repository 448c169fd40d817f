"""Global claims and reservations the support kernel makes a trip, in the
Delaunay graph's cell: the atomics on one global word that the support
passes' two launches made to claim items and reserve worklist spans
(``peel_support_claims``, counted by the kernel in each captured pass) over
the trips of the unfused trip loops (``peel_trips``), over the whole traced
process.  ``None`` for a program that does not count its claims."""

from ktbench.program_counters import ratio


def read(ctx):
    return ratio("peel_support_claims", "peel_trips")
