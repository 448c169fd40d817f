"""``support_claims_per_trip.delaunay``, read as its own reader reads it, in
the shared-queries cell, where each request is one dispatch of three live
members on one Delaunay graph."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "support_claims_per_trip.delaunay").read(ctx)
