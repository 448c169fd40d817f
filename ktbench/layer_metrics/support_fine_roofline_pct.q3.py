"""``support_fine_roofline_pct.delaunay``, read as its own reader reads it,
in the shared-queries cell, where each request is one dispatch of three
live members on one Delaunay graph.  It counts one decompose's level bytes
a request: the kmax and the 4-truss follow from the trussness, so that
bound is the request's least work, whatever implements it."""

from ktbench.spec import load_reader


def read(ctx):
    return load_reader("layer_metrics", "support_fine_roofline_pct.delaunay").read(ctx)
