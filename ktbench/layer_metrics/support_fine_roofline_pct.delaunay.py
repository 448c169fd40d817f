"""The support kernel's share of its bytes roofline, in the Delaunay
graph's cell: the bytes bound of every level of every decompose the traced
process dispatched (counted from the graph and the reference's trussness,
``ktbench.roofline.level_bytes``: the same work whatever implements it)
over the device time of the trip loops that ran them.

The profiler does not trace the kernels inside the trip graph's WHILE
node, so ``support_fine_cuda``'s two launches are not in the device
trace.  The time is the replays' CUDA-event pairs (``device_seconds_total``,
the dispatches' device time), which hold every trip's support pass and
the rest of the trip beside it: the share is a lower bound of the
kernel's own.  Each request of the one-client mix is one dispatch, and
each pool graph is warmed once before the window."""

from ktbench import roofline
from ktbench.program_counters import counters, times_launches_on_device


def read(ctx):
    if not times_launches_on_device(ctx) or not ctx.truths:
        return None
    seconds = counters().get("device_seconds_total", 0.0)
    drv = ctx.driver
    uses = [1] * len(drv.pool)  # the warm requests
    for j in range(drv.requests):
        uses[drv.graph_of(j)] += 1
    if seconds <= 0 or any(gi not in ctx.truths for gi in range(len(uses))):
        return None
    nbytes = sum(u * roofline.level_bytes(drv.pool[gi][0], ctx.truths[gi])
                 for gi, u in enumerate(uses))
    return roofline.roofline_pct(nbytes, seconds)
