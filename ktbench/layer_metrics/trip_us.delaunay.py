"""Device microseconds per trip of the unfused peel's trip loop, in the
Delaunay graph's cell: the trip graph's replays' CUDA-event time
(``device_seconds_total``) over the trips of their loops (``peel_trips``),
over the whole traced process.  The program counts device seconds only on
the card; ``None`` where it does not count its trips."""

from ktbench.program_counters import ratio, times_launches_on_device


def read(ctx):
    if not times_launches_on_device(ctx):
        return None
    return ratio("device_seconds_total", "peel_trips", scale=1e6)
