"""Device milliseconds per dispatch: ``device_seconds_total`` over
``dispatches``, over the whole traced process.  The program sums each
dispatch's launches between CUDA events; set against ``dispatch_ms``, the
rest is the host's round trips.  ``None`` where the counter holds the
host wall (off the card, or a program without the event timing)."""

from ktbench.program_counters import ratio, times_launches_on_device


def read(ctx):
    if not times_launches_on_device(ctx):
        return None
    return ratio("device_seconds_total", "dispatches", scale=1e3)
