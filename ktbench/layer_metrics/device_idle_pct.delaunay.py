"""The device's idle share over the profiled stretch, in the Delaunay
graph's cell: 100 x (1 - busy / wall), where busy is ``device_idle_pct``'s
(the union of the profiler's kernels, copies and sets) plus the trip
graph's replays.  The profiler does not trace the kernels inside the
trip graph's WHILE node, so a replay would read as idle: each of the
stretch's requests (one dispatch each) adds the mean device time of a
dispatch over the traced process (``device_seconds_total`` /
``dispatches``, the replays' CUDA-event pairs).  ``None`` off the card
and where the program does not time its replays."""

from ktbench.program_counters import ratio, times_launches_on_device


def read(ctx):
    st = ctx.stretch
    if st is None or st.window_s <= 0 or st.busy_s <= 0 or not times_launches_on_device(ctx):
        return None
    per_dispatch = ratio("device_seconds_total", "dispatches")
    if per_dispatch is None:
        return None
    busy = min(st.window_s, st.busy_s + len(st.requests) * per_dispatch)
    return 100.0 * (1.0 - busy / st.window_s)
