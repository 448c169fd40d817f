"""The device's idle share over the profiled stretch of whole requests:
100 x (1 - busy / wall), where busy is the union of the intervals of the
profiler's kernels, copies and sets on the device."""


def read(ctx):
    st = ctx.stretch
    if st is None or st.window_s <= 0 or st.busy_s <= 0:
        return None
    return 100.0 * (1.0 - st.busy_s / st.window_s)
