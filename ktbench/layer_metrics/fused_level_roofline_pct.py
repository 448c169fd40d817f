"""The fused level kernel's share of its bytes roofline over the profiled
stretch: the summed bytes bound of every level of every decompose in the
stretch (counted from the graph and the reference's trussness,
``ktbench.roofline.level_bytes``) over the profiler's summed time of the
kernel (``peel_fused_kernel``) in the same stretch."""

from ktbench import roofline

KERNEL = "peel_fused_kernel"


def read(ctx):
    st = ctx.stretch
    if st is None:
        return None
    seconds = st.device_seconds(KERNEL)
    if seconds <= 0:
        return None
    nbytes = 0
    for ans in st.requests:
        n = ctx.driver.pool[ans.graph][0]
        nbytes += roofline.level_bytes(n, ctx.truths[ans.graph])
    return roofline.roofline_pct(nbytes, seconds)
