"""Walks: device ms a frame in the BVH walks, closest and shadow
any-hit: K1 (hrt_bvh8_trace) and K3 (hrt_skip_trace) over one BVH, K4
(hrt_tlas8_trace) and K5 (hrt_tlas_skip_trace) over a TLAS and its
BLASes."""
from rtbench import devtrace


def read(ctx):
    st = ctx["stretch"]
    if st is None:
        return None
    ms = st.per_frame_ms(lambda lb: devtrace.entry_of(lb)
                         in devtrace.WALK_ENTRIES)
    return ms if ms > 0 else None
