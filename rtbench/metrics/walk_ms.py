"""Walks: device ms a frame in the BVH walks, K1 (hrt_bvh8_trace) and
K3 (hrt_skip_trace), closest and shadow any-hit."""
from rtbench import devtrace


def read(ctx):
    st = ctx["stretch"]
    if st is None:
        return None
    ms = st.per_frame_ms(lambda lb: devtrace.entry_of(lb)
                         in devtrace.WALK_ENTRIES)
    return ms if ms > 0 else None
