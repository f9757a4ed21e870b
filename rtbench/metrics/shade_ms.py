"""Shading: device ms a frame in K2 (hrt_brdf_light_major), the
light-major Disney BRDF."""
from rtbench import devtrace


def read(ctx):
    st = ctx["stretch"]
    if st is None:
        return None
    ms = st.per_frame_ms(lambda lb: devtrace.entry_of(lb)
                         in devtrace.SHADE_ENTRIES)
    return ms if ms > 0 else None
