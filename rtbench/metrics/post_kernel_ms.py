"""Post: device ms a frame in K6 (hrt_warp_bilinear, the history
warps of SVGF and the temporal upscaler) and the upscaler's
convolution kernels."""
from rtbench import devtrace


def read(ctx):
    st = ctx["stretch"]
    if st is None:
        return None
    ms = st.per_frame_ms(lambda lb: devtrace.entry_of(lb)
                         in devtrace.WARP_ENTRIES or devtrace.is_conv(lb))
    return ms if ms > 0 else None
