"""Renderer glue: device ms a frame in every operation that is neither
one of the program's kernels (`hrt_*`) nor a convolution kernel: the
torch ops of raygen, the attribute gather, sky, sampling, roulette,
NEE batching and the post stages' elementwise work."""
from rtbench import devtrace


def read(ctx):
    st = ctx["stretch"]
    if st is None or not st.ops:
        return None
    return st.per_frame_ms(lambda lb: not devtrace.is_port_kernel(lb)
                           and not devtrace.is_conv(lb))
