"""Set-up: host seconds of the SAH build (hrt_tpu_torch.ops.lbvh.
build_bvh_sah, through the program's native library) inside the frame
loop's construction, bracketed by the benchmark, the device synchronised
at its end."""
import math


def read(ctx):
    s = ctx["prep"].accel_build_s
    return None if s is None or math.isnan(s) else s
