"""Set-up: host seconds of the acceleration structure's build inside
the frame loop's construction, bracketed by the benchmark, the device
synchronised at its end: the SAH build (hrt_tpu_torch.ops.lbvh.
build_bvh_sah, through the program's native library), or with the
configuration's `accel` "two_level" the TLAS and BLASes
(hrt_tpu_torch.ops.tlas.build_two_level_flat)."""
import math


def read(ctx):
    s = ctx["prep"].accel_build_s
    return None if s is None or math.isnan(s) else s
