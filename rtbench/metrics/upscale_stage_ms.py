"""Post: device ms a frame of the program's `upscale` stage clock: the
temporal upscaler's history reprojection (K6) and its net.  From the
program-trace probe (rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.stage_ms(ctx, lambda k: k == "upscale")
