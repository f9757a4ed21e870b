"""Post: device ms a frame of the program's `svgf` stage clock, SVGF
with its history warp (K6).  From the program-trace probe
(rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.stage_ms(ctx, lambda k: k == "svgf")
