"""Renderer glue: device ms a frame over the program's `nee.d<k>` stage
clocks, every depth: sky, the light batch, K2, the shadow walk and
emission.  From the program-trace probe (rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.stage_ms(ctx, lambda k: k.startswith("nee.d"))
