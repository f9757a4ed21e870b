"""Renderer glue: device ms a frame over the program's `bounce.d<k>`
stage clocks, every depth but the last: the bounce sampled by lobe,
Russian roulette and retirement.  From the program-trace probe
(rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.stage_ms(ctx, lambda k: k.startswith("bounce.d"))
