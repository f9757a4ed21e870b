"""Renderer glue: device ms a frame over the program's `hit.d<k>` stage
clocks, every depth: the bounce sort where it is on, the closest-hit
walk (K1 or K3) and the attribute gather.  Less `walk_ms`'s closest
walks, this stage's glue.  From the program-trace probe
(rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.stage_ms(ctx, lambda k: k.startswith("hit.d"))
