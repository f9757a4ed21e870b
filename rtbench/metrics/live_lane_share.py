"""Renderer glue: the useful share of the lanes that every depth's glue
runs over, Σ_k live.d<k> / (depths traced × lanes), from the program's
live-ray counters (`live.d<k>`: rays active on entry to depth k) over
the frames of the program-trace probe (rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.live_lane_share(ctx)
