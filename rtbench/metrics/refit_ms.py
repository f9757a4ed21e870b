"""Instance motion: device ms a frame in the replays of the loop's TLAS
refit program, from the program's `refit` clock (CUDA events around
each replay), over the moving frames of the motion-trace probe
(rtbench/motiontrace.py)."""
from rtbench import motiontrace


def read(ctx):
    return motiontrace.refit_ms(ctx)
