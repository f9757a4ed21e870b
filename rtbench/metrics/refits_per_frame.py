"""Instance motion: TLAS refits a frame, the program's `tlas.refit`
spans over its `frameloop.step` spans, over the moving frames of the
motion-trace probe (rtbench/motiontrace.py)."""
from rtbench import motiontrace


def read(ctx):
    return motiontrace.refits_per_frame(ctx)
