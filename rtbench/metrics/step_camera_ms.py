"""Frame loop, host step: the mean host ms a step of the program's span
`frameloop.camera` (FrameLoop.step's camera arrays, made and copied to
the card), over the frames of the program-trace probe
(rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.span_ms(ctx, ("frameloop.camera",))
