"""Frame loop, host step: the mean host ms a step of the program's spans
`frameloop.key` (the signatures and the key), `graphs.copy_in`,
`graphs.replay` and `graphs.copy_out`: what the host does each frame
once nothing waits for the card, over the frames of the program-trace
probe (rtbench/progtrace.py)."""
from rtbench import progtrace


def read(ctx):
    return progtrace.span_ms(ctx, progtrace.ISSUE_SPANS)
