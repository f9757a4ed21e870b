"""Frame loop, host step: the mean host ms of a FrameLoop.step call
(until it returns, not until the device is done), over the window's
frames outside the traced stretch, whose profiler slows the host."""


def read(ctx):
    win = ctx["window"]
    ms = [m for i, m in enumerate(win.step_ms) if i not in win.stretch_at]
    return sum(ms) / len(ms) if ms else None
