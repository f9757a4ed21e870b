"""Device: the idle share of a frame's cadence, 1 - (device busy
seconds a frame: the union of the device operations' intervals in the
traced stretch, over its frames) / (the median interval between the
24 frames before the stretch, from their CUDA events; on an orbit
those frames look at nearly what the stretch does).

The stretch's own host span is not the denominator: under the
profiler, each replay of a captured frame costs the host milliseconds
more (CUPTI records every node), and the frame loop's step waits for
the device before it launches, so the device idles for that cost in
the stretch alone.  `device.busy_s` and `window_s` of the result line
are the stretch's, as measured."""
import statistics

BEFORE = 24


def read(ctx):
    st, win = ctx["stretch"], ctx["window"]
    if st is None or not st.ops:
        return None
    lo = max(2, win.stretch_at.start - BEFORE)
    steady = win.frame_ms[lo:win.stretch_at.start]
    if not steady:
        return None
    busy_ms = st.busy_s() * 1e3 / st.frames
    return 1.0 - busy_ms / statistics.median(steady)
