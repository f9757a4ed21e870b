"""Captured programs: device operations (kernels, copies, fills) a
frame, counted in the traced stretch."""


def read(ctx):
    st = ctx["stretch"]
    if st is None or not st.ops:
        return None
    return len(st.ops) / st.frames
