"""CUDA graph captures inside the window (the engine's graph pool's
``captures``): every dispatch shape should be captured before it, so a
capture here is set-up work that fell into the window.  Layer: compiled
dispatch (``inference/graphs.py``)."""


def read(r):
    return r.captures
