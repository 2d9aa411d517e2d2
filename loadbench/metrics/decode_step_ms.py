"""Milliseconds per decode step over the window, on the host's clock: the
mean gap before each token after a request's first that came in the
window (``Readings.step_s``), whatever the engine's dispatches' lengths.
Layer: the decode dispatch (``engine._decode_body`` →
``model.decode_step_ring_paged``)."""


def read(r):
    step = r.step_s(*r.window)
    return 1e3 * step if step else None
