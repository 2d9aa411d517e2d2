"""The whole step's share of the chip's bf16 peak, in %: the model
operations that the window's work needed (2 per matmul parameter for every
computed position, uncached prompt positions and generated tokens, plus
the causal attention of each), counted from the requests and the
configuration, over the window's seconds at the peak.  Layer: the whole
step."""


def read(r):
    peaks = r.peaks
    if peaks is None:
        return None
    flops = r.flops(*r.window)
    return 100.0 * flops / (r.window_s * peaks["bf16_flops"]) if flops else None
