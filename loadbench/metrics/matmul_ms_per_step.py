"""Device milliseconds per decode step of the matmuls (cuBLAS kernels) in
the traced slice / the slice's decode steps (its length over its step
time, ``Readings.step_s``).  Layer: projections, MLP and LM head
(``torch.einsum`` in ``inference/model.py``)."""

MATMUL = ("nvjet", "gemm", "gemv", "xmma", "cutlass")


def read(r):
    s = r.trace
    step = None if s is None else r.step_s(s.host_start, s.host_end)
    if not step:
        return None
    t = s.seconds(lambda name: any(k in name.lower() for k in MATMUL))
    return 1e3 * t / (s.window_s / step)
