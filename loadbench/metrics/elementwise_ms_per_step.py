"""Device milliseconds per decode step of every operation that is neither
attention, nor a matmul, nor a copy: in the traced slice, the elementwise
and reduction kernels (the weights' dequant behind ``model._w`` among them)
/ the slice's decode steps (its length over its step time,
``Readings.step_s``).  Layer: weights and elementwise ops
(``inference/quant.py``, ``inference/model.py``)."""

NOT_ELEMENTWISE = (
    "attn", "nvjet", "gemm", "gemv", "xmma", "cutlass", "Memcpy", "Memset",
)


def read(r):
    s = r.trace
    step = None if s is None else r.step_s(s.host_start, s.host_end)
    if not step:
        return None
    t = s.seconds(lambda name: not any(k.lower() in name.lower() for k in NOT_ELEMENTWISE))
    return 1e3 * t / (s.window_s / step)
