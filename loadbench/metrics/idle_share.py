"""The device's idle share of the traced slice, in %: 1 - (the union of
the device operations' intervals) / (the slice's host-clock length), the
arithmetic of ``scripts/torch_profile_serving.py``.  Layer: the device."""


def read(r):
    s = r.trace
    if s is None or not s.device_ops or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
