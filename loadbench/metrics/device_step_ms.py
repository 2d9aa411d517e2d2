"""Device milliseconds per decode step over the window: the device time of
the engine's decode and mixed (ragged) dispatches, on the device's clock
(``device_decode_s`` + ``device_mixed_s``), over the steps those dispatches
ran (``decode_steps``).  A mixed dispatch's prefill chunk counts in its
time.  Layer: the decode dispatch (``engine._decode_body``,
``model.decode_step_ring_paged``)."""


def read(r):
    c = r.counters
    steps = c.get("decode_steps", 0)
    if not steps or "device_decode_s" not in c or "device_mixed_s" not in c:
        return None
    return 1e3 * (c["device_decode_s"] + c["device_mixed_s"]) / steps
