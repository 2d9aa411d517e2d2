"""The device's idle between the engine's dispatches while it held work, in
% of the window: the engine's ``device_gap_s`` (each dispatch's start less
the previous one's end, on the device's clock) over the window's seconds.
Layer: the dispatch loop (``engine._serve``, ``_on_worker``, the tick's
launch and landing)."""


def read(r):
    gap = r.counters.get("device_gap_s")
    if gap is None or r.window_s <= 0:
        return None
    return 100.0 * gap / r.window_s
