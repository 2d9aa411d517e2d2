"""The share of the device's idle between dispatches that the host spent on
the event loop, in %: the engine's ``gap_loop_s`` (the idle whose host
interval overlapped the hop to the dispatch thread and back, and what the
loop ran meanwhile: token delivery, the consumers, the traffic) over its
``device_gap_s``, both taken over the window.  Layer: the dispatch loop
(``engine._serve``, ``_on_worker``, the tick's launch and landing)."""


def read(r):
    gap = r.counters.get("device_gap_s", 0)
    if not gap or "gap_loop_s" not in r.counters:
        return None
    return 100.0 * r.counters["gap_loop_s"] / gap
