"""The share of the device's idle between dispatches that the host spent
launching, in %: the engine's ``gap_launch_s`` (the idle whose host
interval overlapped a replay call, or the staging of its outputs' host
copies) over its ``device_gap_s``, both taken over the window.  Layer: the
dispatch loop (``engine._serve``, ``_on_worker``, the tick's launch and
landing)."""


def read(r):
    gap = r.counters.get("device_gap_s", 0)
    if not gap or "gap_launch_s" not in r.counters:
        return None
    return 100.0 * r.counters["gap_launch_s"] / gap
