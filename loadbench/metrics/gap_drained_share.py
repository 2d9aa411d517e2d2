"""The share of the device's idle between dispatches that followed a host
sync which left nothing queued behind it (a wave's first-token landing, a
drain), in %: the engine's ``gap_drained_s`` over its ``device_gap_s``,
both taken over the window.  The rest is the host falling behind a device
that still had work queued.  Layer: the dispatch loop (``engine._serve``,
``_on_worker``, the tick's launch and landing)."""


def read(r):
    gap = r.counters.get("device_gap_s", 0)
    if not gap or "gap_drained_s" not in r.counters:
        return None
    return 100.0 * r.counters["gap_drained_s"] / gap
