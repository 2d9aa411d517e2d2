"""Mean queue wait of the requests the engine admitted in the window, in
ms: the engine's ``queue_wait_s`` (each request's submit to the formation
of the wave that admits it, summed) over its ``admitted_requests``, both
taken over the window.  Layer: the scheduler (``engine._form_wave``,
``_ragged_tick``, ``_decode_tick``)."""


def read(r):
    n = r.counters.get("admitted_requests", 0)
    if not n or "queue_wait_s" not in r.counters:
        return None
    return 1e3 * r.counters["queue_wait_s"] / n
