"""Mean prefill span of the requests the engine admitted in the window, in
ms: the engine's ``prefill_span_s`` (each request's wave formation to the
landing of its first token, summed) over its ``admitted_requests``, both
taken over the window.  Layer: the scheduler (``engine._form_wave``,
``_ragged_tick``, ``_decode_tick``)."""


def read(r):
    n = r.counters.get("admitted_requests", 0)
    if not n or "prefill_span_s" not in r.counters:
        return None
    return 1e3 * r.counters["prefill_span_s"] / n
