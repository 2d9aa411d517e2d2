"""Mean rows of a decode dispatch as a share of ``max_batch_size``: the
engine's ``occupancy_sum`` / ``decode_dispatches`` over the window, in %.
Layer: the scheduler (``engine._form_wave``, ``_ragged_tick``,
``_decode_tick``)."""


def read(r):
    n = r.counters.get("decode_dispatches", 0)
    return 100.0 * r.counters["occupancy_sum"] / n if n else None
