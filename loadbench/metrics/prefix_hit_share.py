"""Share of the prompt tokens submitted in the window that the prefix cache
served: the engine's ``prefix_reused_tokens`` over the window / the prompt
tokens of the requests due in the window (the benchmark's own count), in %.
Layer: pages and the prefix cache (``inference/paged.py``,
``engine._plan_prefix_reuse``)."""


def read(r):
    prompt = sum(len(x.prompt) for x in r.in_window())
    if not prompt or "prefix_reused_tokens" not in r.counters:
        return None
    return 100.0 * r.counters["prefix_reused_tokens"] / prompt
