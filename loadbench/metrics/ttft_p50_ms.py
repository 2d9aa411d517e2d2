"""The 50th percentile of TTFT, from each request's due time to its
first token, over the requests due in the window, in ms.  In a closed loop
above the engine's capacity this is mostly queue wait, set by the tokens
per second completed.  Layer: the client (its requests or turns)."""

from loadbench.harness import end_to_end


def read(r):
    return end_to_end(r.records, r.window).get("ttft_p50_ms")
