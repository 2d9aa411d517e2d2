"""The 95th percentile of turn time, from each request's due time to its
last token, over the requests due in the window, in ms: queue wait and
service.  Layer: the client (its requests or turns)."""

from loadbench.harness import end_to_end


def read(r):
    return end_to_end(r.records, r.window).get("turn_p95_ms")
