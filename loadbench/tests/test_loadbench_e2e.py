"""The end-to-end arithmetic of a window."""

from __future__ import annotations

import pytest

from loadbench.drive import Record
from loadbench.harness import end_to_end


def _request(due, first, gap, n, tag="r"):
    r = Record(tag, due, due, [1, 2, 3], n)
    r.tokens = list(range(n))
    r.times = [first + i * gap for i in range(n)]
    return r


def _steady(stall_at=None, stall=0.0):
    out = []
    for i in range(200):
        due = i * 0.05
        delay = stall if stall_at is not None and due >= stall_at else 0.0
        out.append(_request(due, due + 0.02 + delay, 0.01, 10, f"r{i}"))
    return out


def test_a_stall_inside_the_window_moves_the_rate_and_the_tails():
    window = (1.0, 9.0)
    calm = end_to_end(_steady(), window)
    stalled = end_to_end(_steady(stall_at=4.0, stall=3.0), window)
    assert stalled["output_tok_s"] < calm["output_tok_s"]
    assert stalled["ttft_p95_ms"] > calm["ttft_p95_ms"] + 2000
    assert stalled["turn_p95_ms"] > calm["turn_p95_ms"] + 2000
    assert calm["ttft_p50_ms"] == pytest.approx(20.0)


def test_drained_tokens_do_not_count_toward_the_rate():
    window = (0.0, 1.0)
    records = [_request(0.5, 0.6, 0.1, 10)]  # 4 tokens inside, 6 after the close
    e2e = end_to_end(records, window)
    assert e2e["tokens"] == 4 and e2e["output_tok_s"] == pytest.approx(4.0)
    assert e2e["turn_p95_ms"] == pytest.approx(1000.0)  # its latency counts whole


def test_requests_due_outside_the_window_are_not_its_requests():
    records = [_request(0.1, 0.2, 0.01, 5), _request(2.5, 2.6, 0.01, 5)]
    e2e = end_to_end(records, (1.0, 2.0))
    assert e2e["attempted"] == 0 and "ttft_p95_ms" not in e2e


def test_a_short_or_failed_request_is_counted_failed():
    short = _request(0.5, 0.6, 0.01, 5)
    short.max_new = 8
    failed = _request(0.5, 0.6, 0.01, 5)
    failed.error = "InferenceError: boom"
    e2e = end_to_end([short, failed, _request(0.5, 0.6, 0.01, 5)], (0.0, 1.0))
    assert e2e["attempted"] == 3 and e2e["failed"] == 2
