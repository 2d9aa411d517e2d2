"""Observability of the PyTorch engine: the port's own copies of the JAX
package's telemetry modules.

- :mod:`~calfkit_tpu_torch.observability.metrics` — counters, gauges and
  fixed-bucket histograms, rendered as Prometheus text (``metrics_text``);
- :mod:`~calfkit_tpu_torch.observability.flightrec` — the engine's flight
  recorder: a ring journal of scheduler events, dumped to JSONL;
- :mod:`~calfkit_tpu_torch.observability.capacity` — the page ledger (who
  holds which KV pages) and the occupancy sampler;
- :mod:`~calfkit_tpu_torch.observability.trace` — trace contexts, spans
  and the process tracer;
- :mod:`~calfkit_tpu_torch.observability.http` — ``MetricsServer``, the
  optional asyncio endpoint: ``/metrics``, ``/healthz`` (liveness),
  ``/readyz`` (a readiness probe), ``/flightrec`` and ``/capacity``.

Everything here is fail-open: telemetry errors never fault serving.
"""
