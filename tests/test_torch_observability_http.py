"""The port's consumer nodes and its ``/metrics`` endpoint against the JAX
package's.

**The reference suites, rebound** (``tests/_torch_rebind.py``): the two
consumer cases of ``tests/test_kernel.py::TestConsumer`` (it observes a
hop's published outcome without adding traffic for the caller; a consumer
body that raises leaves the run unaffected), driven by
``tests/kernel_harness.py`` rebound too;
``tests/test_chaos.py::TestConsumerCancelShortCircuit`` (a cancel record
reaches the cancellation targets, never the consumer's body); the three
cases of ``tests/test_observability.py::TestMetricsServer`` (``/metrics``,
``/healthz``, 404; liveness against readiness; ``/flightrec``), the
worker's readiness probe of ``TestReadinessProbes``, and
``tests/test_capacity.py``'s ``/capacity`` endpoint.

**Two endpoints, one answer.**  Each package's ``MetricsServer``, over a
registry holding the same instruments, answers the same raw requests —
paths, a query string, a probe that is missing, false with a reason,
true, malformed (a 1-tuple), raising, an HTTP/1.1 client, a request line
past the limit, garbage — with the same bytes; and the port's model client
is unready until its engine is built, as the JAX package's is.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect

import pytest

from tests._torch_rebind import ported_module

ROOTS = {"ref": "calfkit_tpu", "port": "calfkit_tpu_torch"}


def _run(result, timeout: float = 60) -> None:
    if inspect.isawaitable(result):
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(asyncio.wait_for(result, timeout=timeout))
        finally:
            loop.close()


def _kernel_suite() -> dict:
    harness = ported_module("tests.kernel_harness")
    return ported_module("tests.test_kernel", variant="harness", overrides={
        name: harness[name] for name in ("INBOX", "Caller", "deploy")})


def _mesh_and_caller(g: dict):
    """``tests/test_kernel.py``'s ``mesh_and_caller`` fixture on the port."""
    async def make():
        mesh = g["InMemoryMesh"]()
        await mesh.start()
        caller = g["Caller"](mesh)
        await caller.start()
        return mesh, caller

    return make


def test_the_rebound_suites_are_the_ports():
    from calfkit_tpu_torch.mesh import InMemoryMesh
    from calfkit_tpu_torch.nodes import consumer
    from calfkit_tpu_torch.observability.capacity import CapacitySampler
    from calfkit_tpu_torch.observability.metrics import MetricsRegistry

    g = _kernel_suite()
    assert g["consumer"] is consumer and g["InMemoryMesh"] is InMemoryMesh
    assert g["Caller"].__module__ == "tests.kernel_harness"
    assert g["deploy"].__globals__["InMemoryMesh"] is InMemoryMesh
    assert ported_module("tests.test_observability")["MetricsRegistry"] is MetricsRegistry
    assert ported_module("tests.test_capacity")["CapacitySampler"] is CapacitySampler
    assert [n for n in vars(importlib.import_module("tests.test_kernel").TestConsumer)
            if n.startswith("test_")] == [name for name in CONSUMER_CASES]


CONSUMER_CASES = ["test_observes_without_replying", "test_consumer_error_floor"]


@pytest.mark.parametrize("name", CONSUMER_CASES)
def test_kernel_consumer_case_on_the_port(name):
    g = _kernel_suite()
    _run(getattr(g["TestConsumer"](), name)(_mesh_and_caller(g)))


def test_consumer_cancel_short_circuit_on_the_port():
    g = ported_module("tests.test_chaos", variant="consumer")
    _run(g["TestConsumerCancelShortCircuit"]().test_cancel_record_never_reaches_consumer_fn())


@pytest.mark.parametrize("name", [
    "test_serves_metrics_and_health",
    "test_healthz_is_liveness_readyz_is_readiness",
    "test_flightrec_endpoint_dumps_registered_journals",
])
def test_metrics_server_case_on_the_port(name):
    g = ported_module("tests.test_observability")
    _run(getattr(g["TestMetricsServer"](), name)())


def test_worker_readiness_probe_on_the_port():
    g = ported_module("tests.test_observability")
    _run(g["TestReadinessProbes"]().test_worker_ready_tracks_serving_state())


def test_capacity_endpoint_on_the_port():
    g = ported_module("tests.test_capacity")
    suite = next(cls for cls in g.values() if isinstance(cls, type)
                 and "test_capacity_endpoint_serves_ndjson" in vars(cls))
    _run(suite().test_capacity_endpoint_serves_ndjson())


def test_model_client_unready_until_built():
    from calfkit_tpu.inference.client import JaxLocalModelClient
    from calfkit_tpu_torch.inference import TorchLocalModelClient

    port = TorchLocalModelClient(config="debug", device="cpu")
    ref = JaxLocalModelClient(config="debug")
    assert port.ready() == ref.ready()
    assert not port.ready()[0] and "not built" in port.ready()[1]


# --------------------------------------------------------------------------- #
# the two packages' endpoints on the same requests
# --------------------------------------------------------------------------- #


def _probe(kind: str):
    return {
        "none": None,
        "false": lambda: (False, "engine weights + dispatch lanes"),
        "true": lambda: (True, "serving"),
        "bare-true": lambda: True,
        "one-tuple": lambda: (True,),
        "raises": lambda: 1 / 0,
    }[kind]


REQUESTS = [
    ("metrics", "none", b"GET /metrics HTTP/1.0\r\n\r\n"),
    ("healthz", "none", b"GET /healthz HTTP/1.0\r\nHost: x\r\n\r\n"),
    ("readyz-unwired", "none", b"GET /readyz HTTP/1.0\r\n\r\n"),
    ("readyz-false", "false", b"GET /readyz HTTP/1.0\r\n\r\n"),
    ("readyz-true", "true", b"GET /readyz?verbose=1 HTTP/1.1\r\nHost: x\r\n"
                            b"Connection: keep-alive\r\n\r\n"),
    ("readyz-bare-true", "bare-true", b"GET /readyz HTTP/1.0\r\n\r\n"),
    ("readyz-malformed", "one-tuple", b"GET /readyz HTTP/1.0\r\n\r\n"),
    ("readyz-raises", "raises", b"GET /readyz HTTP/1.0\r\n\r\n"),
    ("not-found", "none", b"GET /nope HTTP/1.0\r\n\r\n"),
    ("garbage", "none", b"\x00\xff garbage\r\n\r\n"),
    ("too-long", "none", b"GET /" + b"a" * 9000 + b" HTTP/1.0\r\n\r\n"),
]


async def _answer(root: str, probe: str, raw: bytes) -> bytes:
    metrics = importlib.import_module(f"{root}.observability.metrics")
    http = importlib.import_module(f"{root}.observability.http")
    registry = metrics.MetricsRegistry()
    registry.counter("served_total", "requests served").inc(3)
    registry.gauge("queue_depth", "queued").set(2)
    hist = registry.histogram("latency_ms", "latency", buckets=(1, 10, 100))
    for v in (0.5, 7, 70, 700):
        hist.observe(v)
    async with http.MetricsServer(port=0, registry=registry, readiness=_probe(probe)) as server:
        reader, writer = await asyncio.open_connection("127.0.0.1", server.port)
        writer.write(raw)
        await writer.drain()
        answer = await reader.read()
        writer.close()
    return answer


@pytest.mark.parametrize("probe,raw", [r[1:] for r in REQUESTS], ids=[r[0] for r in REQUESTS])
def test_endpoint_answers_equal_reference(probe, raw):
    async def both():
        return [await _answer(root, probe, raw) for root in ROOTS.values()]

    loop = asyncio.new_event_loop()
    try:
        ref, port = loop.run_until_complete(asyncio.wait_for(both(), 30))
    finally:
        loop.close()
    assert port == ref
    if raw.startswith(b"GET /readyz") and probe in ("one-tuple", "raises", "none", "false"):
        assert port.startswith(b"HTTP/1.0 503 ") and b"unready" in port
