"""One run of one cell: make the weights, build the engine, prepare its
dispatches, warm up on the cell's own traffic, measure for ``seconds``,
drain, read the device's peak memory, free the engine, and judge what the
window served against the plain reference.

The window is [``start_at + ramp_s``, ``+ seconds``): the traffic runs from
``start_at`` and stops submitting at the window's end; the requests in
flight then drain.  ``setup_s`` is the process's time up to the window's
start.  With ``trace`` the window runs untraced, as in a run without it,
and the per-layer metrics read from the host's clock and from the engine's
counters are taken over it.  Once it has drained, the traffic starts again
on token ids of its own, runs its ramp, and a slice of ``TRACE_S`` seconds
(at most a quarter of the window) runs under ``torch.profiler``: the
per-layer metrics read from the device's trace are taken over that slice.
Starting and stopping the profiler stalls the engine for seconds, which
thus falls outside the window.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import importlib.util
import resource
import sys
import threading
import time

import numpy as np

from loadbench import configs, drive, manifest, traffic, weights
from loadbench.readings import Readings

DRAIN_S = 240.0  # the longest a window's last requests may take to finish
TRACE_S = 3.0


def percentile(values: list, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def end_to_end(records: list, window: "tuple[float, float]") -> dict:
    """The end-to-end numbers of the requests due inside ``window``: TTFT
    and turn time from each request's due time, and every token that came
    inside the window over the window's seconds."""
    lo, hi = window
    due = [r for r in records if lo <= r.due < hi]
    done = [r for r in due if r.complete]
    ttft = [(r.times[0] - r.due) * 1e3 for r in done]
    turn = [(r.times[-1] - r.due) * 1e3 for r in done]
    tokens = sum(1 for r in records for t in r.times if lo <= t < hi)
    out = dict(attempted=len(due), failed=len(due) - len(done), tokens=tokens)
    if done:
        out.update(
            ttft_p50_ms=percentile(ttft, 50), ttft_p95_ms=percentile(ttft, 95),
            turn_p95_ms=percentile(turn, 95), output_tok_s=tokens / (hi - lo),
        )
    return out


def _load_reader(name: str):
    path = manifest.reader_path(name)
    spec = importlib.util.spec_from_file_location(f"loadbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def per_layer(names: list, readings: Readings) -> dict:
    """{name: value} of every reader that found something to read."""
    out = {}
    for name in names:
        value = _load_reader(name)(readings)
        if value is not None:
            out[name] = float(value)
    return out


def _sample(records: list, seed: int, target: int, most: int) -> list:
    """The requests the reference checks: the one with the most served
    tokens, the one with the longest context, then others drawn from the
    seed until ``target`` served tokens or ``most`` requests."""
    done = [r for r in records if r.complete]
    if not done:
        return []
    picked = [max(done, key=lambda r: (len(r.tokens), len(r.prompt)))]
    longest = max(done, key=lambda r: len(r.prompt) + len(r.tokens))
    if longest is not picked[0]:
        picked.append(longest)
    rng = np.random.default_rng([int(seed) % (1 << 63), 77])
    for i in rng.permutation(len(done)):
        if len(picked) >= most or sum(len(r.tokens) for r in picked) >= target:
            break
        if all(done[i] is not r for r in picked):
            picked.append(done[i])
    return picked


def judge(arch: dict, config: dict, seed: int, device, sample: list) -> dict:
    """The gaps by which the sampled requests' served tokens' logits lie
    below the plain reference's best at their positions: their mean over
    every served token (the number compared) and the widest; the reference
    runs on weights it makes again from ``seed``."""
    import torch

    from loadbench.reference.decoder import Decoder, gaps

    params = weights.make(arch, seed, device)
    ref = Decoder(arch, params, config.get("reference_weights", arch["dtype"]))
    found = []
    for r in sample:
        full = r.prompt + r.tokens[:-1]
        logits = ref.logits(full, first=len(r.prompt) - 1)
        found.append(gaps(logits, r.tokens).double().cpu())
        del logits
    del ref, params
    every = torch.cat(found) if found else torch.zeros(0, dtype=torch.float64)
    return dict(
        mean_logit_gap=float(every.mean()) if len(every) else 0.0,
        max_logit_gap=float(every.max()) if len(every) else 0.0,
        tokens_checked=len(every), requests_checked=len(sample),
    )



def build(cell: dict, config: dict, spec: dict, seed: int, horizon_s: float, device,
          control: bool, log) -> "tuple":
    """The weights from ``seed``, the engine over them with every dispatch
    shape of the traffic prepared, and the traffic's plan for
    ``horizon_s`` seconds → (engine, generator, plan, runtime fields)."""
    import torch

    from calfkit_tpu_torch.inference.config import ModelConfig, RuntimeConfig
    from calfkit_tpu_torch.inference.engine import InferenceEngine

    arch = configs.arch(config)
    rt_fields = configs.runtime_fields(config, control)
    runtime = RuntimeConfig(**rt_fields)
    model = ModelConfig(**configs.model_fields(config, cell["config"]))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    started = time.perf_counter()
    params = weights.make(arch, seed, device)
    engine = InferenceEngine(model, runtime, params=params, device=device)
    del params
    print(f"loadbench: weights and engine {time.perf_counter() - started:.1f} s", file=log)
    gen = traffic.generator(spec["kind"])
    plan = gen.plan(spec, seed, arch["vocab"], runtime.max_seq_len, horizon_s)
    drive.prepare_shapes(engine, gen, plan, log)
    return engine, gen, plan, rt_fields


def _profiler(device):
    import torch

    # CUDA activity records the kernels and the host's CUDA runtime calls
    # (what the host was doing in an idle gap); on the CPU, the CPU's own
    # operations
    cuda = device.type == "cuda"
    activity = torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU
    return torch.profiler.profile(activities=[activity])


async def _traced_phase(engine, gen, spec: dict, seed: int, vocab: int, max_seq_len: int,
                        seconds: float, device, log) -> "tuple":
    """After the window: the traffic again from an idle engine, on token ids
    drawn from ``seed`` + 1 (so that the prefix cache holds none of them),
    for its ramp, then ``seconds`` of it under ``torch.profiler`` →
    (the profiler, the slice's start and end, its records, the generator's
    task, {profiler phase: seconds}).  The events are read only later, by
    :func:`loadbench.trace.reduce`."""
    import torch

    cuda = device.type == "cuda"
    took = {}
    # the profiler's first start sets up its tracing of the device: do it
    # while the engine idles, so that the start in the traffic is short
    t0 = time.perf_counter()
    warm = _profiler(device)
    warm.start()
    warm.stop()
    took["profiler_warmup_s"] = time.perf_counter() - t0
    plan = gen.plan(spec, seed + 1, vocab, max_seq_len, spec["ramp_s"] + seconds)
    start_at = time.perf_counter() + 0.05
    ctx = drive.Context(engine, start_at, start_at + spec["ramp_s"] + seconds)
    task = asyncio.ensure_future(gen.drive(plan, ctx))
    await ctx.sleep_until(start_at + spec["ramp_s"])
    prof = _profiler(device)
    with replay_gate() as gate:
        with gate:
            t0 = time.perf_counter()
            prof.start()
        t_a = time.perf_counter()
        await asyncio.sleep(seconds)
        with gate:
            if cuda:
                torch.cuda.synchronize(device)
            t_b = time.perf_counter()
            prof.stop()
            t1 = time.perf_counter()
    took.update(profiler_start_s=t_a - t0, profiler_stop_s=t1 - t_b)
    print("loadbench: " + ", ".join(f"{k} {v:.3f}" for k, v in took.items()), file=log)
    return prof, t_a, t_b, ctx.records, task, took


async def _measure(cell: dict, config: dict, spec: dict, seed: int, seconds: float,
                   trace: bool, device, control: bool, log) -> dict:
    import torch

    arch = configs.arch(config)
    cuda = device.type == "cuda"
    engine, gen, plan, rt_fields = build(
        cell, config, spec, seed, spec["ramp_s"] + seconds, device, control, log
    )
    await engine.start()
    start_at = time.perf_counter() + 0.05
    window = (start_at + spec["ramp_s"], start_at + spec["ramp_s"] + seconds)
    ctx = drive.Context(engine, start_at, window[1])
    tasks = [asyncio.ensure_future(gen.drive(plan, ctx))]
    out: dict = {}
    traced = None
    try:
        await ctx.sleep_until(window[0])
        window_start = time.perf_counter()
        c0, g0 = engine.stats.counters(), drive.graph_captures(engine)
        await ctx.sleep_until(window[1])
        c1, g1 = engine.stats.counters(), drive.graph_captures(engine)
        if cuda:
            out["allocated_at_close"] = int(torch.cuda.memory_allocated(device))
        out["setup_window_start"] = window_start
        try:
            await asyncio.wait_for(asyncio.shield(tasks[0]), DRAIN_S)
        except asyncio.TimeoutError:
            print("loadbench: requests still in flight after the drain limit", file=log)
        if cuda:
            torch.cuda.synchronize(device)
            out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
        if trace:
            traced = await _traced_phase(
                engine, gen, spec, seed, arch["vocab"], rt_fields["max_seq_len"],
                min(TRACE_S, seconds / 4), device, log,
            )
            tasks.append(traced[4])
    finally:
        # the traced phase's requests end here, unfinished: none is judged
        await engine.stop()
        for task in tasks:
            if not task.done():
                task.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        del engine
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    out.update(arch=arch, runtime=rt_fields, records=ctx.records, window=window,
               counters=_delta(c0, c1),
               captures=None if g0 is None or g1 is None else g1 - g0)
    if traced is not None:
        from loadbench.trace import reduce

        prof, t_a, t_b, records, _, took = traced
        out["slice"] = reduce(prof, t_a, t_b)
        out["records"] = ctx.records + records
        out.update(took)
    return out


@contextlib.contextmanager
def replay_gate():
    """A lock that every CUDA graph replay takes while the gate is open.
    Starting or stopping the profiler's CUDA tracing while another thread
    is inside a graph launch can deadlock the two (seen on the card: the
    engine's dispatch thread in ``CUDAGraph.replay``, the profiler's
    ``stop`` waiting), so the profiler starts and stops holding it; a
    replay waits until it has."""
    import torch

    lock = threading.Lock()
    graph = torch.cuda.CUDAGraph
    original = graph.replay

    def replay(self):
        with lock:
            return original(self)

    graph.replay = replay
    try:
        yield lock
    finally:
        graph.replay = original


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a if isinstance(a[k], (int, float))}


def run(bench: dict, cell: dict, seed: int, seconds: float, trace: bool, device,
        process_start: float, control: bool = False, log=sys.stderr) -> "tuple[dict, dict]":
    """One run → (the result object, diagnostics for standard error)."""
    import torch

    config = configs.load(cell["config"])
    spec = traffic.load(cell["traffic"])
    m = asyncio.run(_measure(cell, config, spec, seed, seconds, trace, device, control, log))
    setup_s = m["setup_window_start"] - process_start
    records, window = m["records"], m["window"]
    e2e = end_to_end(records, window)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    readings = Readings(m["arch"], m["runtime"], name, records, window, m["counters"],
                        m["captures"], m.get("slice"))
    wanted = [x["name"] for x in manifest.metrics_of(bench, cell["name"], trace)]
    if trace:
        metrics = per_layer(wanted, readings)
    else:
        values = dict(e2e, setup_s=setup_s)
        metrics = {k: values[k] for k in wanted if k in values}
    units = {x["name"]: x["unit"] for x in bench["end_to_end"] + bench["per_layer"]}
    due = readings.in_window()
    check = judge(m["arch"], config, seed, device,
                  _sample(due, seed, spec["check_tokens"], spec["check_requests"]))
    limit = configs.limits(cell["name"])
    checks = {
        "mean_logit_gap": {"value": check["mean_logit_gap"], "limit": limit["mean_logit_gap"]},
        "short_or_failed_requests": {"value": e2e["failed"], "limit": 0},
        "tokens_checked": {"value": check["tokens_checked"], "limit": 1},
    }
    correct = (
        check["mean_logit_gap"] <= limit["mean_logit_gap"] and e2e["failed"] == 0
        and check["tokens_checked"] >= 1 and e2e["attempted"] >= 1
    )
    device_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": name, "count": cell["chips"],
        "memory_peak_bytes": m.get("memory_peak_bytes", 0),
    }
    result = {
        "correct": bool(correct), "attempted": e2e["attempted"], "failed": e2e["failed"],
        "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
        "device": device_info,
    }
    s = m.get("slice")
    if s is not None:
        device_info.update(busy_s=s.busy_s, window_s=s.window_s)
        result["breakdown"] = {"device_ops": s.top_ops(), "idle_gaps": s.idle_gaps()}
    result["checks"] = checks
    diagnostics = dict(
        e2e=e2e, setup_s=setup_s, counters=m["counters"], window_captures=m["captures"],
        late_ms_p95=percentile([(r.submit - r.due) * 1e3 for r in due], 95) if due else None,
        requests_checked=check["requests_checked"], max_logit_gap=check["max_logit_gap"],
        allocated_at_close=m.get("allocated_at_close"),
        **{k: m[k] for k in ("profiler_warmup_s", "profiler_start_s", "profiler_stop_s") if k in m},
        host_peak_rss_gib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20,
    )
    return result, diagnostics
