#!/usr/bin/env python3
"""Drive the PyTorch port (``calfkit_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--out PATH]
    python3 chip_smoke.py --wire-client URL   (phase 16's client process)

Phases, in order; any failed check raises, so the exit code is non-zero and
the final ``ok`` line is never printed:

1. print the card's name and power limit; build the hand-written kernels
   from ``calfkit_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. kernel phase: every kernel against its plain PyTorch version on the card
   at the serving paths' shapes (the prefill kernel on whole prompts, on
   the chunk lane's 512-token chunks at offsets 0, 512 and 1024 of a
   bucket's scratch, and at the draft model's one-token forwards of 16 rows
   over its 2048 window), with its time, the plain version's time,
   one PyTorch library call computing the same function
   (``scaled_dot_product_attention``; for the paged kernel, which no single
   call matches, SDPA on a window gathered beforehand and gather + SDPA) and
   the least time the card could take (bytes over 3.35 TB/s or operations
   over the type's peak rate);
3. exactness phase: the engine at Llama-3-8B widths, f32, 4 layers, greedy:
   dense overlapped and lockstep streams are identical and equal a
   step-by-step greedy recompute through ``model.forward`` with the plain
   attention; then the paged engine (page 64, chunk 128, chunked prefill,
   prefix cache, ragged waves) serves requests sharing a 256-token prefix in
   two bursts, the second reusing the first's pages, and its streams equal
   the dense lockstep engine's and the recompute;
4. serving phase: the full ``llama-3-8b`` preset in bf16 with random weights
   from a seed, dense KV: 6 concurrent requests through the dense decode and
   prefill kernels (launch counts reset just before and read just after),
   then the same 6 with a stop token on one; prints TTFT and decode tokens/s;
5. paged serving phase: the same model, paged KV with the prefix cache and
   chunked ragged admission, agent-shaped traffic: 4 requests of one shared
   1024-token instruction prefix, then, while those decode, 4 more of it and
   2 unrelated prompts; the paged decode and prefill kernels run (counts
   reset just before, read just after), the second burst reuses the prefix
   pages, and after ``stop()`` every page is free or cached; it prints the
   prefill kernel's launches tallied by (B, Sq, Skv) and the paged decode
   kernel's by (B, wpages);
6. speculative serving phases, the same model: the paged phase again with
   ``SpecConfig(k=4)`` and the target's own weights as the draft model
   (every verify through the paged ragged kernel, no decode kernel), then
   dense KV with the n-gram drafter, the serving phase's 6 requests (every
   verify through the dense ragged kernel); each prints TTFT, tokens/s, the
   acceptance rate, tokens per verify dispatch and the ragged launches
   tallied by shape (B, S, window);
7. client phase: the paged serving phase's model and runtime built through
   ``TorchLocalModelClient``, 8 agent conversations of two turns rendered
   by the port's ``render_messages`` (a shared 1,000-byte instruction block,
   3 tools, a unique user message; turn 2 re-sends the history, the answer
   and a tool return) and tokenized by a tokenizer whose every id decodes
   to a character, 32 new tokens a request; it checks usage, streamed
   text, turn 2's prefix reuse, the snapshots' key sets, readiness, the
   window's tokens, an abandoned stream's slot, the paged decode and
   prefill launches and the no-leak law, and prints TTFT (to the first
   ``TextDelta``) per turn, tokens/s, the client's own host work a request
   and the kernels' launches by shape beside the card;
8. the paged decode kernel and each ragged kernel against its plain
   version again, at the shape its serving phase launched most, with the kv
   lengths of that shape's last launch and q in bf16, as serving passes it:
   the case the ``kernels`` line reports; then the prefill and paged
   decode kernels at the shapes the client phase launched most;
9. quantized exactness phase: the exactness phase's model with int8 and
   then int4 weights (dequantized to bf16 at each use, as the JAX package
   does), dense KV quantized by the engine at construction and paged KV
   with the prefix cache; every greedy stream equals the recompute through
   ``model.forward`` with the plain attention on the same quantized tree;
10. checkpoint phase: an HF-layout BF16 checkpoint at Llama-3-8B widths
   and 2 layers, two shards and an index (~3 GB), written by the script's
   own safetensors writer into a temporary directory;
   ``TorchLocalModelClient(checkpoint=...)`` serves 4 agent turns on the
   paged runtime with every loaded bf16 leaf bit for bit the written
   tensor (transposed); ``load_params(quantize="int8")`` equals
   ``quantize_array_host`` of the same arrays and the card's peak
   allocation over that load stays within the int8 tree's bytes (the bf16
   embedding and norms among them) plus 5% (no full-precision copy on the
   card); prints the write, load and first-turn seconds and the turns'
   launches by shape;
11. north-star drives: ``bench.py``'s ``llama8b`` shape (the full
   llama-3-8b preset at ``max_seq_len`` 1024, 32 rows, 32 steps a
   dispatch, paged KV of 193 pages of 64, chunked prefill of 128) with int8
   weights from ``random_quantized_params_host``, then bf16 (random init),
   each one wave of 32 requests of 64 prompt tokens and 128 new tokens,
   then int4 and bf16 again with one wave of 8 each (so int4 is compared
   with bf16 at the same load); prints TTFT median and max, decode
   tokens/s and the mean decode dispatch, the weights' bytes and the peak
   allocation and the launches by shape, and holds the no-leak law;
12. the prefill and paged decode kernels against their plain versions
   again, at the shapes the checkpoint phase and the int8 north-star drive
   launched most (the north star's on a pool of its runtime's 193 pages);
13. overload phase: the robustness layer and its telemetry at llama-3-8b's
   full width (the last bf16 north-star drive's weights), paged (page 64,
   chunk 512, prefix cache, 16 rows) on a pool of 257 pages, half of what
   16 rows of 2048 tokens need, with ``max_pending`` 16, ``max_out_blocks``
   2, a 30 s watchdog, the occupancy sampler and a virtual wall clock: 48
   agent requests at once (a 1,000-token instruction block shared by six,
   a unique tail, 32 new tokens; every third batch-class; deadlines, a
   lease that stops beating, a live lease and a consumer that stops
   reading among them), then a dispatch held past the watchdog's threshold.
   Overlapped, then lockstep; it holds one typed ending or a full stream a
   request, batch shed before interactive, the counters equal to the
   endings and to their journal events, the ``/metrics`` dispatch count,
   evictions, the pool's accounting at every occupancy sample and after
   ``stop()``, the same endings in both runs and the survivors' streams
   equal; then the prefill kernel and the paged decode kernel (over the
   phase's own pool after eviction, through its last block tables) against
   their plain versions at the phase's most launched shapes;
14. the long-context lane (``RuntimeConfig(long_context=True)``, sp = 1):
   (a) a 5,000- and a 1,500-token prompt, 32 new tokens, on the f32
   exactness model at ``max_seq_len`` 1024, through the monolithic and the
   chunked long prefill, overlapped and lockstep: every stream equals the
   short lane of a roomier engine (``max_seq_len`` 8192) and the
   step-by-step recompute, and the lane lands the JAX engine's count of
   dispatches; (b) the full llama-3-8b preset in bf16 (the last bf16
   north-star drive's weights) on the north star's runtime with the lane
   on: 8 short requests decode when the two long prompts (64 new tokens
   each) arrive, chunked (the lane's main path: #1 and #5 counted and
   tallied by shape) and monolithic; the long streams equal a plain
   recompute up to a bf16 tie, no dispatch runs outside a graph, and after
   ``stop()`` every slot and page is free; it prints each long request's
   TTFT and prefill seconds, the lane's decode tok/s and mean dispatch, the
   short streams' largest inter-token gap while a long prefill is in
   flight, the lane's graphs, the scratch's bytes and the peak allocation;
   (c) the chunked drive lockstep under ``graphs.eager()`` and on graphs:
   streams bit for bit, peak at most 1.25 x eager's; (d) an agent turn
   longer than ``max_seq_len`` through ``TorchLocalModelClient``, served
   by the lane; (e) #5 on a whole 8,192-position prompt (5,000 valid) as
   the ring passes its K/V and on a 128-token chunk at offset 4,992 of
   the 8,192 scratch, and #1 at B = 1 over W = 8,192 (5,000 valid),
   against their plain versions, SDPA and the bound; the ``kernels`` line
   reports them under ``long_lane`` beside the lane's launches;
15. the agent mesh (``agent_mesh_phase``): ``Worker([Agent, 3 tools])`` on
   the port's ``InMemoryMesh``, the agent's model a scripted first step
   (``FunctionModelClient``: a ``get_weather`` call) and then
   ``TorchLocalModelClient`` serving the full llama-3-8b preset in bf16
   (the last bf16 north-star drive's weights) on the client phase's paged
   runtime at ``max_seq_len`` 4096, ``stream_tokens=True``; the three ``@agent_tool`` functions'
   derived schemas must equal ``MESH_TOOLS`` (``AGENT_TOOLS`` with the
   keys a derived schema adds); 8 conversations x 2 turns
   through ``Client.execute`` after two warm-up rounds, the client's ids
   seeded (the same dispatch lanes every run), launch counts reset just
   before the measured round and read just after; every run ends with a
   result, turn 2 reuses more prefix tokens than turn 1, every token of
   each engine turn and of a direct ``request`` on the same messages lies
   within ``TIE_SPACINGS`` bf16 spacings of the f32 plain forward's top
   logit, the two parting only at such a tie (phase 13's law), #5 and #2 launch, and
   after ``stop()`` every page is free or cached; it prints TTFT through
   the mesh and the engine's own per turn, the mesh's added ms (apart for
   conversations alone on their lane), the lanes' wait share, tok/s and
   the records published by topic; then its fallback step
   (``fallback_step``) on the same warm engine: a ``FallbackModelClient``
   with an ``OpenAIModelClient`` on a loopback HTTP server inside this
   script (127.0.0.1, nothing leaves the machine) serves two turns through
   ``Client.execute``: (a) remote first, the loopback answering 503, the
   card serving the turn (one loopback request, #5 and #2 launched, the
   turn's tokens and a direct request's under phase 13's law), (b) local
   first with a prompt longer than ``max_seq_len``, which the engine
   refuses and the loopback's scripted stream answers (the text is the
   script, no page taken); no new graph key; then #5
   and #2 against their plain versions at the phase's most launched
   shapes; the ``kernels`` line reports its launches under
   ``agent_mesh``;
16. the wire transports (``wire_mesh_phase``): the brokers and the CRC
   library are built from ``native/``'s sources with its Makefile's flags
   into ``calfkit_tpu_torch/_build/native/`` beside the kernels (phase 1
   prints the compilers and the seconds) and ``$CALFKIT_MESHD``,
   ``$CALFKIT_KAFKAD`` and ``$CALFKIT_CRC32C`` point at them; then phase
   15's agent and engine (the same weights) serve behind
   ``Worker(provisioning=ProvisioningConfig())`` on the port's
   ``KafkaWireMesh`` against ``kafkad`` on port 0, and again on its
   ``TcpMesh`` against ``meshd``, while the ``Client`` runs in a child
   process (``chip_smoke.py --wire-client URL``, no CUDA context): two
   warm-up rounds, then the measured round of 8 conversations x 2 turns.
   Checks: the wire client's CRC is the native library's in both
   processes; the topics provisioned equal ``topics_for_nodes`` ∪
   ``framework_topics_for_nodes``; phase 15's checks (results, prefix
   reuse, the tie law on the 16 engine turns and their direct requests,
   #5 and #2 launched, no leak); a second worker's boot on the same broker
   boots on the topics as they are (over ``kafka://`` the broker answers
   TOPIC_ALREADY_EXISTS for each, which the wire mesh takes without
   raising, so the provisioner's classifier is not reached).  It prints per
   turn the TTFT through the mesh and the engine's own, the added ms and
   its excess over phase 15's, apart for conversations alone on their
   lane, the lanes' wait share, tok/s, the records by topic, the worker's
   boot seconds and its subscriptions' seconds to the first assignment;
   then #5 and #2 against their plain versions at the ``kafka://`` run's
   most launched shapes; the ``kernels`` line reports both transports'
   launches under ``wire_mesh``;
17. the serving fleet (``fleet_phase``): two replicas of phase 15's agent
   (``r0``, ``r1``), each on a fresh engine with its own pool and graph
   pool over ONE set of phase 15's weights, under the port's
   ``FleetTopology`` on one ``InMemoryMesh`` (the tools on a third
   ``Worker``), the ``Client`` on ``FleetRouter(mesh, "prefix-affinity")``
   and ``FailoverPolicy``; three drives: the routed round (two warm-up
   rounds, then phase 15's measured round: every call on its prompt's
   ``PrefixAffinity`` home, both replicas used, no failover, the tie law
   on its 16 engine turns and their direct requests, #5 and #2 launched
   on both engines, their per-engine launches adding up to the round's);
   a kill mid-stream (a long greedy ``Agent.stream`` killed on its replica
   after its first token steps: one contiguous stream, equal to an
   unkilled run's up to the tie law, one failover, the survivor decoding
   only the remaining tokens after prefilling the delivered prefix); a
   drain handoff (the drained replica admits no new call, its in-flight
   runs finish).  Checks also one copy of the weights (both engines'
   tensors are the caller's; the peak allocation is bounded) and no leak
   on either engine after ``stop()``.  It prints per replica its
   placements, prefix reuse, captures and launches, TTFT through the
   fleet against phase 15's, tok/s, the seconds from the kill to the
   first resumed token and the resumed offset; then #5 and #2 against
   their plain versions at the phase's most launched shapes; the
   ``kernels`` line reports its launches, and each replica's, under
   ``fleet``;
18. a typed agent (``typed_agent_phase``): ``Worker([Agent("trip_planner",
   output_type=TripPlan), book, MCPToolboxNode, consumer])`` on an
   ``InMemoryMesh``, phase 15's runtime and weights; ``TripPlan`` is a
   dataclass nesting ``Leg`` dataclasses with a ``Literal``, an ``Enum``,
   an ``int | None`` and a ``tuple[str, ...]``; ``book`` takes a nested
   ``Leg`` and a tuple; the toolbox node serves a stdio MCP server the
   phase writes (one ``distance`` tool); a ``MetricsServer(port=0)`` serves
   the process registry, its readiness probe on the worker and the
   engine.  Each conversation's first step is scripted (an MCP call and a
   ``book`` call), attempts 1 and 2 at the typed answer are the engine's
   turns (their text is no JSON, so the turn runner retries), attempt 3 is
   scripted: a valid ``final_result`` built from attempt 2's text for the
   even conversations, an invalid one (``nights: "many"``) for the odd.
   Two warm-up rounds, then the measured round of 8.  Checks: the typed
   outputs; the odd conversations' ``mesh.validation_error`` reports after
   3 attempts; the consumer's records; the retry boundary between the
   attempts' token steps; attempt 2's prefix reuse of its attempt 1's
   pages; the ``/metrics`` scrape against ``EngineStats``; ``/readyz`` 200
   while serving and 503 after ``stop()``; the tie law on the 16 engine
   turns and their direct requests; #5 and #2 launched; no leak.  It
   prints the engine's TTFT of attempts 1 and 2, the MCP call's round
   trip, the scrape's ms and the round's wall; then #5 and #2 against
   their plain versions at the phase's most launched shapes; the
   ``kernels`` line reports its launches under ``typed_agent``.
19. tensor parallelism (``tp_phase``): llama-3-8b bf16 at
   ``RuntimeConfig(tp=2)`` (phase 15's runtime without the ragged lane) in
   two processes on the one card, joined over gloo by
   ``initialize_multihost`` on a ``file://`` store in a temporary
   directory: rank 1 (a spawned process) runs ``serve_worker`` on its
   shard of the seed's model, rank 0 serves phase 15's agent round (8
   conversations x 2 turns) through ``TorchLocalModelClient`` under
   ``graphs.eager()``; it holds the tie law on every engine turn and its
   direct request against the f32 plain forward of the whole model, #5
   and #2 launched on both ranks (equal counts), each rank's #5 and #2
   against their plain versions at its own heads (H = 16, K = 4), no leak,
   rank 1's exit; it prints tok/s beside phase 15's, the descriptor's host
   ms, the ms of a gloo collective, each rank's peak and launches; the
   ``kernels`` line reports each rank's launches under ``tp2``.  The NCCL
   drive on CUDA graphs needs two cards: with one, a line says it did not
   run.

The kernel phase also holds the ragged multi-query kernels (speculative
verify shapes S = 5, a mixed-row case with prefill-kind and fresh rows, page
16, f32) against their plain versions, and times the fixed cases the
split-window decode and ragged kernels are judged on from tree to tree: the
dense spec phase's path shape (B=8, S=5, W=2048 at ``PATH_LENS``) and a lone
agent turn (B=1, len 2000 of a 2048 window), each with f32 q and with q in
bf16 as serving passes it.  The decode kernels and the paged ragged kernel
are also held at their serving shapes with bf16 q (the ``kernels`` line
reports the dense decode kernel there), and the paged kernels at their
serving paths' shapes (``PAGED_PATH_LENS``, ``SPEC_PAGED_PATH_LENS``: fixed
copies of a run's, so two trees are timed on the same inputs) and at
skewed batches (``WALK_LENS``), which their walk balances by length.  The
exactness phase serves the
dense and the paged+prefix configurations again with speculation on (draft
model = target), whose streams must equal the spec-off streams.

Every dispatch of every engine runs through the compiled-dispatch layer
(``inference/graphs.py``): each drive prints its CUDA graph captures,
replays and capture seconds and its peak allocation, and fails if a
dispatch ran outside a graph; the launch tallies count replays
(:func:`install_tallies`).  Between phases 11 and 12, the graph phase
serves the lockstep dense, paged, speculative paged and bf16 north-star
drives under ``graphs.eager()`` and on graphs, one fresh engine each on one
set of weights: the streams must be equal bit for bit, and graph serving's
peak allocation at most 1.25 x eager's at the paged and north-star drives.
The speculative drive's draft model proposes through one graph a catch-up
width (the engine's pool): none captured under ``eager()``, every width on
graphs, every proposal equal between the two runs; its streams equal the
paged drive's (spec-on == spec-off) or leave them only at a bf16 tie
(phase 13's law).

The line before the last is ``nvidia-smi``'s name and power limit; the
``kernels`` JSON line precedes it; the last line is the ``ok`` JSON object.
``--out`` also writes every measurement as JSON.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import dataclasses
import enum
import gc
import json
import math
import os
import random
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import uuid
import weakref
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace
from typing import Literal

import numpy as np
import torch
import torch.nn.functional as F

from calfkit_tpu_torch import Agent, Client, Worker, kernels, protocol
from calfkit_tpu_torch.client import InvocationResult, caller
from calfkit_tpu_torch.engine import (
    FunctionModelClient,
    ModelClient,
    ModelRequestParameters,
    ModelSettings,
    ResponseDone,
    TextDelta,
)
from calfkit_tpu_torch.fleet import (
    FailoverPolicy,
    FleetRouter,
    PrefixAffinity,
    RouteRequest,
    affinity_key_for,
)
from calfkit_tpu_torch.fleet.selection import lane_of
from calfkit_tpu_torch.inference import attention as A
from calfkit_tpu_torch.inference import graphs
from calfkit_tpu_torch.inference import model as M
from calfkit_tpu_torch.inference import quant as Q
from calfkit_tpu_torch.inference.client import TorchLocalModelClient, render_messages
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig, preset
from calfkit_tpu_torch.inference.engine import EngineStats, InferenceEngine, _call_weak
from calfkit_tpu_torch.inference.loader import config_from_hf, load_params
from calfkit_tpu_torch.inference.sampler import SamplingParams
from calfkit_tpu_torch.inference.tokenizer import ByteTokenizer
from calfkit_tpu_torch.exceptions import InferenceError, NodeFaultError
from calfkit_tpu_torch.keying import partition_key
from calfkit_tpu_torch.mcp import MCPServerSpec, MCPToolboxNode, Toolbox, mixed_tools
from calfkit_tpu_torch.mesh import InMemoryMesh, _native
from calfkit_tpu_torch.models import (
    DataPart,
    ModelRequest,
    ModelResponse,
    ReturnMessage,
    ToolCallOutput,
    ToolDef,
    ToolReturnPart,
    UserPart,
    user_message,
)
from calfkit_tpu_torch.models._adapter import Adapter
from calfkit_tpu_torch.nodes import agent_tool, consumer
from calfkit_tpu_torch.nodes.agent import _TokenTap
from calfkit_tpu_torch.observability import flightrec
from calfkit_tpu_torch.observability.http import MetricsServer
from calfkit_tpu_torch.observability.metrics import REGISTRY
from calfkit_tpu_torch.observability.trace import current_context
from calfkit_tpu_torch.providers import FallbackModelClient, ModelAPIError, OpenAIModelClient
from calfkit_tpu_torch.sim import FleetTopology, settle

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # tensor-core bf16; f32 CUDA cores
SOURCES = {
    "decode_attention": (
        "calfkit_tpu_torch/csrc/decode_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:60",
    ),
    "paged_decode_attention": (
        "calfkit_tpu_torch/csrc/decode_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:153",
    ),
    "prefill_attention": (
        "calfkit_tpu_torch/csrc/prefill_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:687",
    ),
    "ragged_attention": (
        "calfkit_tpu_torch/csrc/ragged_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:357",
    ),
    "ragged_attention_paged": (
        "calfkit_tpu_torch/csrc/ragged_attention.cu",
        "calfkit_tpu/inference/pallas_attention.py:467",
    ),
}
# kernel vs plain version: both accumulate in f32 from the same inputs; the
# tolerances cover the sum order over up to 2048 positions, and for a bf16
# prefill the kernel's bf16 rounding of the probabilities it feeds the
# tensor cores (2**-9 relative each) plus one bf16 rounding of the output
# (2**-8 relative)
DECODE_TOL = dict(atol=1e-4, rtol=1e-4)
PREFILL_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of one call, after two warm-up calls: CUDA events
    around each of ``iters`` calls, with the L2 cache flushed before each,
    as the serving path finds it after the other layers' reads.  Host-side
    launch cost is not included."""
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > 50 MB of L2
    for _ in range(2):
        fn()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    torch.cuda.synchronize()
    # hold the card while the host enqueues every call, so no host-side
    # launch cost falls between a pair of events
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def _nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _sdpa_ms(q, k, v, mask=None, causal=False) -> float:
    return time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal, enable_gqa=True
    ))


# --------------------------------------------------------------------------- #
# kernel phase
# --------------------------------------------------------------------------- #


def decode_case(dev, dtype, B, K, G, hd, W, lens, seed, q_dtype=torch.float32):
    """The dense decode kernel on a [:, :, :W] view of a longer cache, q in
    ``q_dtype`` (f32 unless noted in the shape; serving passes the model's
    dtype)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=dev).to(q_dtype)
    # the engine passes a [:, :, :W] view of a longer cache: so does this
    cache = torch.randn((2, B, K, 2 * W, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]
    base = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = A.decode_attention(q, k, v, base)
    ref = A.decode_attention_reference(q, k, v, base)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    valid = sum(min(n, W) for n in lens)
    nbytes = 2 * valid * K * hd * cache.element_size() + _nbytes(q, base, *out)
    ops = 4 * hd * G * K * valid
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    mask = (torch.arange(W, device=dev)[None, :] < base[:, None])[:, None, None, :]
    qs = q.reshape(B, 1, K * G, hd).transpose(1, 2).to(dtype)
    shape = dict(B=B, K=K, G=G, hd=hd, W=W, dtype=str(dtype))
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    if B == 1:
        shape["lens"] = list(lens)
    return dict(
        name="decode_attention", shape=shape,
        max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(lambda: A.decode_attention(q, k, v, base)),
        plain_ms=time_ms(lambda: A.decode_attention_reference(q, k, v, base), iters=5),
        library_ms=_sdpa_ms(qs, k, v, mask=mask),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def _shuffled_pool(dev, dtype, g, K, hd, page, lens, wpages, seed, n_pages=None):
    """A 2-layer pool of random values whose rows' pages are shuffled,
    non-contiguous ids (the trash page past each row's pages) → (pool_k,
    pool_v, tables [B, wpages], n_pages).  The pool holds one window a row
    and the trash page, or ``n_pages`` (a serving runtime's pool) with the
    rows' pages drawn from it one after another."""
    B = len(lens)
    need = [-(-n // page) for n in lens]
    if n_pages is None:
        n_pages, first = 1 + B * wpages, [b * wpages for b in range(B)]
    else:
        first = np.cumsum([0, *need[:-1]]).tolist()
        assert sum(need) < n_pages, (need, n_pages)
    pool_k = torch.randn((2, n_pages, K, page, hd), generator=g, device=dev).to(dtype)
    pool_v = torch.randn((2, n_pages, K, page, hd), generator=g, device=dev).to(dtype)
    ids = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    tables = np.zeros((B, wpages), np.int32)
    for b in range(B):
        tables[b, :need[b]] = ids[first[b]:first[b] + need[b]]
    return pool_k, pool_v, torch.from_numpy(tables).to(dev), n_pages


def paged_decode_case(dev, dtype, B, K, G, hd, page, lens, wpages, seed, layer=1,
                      q_dtype=torch.float32, rows=None, n_pages=None, pool=None):
    """The paged kernel on a shuffled 2-layer pool (of ``n_pages``, as
    :func:`_shuffled_pool`), or on ``pool`` = (pool_k, pool_v, tables), an
    engine's own pool and block tables, at layer 1; q in ``q_dtype``, as
    :func:`decode_case`; ``rows`` labels the row lengths where they are not
    ``PAGED_LENS``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, G, hd), generator=g, device=dev).to(q_dtype)
    if pool is None:
        pool_k, pool_v, tables, n_pages = _shuffled_pool(
            dev, dtype, g, K, hd, page, lens, wpages, seed, n_pages)
    else:
        pool_k, pool_v, tables = pool
        n_pages = pool_k.shape[1]
    base = torch.tensor(lens, dtype=torch.int32, device=dev)

    def kernel():
        return A.paged_decode_attention(q, pool_k, pool_v, layer, tables, base, wpages=wpages)

    def plain():
        return A.paged_decode_attention_reference(
            q, pool_k, pool_v, layer, tables, base, wpages=wpages
        )

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    W = wpages * page
    valid = sum(min(n, W) for n in lens)
    table_bytes = 4 * sum(-(-min(n, W) // page) for n in lens)
    nbytes = 2 * valid * K * hd * pool_k.element_size() + table_bytes + _nbytes(q, base, *out)
    ops = 4 * hd * G * K * valid
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    mask = (torch.arange(W, device=dev)[None, :] < base[:, None])[:, None, None, :]
    qs = q.reshape(B, 1, K * G, hd).transpose(1, 2).to(dtype)

    def gather():
        return (
            M.gather_window_paged(pool_k[layer], tables, wpages),
            M.gather_window_paged(pool_v[layer], tables, wpages),
        )

    kw, vw = gather()
    shape = dict(B=B, K=K, G=G, hd=hd, page=page, wpages=wpages, pool_pages=n_pages,
                 dtype=str(dtype))
    if rows:
        shape["rows"] = rows
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    return dict(
        name="paged_decode_attention", shape=shape,
        max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        # no single PyTorch call reads K/V through block tables
        library_ms=None,
        sdpa_gathered_ms=_sdpa_ms(qs, kw, vw, mask=mask),  # gather excluded
        gather_sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, *gather(), attn_mask=mask, enable_gqa=True
        )),
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def prefill_case(dev, dtype, R, S, H, K, hd, seed, offset=0, Skv=None, lens=None,
                 seq_major=False):
    """``R`` rows of ``S`` queries at positions ``offset``.. against a cache
    of ``Skv`` positions (default ``S``), ``offset + S`` of them valid: a
    whole prompt from position 0, or a chunk of the chunk lane, whose
    scratch holds the wave's whole bucket.  With ``lens`` (one a row), row
    b's queries end at its len instead (a row of len 0 sees nothing) and
    K/V are a layer of a [2, R, K, Skv, hd] cache: the draft model's
    forwards over its window; with ``seq_major`` too, K/V are the
    [R, K, Skv, hd] views of [R, Skv, K, hd] tensors, as the long lane's
    ring passes a layer's fresh K/V (``ring_attention``)."""
    Skv = S if Skv is None else Skv
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((R, S, H, hd), generator=g, device=dev).to(dtype)
    if lens is None:
        k = torch.randn((R, K, Skv, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((R, K, Skv, hd), generator=g, device=dev).to(dtype)
        pos = (offset + torch.arange(S, dtype=torch.int32, device=dev)).expand(R, S).contiguous()
        lens_t = torch.full((R,), offset + S, dtype=torch.int32, device=dev)
    else:
        if seq_major:
            cache = torch.randn((2, R, Skv, K, hd), generator=g, device=dev).to(dtype)
            k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
        else:
            cache = torch.randn((2, R, K, Skv, hd), generator=g, device=dev).to(dtype)
            k, v = cache[0], cache[1]
        pos = torch.tensor([[max(n, S) - S + j for j in range(S)] for n in lens],
                           dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = A.prefill_attention(q, k, v, pos, lens_t)
    ref = A.prefill_attention_reference(q, k, v, pos, lens_t)
    torch.cuda.synchronize()
    # query (b, s) keeps min(q_pos + 1, len, Skv) positions; row b reads
    # the K/V of the most any of its queries keeps.  A query that keeps none
    # gives 0 (the kernels' law; an earlier tree's plain version gave the
    # mean of v there), so the plain version is held on the others
    seen = torch.minimum(pos + 1, lens_t.clamp(max=Skv)[:, None]).clamp(min=0)
    blind = seen == 0
    assert torch.all(out[blind] == 0), "a query that sees no position must give 0"
    err = float((out[~blind].float() - ref[~blind].float()).abs().max())
    torch.testing.assert_close(out[~blind].float(), ref[~blind].float(), **PREFILL_TOL[dtype])
    ops = 4 * hd * H * int(seen.sum())
    kv_bytes = 2 * K * int(seen.max(dim=1).values.sum()) * hd * k.element_size()
    bytes_ms = (kv_bytes + _nbytes(q, pos, lens_t, out)) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    if lens is None:
        # SDPA over the valid positions; its causal flag aligns the diagonal
        # top-left, so a chunk at an offset takes an explicit mask
        n = offset + S
        mask = None if offset == 0 else (
            torch.arange(n, device=dev)[None, :] <= pos[0, :, None]
        )[None, None]
        library_ms = _sdpa_ms(q.transpose(1, 2), k[:, :, :n], v[:, :, :n], mask=mask,
                              causal=offset == 0)
        shape = dict(R=R, S=S, q_pos0=offset, Skv=Skv, H=H, K=K, hd=hd, dtype=str(dtype))
    else:
        shape = dict(R=R, S=S, lens=list(lens), Skv=Skv, H=H, K=K, hd=hd, dtype=str(dtype))
        if seq_major:
            # the ring's case, q_pos = arange(S): SDPA's causal attention
            # over the valid positions gives every row below its length
            shape["kv"] = "seq-major"
            n = max(lens)
            library_ms = _sdpa_ms(q[:, :n].transpose(1, 2), k[:, :, :n], v[:, :, :n],
                                  causal=True)
        else:
            w = torch.arange(Skv, device=dev)[None, None, :]
            mask = ((w <= pos[:, :, None]) & (w < lens_t[:, None, None]))[:, None]
            library_ms = _sdpa_ms(q.transpose(1, 2), k, v, mask=mask)
    return dict(
        name="prefill_attention", shape=shape, max_abs_err=err, tol=PREFILL_TOL[dtype],
        ms=time_ms(lambda: A.prefill_attention(q, k, v, pos, lens_t), iters=5),
        plain_ms=time_ms(lambda: A.prefill_attention_reference(q, k, v, pos, lens_t), iters=3),
        library_ms=library_ms,
        bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
    )


def _ragged_limits(starts, lens, S, W) -> "list[list[int]]":
    """Each row's visible kv length per query: min(kv_len, start + j + 1),
    within the window."""
    return [[max(0, min(n, st + j + 1, W)) for j in range(S)] for st, n in zip(starts, lens)]


def _ragged_bound(limits, K, G, hd, kv_size, dtype, io_bytes):
    """(bound ms, bound_by): the K/V bytes of the positions some query of a
    row sees, read once, plus ``io_bytes`` (q, the row arrays, the table
    entries read and the outputs, each once); against 4*hd operations per
    (query, head, visible position)."""
    seen = sum(max(row) for row in limits)
    nbytes = 2 * seen * K * hd * kv_size + io_bytes
    ops = 4 * hd * K * G * sum(sum(row) for row in limits)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype] * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def _ragged_sdpa_args(q, limits, W, dtype):
    """q [B, K, S, G, hd] as SDPA's [B, H, S, hd] (head k * G + g) and the
    explicit mask [B, 1, S, W] of the ragged law."""
    B, K, S, G, hd = q.shape
    qs = q.permute(0, 1, 3, 2, 4).reshape(B, K * G, S, hd).to(dtype)
    lim = torch.tensor(limits, dtype=torch.int32, device=q.device)  # [B, S]
    return qs, (torch.arange(W, device=q.device)[None, None, :] < lim[:, :, None])[:, None]


def ragged_case(dev, dtype, B, K, S, G, hd, W, starts, lens, seed, rows=None,
                q_dtype=torch.float32):
    """The dense ragged kernel on a [:, :, :W] view of a longer cache;
    ``rows`` labels the case's row lengths where they are not plain verify
    rows of the kernel plan; q in ``q_dtype``, as :func:`decode_case`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, S, G, hd), generator=g, device=dev).to(q_dtype)
    cache = torch.randn((2, B, K, 2 * W, hd), generator=g, device=dev).to(dtype)
    k, v = cache[0, :, :, :W], cache[1, :, :, :W]
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    out = A.ragged_attention(q, k, v, st, ln)
    ref = A.ragged_attention_reference(q, k, v, st, ln)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    limits = _ragged_limits(starts, lens, S, W)
    bound_ms, bound_by = _ragged_bound(
        limits, K, G, hd, cache.element_size(), dtype, _nbytes(q, st, ln, *out)
    )
    qs, mask = _ragged_sdpa_args(q, limits, W, dtype)
    shape = dict(B=B, K=K, S=S, G=G, hd=hd, W=W, dtype=str(dtype))
    if rows:
        shape["rows"] = rows
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    return dict(
        name="ragged_attention", shape=shape, max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(lambda: A.ragged_attention(q, k, v, st, ln)),
        plain_ms=time_ms(lambda: A.ragged_attention_reference(q, k, v, st, ln), iters=5),
        library_ms=_sdpa_ms(qs, k, v, mask=mask), bound_ms=bound_ms, bound_by=bound_by,
    )


def ragged_paged_case(dev, dtype, B, K, S, G, hd, page, lens, wpages, seed, layer=1, rows=None,
                      q_dtype=torch.float32):
    """The paged ragged kernel at verify rows (start = kv_len) on a shuffled
    2-layer pool, at layer 1; ``rows`` labels the row lengths and q is in
    ``q_dtype``, as :func:`ragged_case`'s."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, K, S, G, hd), generator=g, device=dev).to(q_dtype)
    pool_k, pool_v, tables, n_pages = _shuffled_pool(dev, dtype, g, K, hd, page, lens, wpages, seed)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)

    def kernel():
        return A.ragged_attention_paged(q, pool_k, pool_v, layer, tables, ln, ln, wpages=wpages)

    def plain():
        return A.ragged_attention_paged_reference(
            q, pool_k, pool_v, layer, tables, ln, ln, wpages=wpages
        )

    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, **DECODE_TOL)
    W = wpages * page
    limits = _ragged_limits(lens, lens, S, W)
    table_bytes = 4 * sum(-(-max(row) // page) for row in limits)
    bound_ms, bound_by = _ragged_bound(  # one lens tensor is both starts and kv_lens
        limits, K, G, hd, pool_k.element_size(), dtype, _nbytes(q, ln, *out) + table_bytes
    )
    qs, mask = _ragged_sdpa_args(q, limits, W, dtype)

    def gather():
        return (
            M.gather_window_paged(pool_k[layer], tables, wpages),
            M.gather_window_paged(pool_v[layer], tables, wpages),
        )

    kw, vw = gather()
    shape = dict(B=B, K=K, S=S, G=G, hd=hd, page=page, wpages=wpages, pool_pages=n_pages,
                 dtype=str(dtype))
    if rows:
        shape["rows"] = rows
    if q_dtype != torch.float32:
        shape["q_dtype"] = str(q_dtype)
    return dict(
        name="ragged_attention_paged", shape=shape,
        max_abs_err=err, tol=DECODE_TOL,
        ms=time_ms(kernel), plain_ms=time_ms(plain, iters=5),
        # no single PyTorch call reads K/V through block tables
        library_ms=None,
        sdpa_gathered_ms=_sdpa_ms(qs, kw, vw, mask=mask),  # gather excluded
        gather_sdpa_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qs, *gather(), attn_mask=mask, enable_gqa=True
        )),
        bound_ms=bound_ms, bound_by=bound_by,
    )


# the paged serving shape: B=16 rows, lens 17-2048 and one fresh row
PAGED_LENS = [0, 17, 100, 255, 256, 300, 511, 640, 777, 1024, 1300, 1500, 1600, 1800, 2000,
              2048]
# the dense spec serving phase's most launched ragged shape (B=8, S=5,
# W=2048): the kv lengths of its last launch in one run of the phase
PATH_LENS = [0, 0, 1530, 1130, 725, 509, 155, 48]
# the paged serving phase's most launched paged decode shape (B=16,
# wpages=32) and the spec paged phase's most launched verify shape (B=16,
# S=5, wpages=32): the kv lengths of their last launch in one run of each
PAGED_PATH_LENS = [0, 0, 0, 0, 0, 0, 724, 57, 1452, 1382, 1272, 1192, 1472, 1402, 1322, 1172]
SPEC_PAGED_PATH_LENS = [0, 0, 0, 0, 0, 0, 732, 62, 1446, 1380, 1267, 1190, 1472, 1403, 1322,
                        1174]
# skewed batches of the paged kernels, which the walk balances across
# blocks by their lengths: one long row and fifteen empty ones, every row
# full, a lone agent turn
WALK_LENS = {"one long, 15 empty": [2048] + [0] * 15, "all full": [2048] * 16,
             "one row": [2000]}
# the case of each kernel that the line of ``kernels`` reports: the dense
# decode kernel at the dense serving phase's batch and window, with q in the
# model's dtype, as serving passes it; the prefill kernel at the paged
# serving phase's last chunk of a 1536-token bucket.  The paged decode
# kernel's and the ragged kernels' cases are made after their serving
# phases, at the shape those phases launched most (:func:`path_case`).
MAIN_SHAPES = {
    "decode_attention": dict(B=8, K=8, G=4, hd=128, W=2048, dtype="torch.bfloat16",
                             q_dtype="torch.bfloat16"),
    "prefill_attention": dict(R=4, S=512, q_pos0=1024, Skv=1536, H=32, K=8, hd=128,
                              dtype="torch.bfloat16"),
}


def kernel_plan() -> "list[tuple[str, object, tuple]]":
    """Every kernel-phase case as (kernel name, case function, its
    arguments after the device)."""
    ragged = {256: [0, 1, 31, 64, 100, 200, 255, 256],
              2048: [17, 300, 777, 1024, 1500, 1600, 2000, 2048]}
    plan = []
    for dtype in (torch.bfloat16, torch.float32):
        for W in (256, 2048):
            plan.append(("decode_attention", decode_case, (dtype, 8, 8, 4, 128, W, ragged[W], W)))
    plan.append(("decode_attention", decode_case,
                 (torch.bfloat16, 8, 4, 8, 64, 2048, ragged[2048], 7)))
    # the dense serving shape with q in the model's dtype, as serving passes it
    plan.append(("decode_attention", decode_case,
                 (torch.bfloat16, 8, 8, 4, 128, 2048, ragged[2048], 2048, torch.bfloat16)))
    for dtype, K, G, hd, page, seed in (
        (torch.bfloat16, 8, 4, 128, 64, 11), (torch.bfloat16, 8, 4, 128, 16, 12),
        (torch.float32, 8, 4, 128, 64, 13), (torch.bfloat16, 4, 8, 64, 64, 14),
    ):
        plan.append(("paged_decode_attention", paged_decode_case,
                     (dtype, 16, K, G, hd, page, PAGED_LENS, 2048 // page, seed)))
    # the paged serving shape with q in the model's dtype (pages 64 and 16)
    for page, seed in ((64, 15), (16, 16)):
        plan.append(("paged_decode_attention", paged_decode_case,
                     (torch.bfloat16, 16, 8, 4, 128, page, PAGED_LENS, 2048 // page, seed, 1,
                      torch.bfloat16)))
    for dtype in (torch.bfloat16, torch.float32):
        for R in (1, 4):
            for S in (512, 2048):
                plan.append(("prefill_attention", prefill_case,
                             (dtype, R, S, 32, 8, 128, R * S)))
    plan.append(("prefill_attention", prefill_case, (torch.bfloat16, 4, 2048, 32, 4, 64, 3)))
    # the dense serving phase's largest prefill wave: two prompts in the 1536 bucket
    plan.append(("prefill_attention", prefill_case, (torch.bfloat16, 2, 1536, 32, 8, 128, 5)))
    # the paged serving phase's chunks of 512: a wave of 4 in the 1536
    # bucket at each offset, and one row in the 1024 bucket at offset 512
    for R, offset, Skv in ((4, 0, 1536), (4, 512, 1536), (4, 1024, 1536), (1, 512, 1024)):
        plan.append(("prefill_attention", prefill_case,
                     (torch.bfloat16, R, 512, 32, 8, 128, 20 + offset, offset, Skv)))
    # the draft model's most launched forward in the spec paged phase: one
    # token a row for the 16 rows over its 2048-position window
    plan.append(("prefill_attention", prefill_case,
                 (torch.bfloat16, 16, 1, 32, 8, 128, 6, 0, 2048, PAGED_LENS)))
    # a lone agent turn: one row of 2000 positions in a 2048 window, f32 q
    # and q in the model's dtype
    for q_dtype in (torch.float32, torch.bfloat16):
        plan.append(("decode_attention", decode_case,
                     (torch.bfloat16, 1, 8, 4, 128, 2048, [2000], 8, q_dtype)))
    # verify rows (start = kv_len) at k = 4 with every draft kept: S = 5
    plan.append(("ragged_attention", ragged_case,
                 (torch.bfloat16, 8, 8, 5, 4, 128, 2048, ragged[2048], ragged[2048], 30)))
    # the dense n-gram spec phase's most launched shape, at the kv lengths
    # of its last launch in one run (PATH_LENS); and the lone agent turn's verify
    for q_dtype in (torch.float32, torch.bfloat16):
        plan.append(("ragged_attention", ragged_case,
                     (torch.bfloat16, 8, 8, 5, 4, 128, 2048, PATH_LENS, PATH_LENS, 37,
                      "spec dense path", q_dtype)))
        plan.append(("ragged_attention", ragged_case,
                     (torch.bfloat16, 1, 8, 5, 4, 128, 2048, [2000], [2000], 38, "one row",
                      q_dtype)))
    # mixed rows: verify, prefill-kind (start < kv_len), fresh, prefill-kind
    # ending at the window; S*G = 64 query rows, two query tiles
    plan.append(("ragged_attention", ragged_case,
                 (torch.bfloat16, 4, 8, 16, 4, 128, 2048, [1000, 300, 0, 2032],
                  [1000, 316, 0, 2048], 31, "mixed")))
    for dtype, page, seed in ((torch.bfloat16, 64, 32), (torch.bfloat16, 16, 33),
                              (torch.float32, 64, 34)):
        plan.append(("ragged_attention_paged", ragged_paged_case,
                     (dtype, 16, 8, 5, 4, 128, page, PAGED_LENS, 2048 // page, seed)))
    # q in the model's dtype, as the spec serving phases pass it
    for page, seed in ((64, 39), (16, 40)):
        plan.append(("ragged_attention_paged", ragged_paged_case,
                     (torch.bfloat16, 16, 8, 5, 4, 128, page, PAGED_LENS, 2048 // page, seed, 1,
                      None, torch.bfloat16)))
    # the paged kernels at their serving paths' shapes and at skewed
    # batches, q in the model's dtype
    plan.append(("paged_decode_attention", paged_decode_case,
                 (torch.bfloat16, 16, 8, 4, 128, 64, PAGED_PATH_LENS, 32, 42, 1, torch.bfloat16,
                  "paged path")))
    plan.append(("ragged_attention_paged", ragged_paged_case,
                 (torch.bfloat16, 16, 8, 5, 4, 128, 64, SPEC_PAGED_PATH_LENS, 32, 43, 1,
                  "spec paged path", torch.bfloat16)))
    for i, (label, lens) in enumerate(WALK_LENS.items()):
        plan.append(("paged_decode_attention", paged_decode_case,
                     (torch.bfloat16, len(lens), 8, 4, 128, 64, lens, 32, 50 + i, 1,
                      torch.bfloat16, label)))
        plan.append(("ragged_attention_paged", ragged_paged_case,
                     (torch.bfloat16, len(lens), 8, 5, 4, 128, 64, lens, 32, 60 + i, 1, label,
                      torch.bfloat16)))
    return plan


def run_cases(dev, plan) -> "list[dict]":
    """Run and print each case of ``plan`` (as :func:`kernel_plan` gives)."""
    cases = []
    for _, case_fn, args in plan:
        c = case_fn(dev, *args)
        sdpa = (
            f"sdpa_ms {c['library_ms']:.4f}" if c["library_ms"] is not None else
            f"sdpa_gathered_ms {c['sdpa_gathered_ms']:.4f} "
            f"gather_sdpa_ms {c['gather_sdpa_ms']:.4f}"
        )
        print(
            f"  {c['name']} {c['shape']}: max_abs_err {c['max_abs_err']:.3e} "
            f"(tol {c['tol']}) ms {c['ms']:.4f} plain_ms {c['plain_ms']:.4f} "
            f"{sdpa} bound_ms {c['bound_ms']:.4f} ({c['bound_by']})"
        )
        cases.append(c)
    return cases


def kernel_phase(dev) -> "tuple[list[dict], dict]":
    """→ (every measured case, the case of each kernel at its
    ``MAIN_SHAPES`` shape)."""
    cases = run_cases(dev, kernel_plan())
    main = {
        name: next(c for c in cases if c["name"] == name and c["shape"] == shape)
        for name, shape in MAIN_SHAPES.items()
    }
    return cases, main


# the wrappers whose calls the phases tally, each by its shape key
# (S: queries a row; the window: W or Skv positions, or wpages)
TALLY_KEYS = {
    "ragged_attention": lambda q, args, kw: (q.shape[0], q.shape[2], args[0].shape[2]),
    "ragged_attention_paged": lambda q, args, kw: (q.shape[0], q.shape[2], kw["wpages"]),
    "paged_decode_attention": lambda q, args, kw: (q.shape[0], 1, kw["wpages"]),
    "prefill_attention": lambda q, args, kw: (q.shape[0], q.shape[1], args[0].shape[2]),
}
_OPEN_TALLIES: dict = {}  # wrapper name → the open tally {key: [calls, kv_lens]}
_TALLY_LOCK = threading.Lock()


def observe_call(tag, tensors: "list[torch.Tensor]", record, wanted=lambda: True) -> None:
    """Pass copies of ``tensors`` (a wrapper's device arguments) to
    ``record(n, copies)`` as a wrapper call is counted: at once for a call
    that launches (eager); for a call inside a CUDA graph capture, at each
    replay of that graph, with n its calls of ``tag`` (the copies made by
    the graph at the tag's first call, cloned right after the replay).
    ``wanted()`` is asked first, so an observer with nothing open costs a
    replay nothing."""
    def make():
        inside = [t.clone() for t in tensors]  # graph nodes: refreshed by every replay

        def hook(n):
            if wanted():
                record(n, [t.clone() for t in inside])
        return hook

    if not graphs.on_replay(tag, make) and wanted():
        record(1, [t.clone() for t in tensors])


def install_tallies() -> None:
    """Wrap the tallied wrappers of ``A`` once, before any engine captures
    a graph: every call, and every replay of a graph that captured calls,
    counts in the open tally of its wrapper (:func:`_tally`), whenever the
    graph was captured.  The wrappers' callers look them up at every call;
    the wrappers and their launch counts are unchanged."""
    for name, key in TALLY_KEYS.items():
        inner = getattr(A, name)
        if getattr(inner, "tallied", False):
            continue

        def tallied(q, *args, _name=name, _key=key, _inner=inner, **kw):
            k = _key(q, args, kw)

            def record(n, copies, _k=k):
                with _TALLY_LOCK:  # two engines' worker threads may record at once
                    entry = _OPEN_TALLIES[_name].setdefault(_k, [0, None])
                    entry[0] += n
                    entry[1] = copies[0]  # kv_lens, on the device: no sync

            observe_call((_name, k), [args[-1]], record, lambda: _name in _OPEN_TALLIES)
            return _inner(q, *args, **kw)

        tallied.tallied = True
        setattr(A, name, tallied)


@contextlib.contextmanager
def _tally(name: str):
    """While the block runs, tally the launches of the wrapper ``A.name``
    (eager calls and graph replays alike) by its ``TALLY_KEYS`` key and
    keep a copy of the kv lengths (its last argument) of the last launch
    at each → {key: [launches, kv_lens]}."""
    install_tallies()
    tally: dict = {}
    _OPEN_TALLIES[name] = tally
    try:
        yield tally
    finally:
        _OPEN_TALLIES.pop(name, None)


def verify_shapes(name: str):
    """Tally the ragged wrapper ``A.name``'s launches by (B, S, window: W
    positions dense, wpages paged), as :func:`_tally` does."""
    return _tally(name)


def decode_shapes():
    """Tally the paged decode wrapper's launches by (B, 1, wpages), as
    :func:`_tally` does."""
    return _tally("paged_decode_attention")


def prefill_shapes():
    """Tally the prefill wrapper's launches by (B, Sq, Skv), as
    :func:`_tally` does."""
    return _tally("prefill_attention")


def graph_numbers(engine) -> dict:
    """The engine's compiled-dispatch counts so far: captures, replays,
    eager calls, capture seconds, its graph keys and the calls through
    them; fails if a dispatch ran outside a graph while :func:`eager` is
    off (every call is a capture or a replay)."""
    out = dict(engine._graphs.stats)
    # a draft model's proposer captures into the engine's pool (its counts
    # are in the stats above) and is reported apart as well
    proposer = getattr(engine._drafter, "_graphs", {})
    tables = (engine._decode_graphs, engine._prefill_graphs, engine._long_graphs, proposer)
    out["calls"] = sum(fn.calls for table in tables for fn in table.values())
    out["keys"] = sum(map(len, tables))
    if proposer:
        calls = sum(fn.calls for fn in proposer.values())
        captures = sum(fn.captured for fn in proposer.values())
        eager = graphs.eager_active()
        on_card = engine.device.type == "cuda"  # (the CPU runs every body eagerly)
        out["draft"] = dict(keys=sorted(proposer), calls=calls, captures=captures,
                            replays=calls - captures if on_card and not eager else 0,
                            eager=calls if on_card and eager else 0)
    if engine.device.type == "cuda" and not graphs.eager_active():
        assert out["eager"] == 0 and out["calls"] == out["captures"] + out["replays"], out
    return out


def graph_note(numbers: dict, peak: int) -> str:
    draft = numbers.get("draft")
    return (f"graphs: {numbers['captures']} captures ({numbers['capture_s']:.2f} s) + "
            f"{numbers['replays']} replays = {numbers['calls']} dispatches over "
            f"{numbers['keys']} keys, {numbers['eager']} eager"
            + (f" (the draft model's proposer: {draft['captures']} captures + "
               f"{draft['replays']} replays, {draft['eager']} eager, widths {draft['keys']})"
               if draft else "")
            + f"; max allocated {peak / 1e9:.3f} GB")


def _shape_rows(tally) -> "list[dict]":
    """A :func:`_tally` tally as JSON rows, most calls first (S: queries a
    row; window: W or Skv positions, or wpages)."""
    rows = [dict(B=B, S=S, window=w, launches=n, last_kv_lens=lens.tolist())
            for (B, S, w), (n, lens) in tally.items()]
    return sorted(rows, key=lambda r: (-r["launches"], -r["S"]))


def path_case(dev, name: str, shapes: "list[dict]", where: str = "",
              n_pages: "int | None" = None) -> dict:
    """A kernel ``name`` against its plain version at the shape its serving
    phase (``where``: the phase's name where it is not the kernel's own
    serving phase) launched most (``shapes`` as :func:`_shape_rows` gives),
    with the kv lengths of that shape's last launch: the 8B model's K=8,
    G=4, hd=128, bf16 cache and q (for the ragged kernels verify rows, start
    = kv_len; for prefill each row's queries end at its kv length; for
    paged decode a pool of ``n_pages``, as :func:`_shuffled_pool`)."""
    top = shapes[0]
    bf16 = torch.bfloat16
    lens = top["last_kv_lens"]
    if name == "prefill_attention":
        return run_cases(dev, [(name, prefill_case, (bf16, top["B"], top["S"], 32, 8, 128, 44,
                                                     0, top["window"], lens))])[0]
    if name == "paged_decode_attention":
        label = f"{where or 'paged serving'}, {top['launches']} launches"
        args = (bf16, top["B"], 8, 4, 128, PAGED_RUNTIME.page_size, lens, top["window"], 41, 1,
                bf16, label, n_pages)
        return run_cases(dev, [(name, paged_decode_case, args)])[0]
    label = f"spec serving, {top['launches']} launches"
    if name == "ragged_attention":
        args = (bf16, top["B"], 8, top["S"], 4, 128, top["window"], lens, lens, 35, label, bf16)
        return run_cases(dev, [(name, ragged_case, args)])[0]
    args = (bf16, top["B"], 8, top["S"], 4, 128, PAGED_RUNTIME.page_size, lens,
            top["window"], 36, 1, label, bf16)
    return run_cases(dev, [(name, ragged_paged_case, args)])[0]


# --------------------------------------------------------------------------- #
# engine phases
# --------------------------------------------------------------------------- #


async def _stream(engine, prompt, n, t0, ttft, **kw):
    out = []
    async for tok in engine.generate(prompt, max_new_tokens=n, **kw):
        if not out:
            ttft.append(time.perf_counter() - t0)
        out.append(tok)
    return out


async def serve(engine, jobs) -> "tuple[list[list[int]], list[float], float]":
    """Run ``jobs`` = [(prompt, max_new, kwargs)] concurrently on a started
    engine → (streams, first-token seconds per stream, wall seconds)."""
    ttft: list[float] = []
    t0 = time.perf_counter()
    streams = await asyncio.gather(*[_stream(engine, p, n, t0, ttft, **kw) for p, n, kw in jobs])
    torch.cuda.synchronize()
    return streams, ttft, time.perf_counter() - t0


def _check_recompute(cfg, params, prompts, streams, dev) -> None:
    """Each greedy stream equals a step-by-step recompute: a fresh forward
    over prompt + tokens so far with the plain attention, argmax of the
    last position."""
    for prompt, stream in zip(prompts, streams):
        seq = list(prompt)
        for step, token in enumerate(stream):
            n = len(seq)
            cache = M.make_empty_cache(cfg, 1, n, device=dev)
            tokens = torch.tensor([seq], dtype=torch.int32, device=dev)
            pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
            logits, _ = M.forward(
                params, cfg, tokens, pos, cache,
                torch.tensor([n], dtype=torch.int32, device=dev), attn_impl="plain",
            )
            expect = int(torch.argmax(logits[0, -1]))
            assert token == expect, (
                f"prompt of {len(prompt)}: step {step} engine {token} vs recompute {expect}"
            )
            seq.append(token)


async def _serve_fresh(
    cfg, rt, params, dev, bursts, draft_params=None
) -> "tuple[list[list[int]], EngineStats]":
    """A fresh engine serves ``bursts`` (lists of jobs) one after the other
    → (streams in job order, the engine's stats)."""
    torch.cuda.reset_peak_memory_stats(dev)
    engine = InferenceEngine(cfg, rt, params=params, device=dev, draft_params=draft_params)
    await engine.start()
    try:
        streams = []
        for jobs in bursts:
            streams += (await serve(engine, jobs))[0]
    finally:
        await engine.stop()
    print(f"    {graph_note(graph_numbers(engine), torch.cuda.max_memory_allocated(dev))}")
    return streams, engine.stats


async def exactness_phase(dev) -> dict:
    cfg = preset("llama-3-8b", n_layers=4, dtype="float32")
    g = torch.Generator(device=dev).manual_seed(1)
    params = M.init_params(cfg, g)
    rng = np.random.default_rng(1)
    dense_rt = dict(
        max_batch_size=4, max_seq_len=1024, prefill_chunk=128, decode_steps_per_dispatch=8
    )
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 77, 300)]
    jobs = [(p, 12, {}) for p in prompts]
    streams = {}
    for overlap in (True, False):
        rt = RuntimeConfig(**dense_rt, overlap_dispatch=overlap)
        streams[overlap], _ = await _serve_fresh(cfg, rt, params, dev, [jobs])
    assert streams[True] == streams[False], "overlapped and lockstep streams differ"
    assert [len(s) for s in streams[True]] == [12] * 3
    _check_recompute(cfg, params, prompts, streams[True], dev)
    print("  exactness: 3 greedy streams x 12 tokens, overlap == lockstep == recompute")

    # the paged path: requests sharing a 256-token prefix in two bursts;
    # the second burst reuses the first's pages, and an unrelated prompt's
    # chunks ride the decode dispatches
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).tolist()  # noqa: E731
    bursts = [
        [(prefix + tail(40), 12, {}), (prefix + tail(90), 12, {})],
        [(prefix + tail(60), 12, {}), (prefix + tail(20), 12, {}), (tail(50), 12, {})],
    ]
    paged_rt = RuntimeConfig(
        **dense_rt, kv_layout="paged", page_size=64, chunked_prefill=True,
        prefix_cache=True,
    )
    paged, stats = await _serve_fresh(cfg, paged_rt, params, dev, bursts)
    lockstep, _ = await _serve_fresh(
        cfg, RuntimeConfig(**dense_rt, overlap_dispatch=False), params, dev, bursts
    )
    assert paged == lockstep, "paged streams differ from the dense lockstep engine's"
    assert [len(s) for s in paged] == [12] * 5
    assert stats.prefix_hits == 2 and stats.prefix_reused_tokens == 2 * 256, stats
    assert stats.unified_dispatches >= 1, stats
    _check_recompute(cfg, params, [p for jobs in bursts for p, _, _ in jobs], paged, dev)
    print(
        "  exactness, paged: 5 greedy streams x 12 tokens over two bursts, paged == "
        f"dense lockstep == recompute; prefix hits {stats.prefix_hits} "
        f"({stats.prefix_reused_tokens} tokens), unified dispatches {stats.unified_dispatches}"
    )

    # speculation, the draft model being the target (its own tensors,
    # shared): the same streams, every verify through the ragged kernels
    spec = SpecConfig(k=4, draft=cfg)
    spec_stats = {}
    for name, rt, served, want, kernel in (
        ("dense", RuntimeConfig(**dense_rt, speculative=spec), [jobs], streams[True],
         "ragged_attention"),
        ("paged", replace(paged_rt, speculative=spec), bursts, paged, "ragged_attention_paged"),
    ):
        A.reset_launch_counts()
        got, st = await _serve_fresh(cfg, rt, params, dev, served, draft_params=params)
        launches = dict(A.launch_counts)
        assert got == want, f"{name}: spec-on streams differ from spec-off"
        assert launches[kernel] > 0 and launches["decode_attention"] == 0, launches
        assert launches["paged_decode_attention"] == 0, launches
        assert st.acceptance_rate > 0.9, vars(st)
        if name == "paged":
            assert st.prefix_hits == 2, vars(st)
        spec_stats[name] = dict(vars(st), acceptance_rate=st.acceptance_rate,
                                tokens_per_dispatch=st.tokens_per_dispatch, launches=launches)
        print(
            f"  exactness, spec {name} (k=4, draft = target): spec-on == spec-off; acceptance "
            f"{st.acceptance_rate:.3f}, tokens/dispatch {st.tokens_per_dispatch:.2f}, "
            f"launches {launches}"
        )
    return dict(streams=streams[True], paged_streams=paged, paged_stats=vars(stats),
                spec=spec_stats)


SERVING_RUNTIME = RuntimeConfig(
    max_batch_size=8, max_seq_len=2048, prefill_chunk=512, decode_steps_per_dispatch=8
)


def serving_jobs(vocab_size: int) -> "tuple[list[list[int]], list[tuple]]":
    """The serving workload, from seed 0: 6 prompts of 17-1500 tokens
    (prefill buckets 512, 1024, 1536), 32 new tokens each, request 1
    sampled with its own seed → (prompts, [(prompt, max_new, kwargs)])."""
    rng = np.random.default_rng(0)
    lengths = (17, 130, 480, 700, 1100, 1500)
    prompts = [rng.integers(0, vocab_size, n).tolist() for n in lengths]
    sampled = dict(sampling=SamplingParams(temperature=0.8, top_p=0.95), seed=7)
    return prompts, [(p, 32, sampled if i == 1 else {}) for i, p in enumerate(prompts)]


async def serving_phase(dev) -> dict:
    cfg = preset("llama-3-8b")
    rt = SERVING_RUNTIME
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, rt, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, jobs = serving_jobs(cfg.vocab_size)
    await engine.start()
    try:
        await serve(engine, [([1, 2, 3, 4, 5, 6, 7, 8], 2, {})])  # warm-up
        engine.stats = type(engine.stats)()
        A.reset_launch_counts()
        streams, ttft, wall = await serve(engine, jobs)
        launches = dict(A.launch_counts)
        stats = engine.stats
        round1 = dict(
            decode_tokens=stats.decode_tokens, decode_time_s=stats.decode_time_s,
            decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
            mean_occupancy=stats.mean_occupancy, prefill_waves=stats.prefill_waves,
            prefill_time_s=stats.prefill_time_s,
        )
        assert [len(s) for s in streams] == [32] * 6, [len(s) for s in streams]
        assert launches["decode_attention"] > 0 and launches["prefill_attention"] > 0, launches
        assert launches["paged_decode_attention"] == 0, launches  # not on the dense path
        assert len(engine._free) == rt.max_batch_size and not engine._active
        # the same six again, request 3 with a stop token from its own stream:
        # identical schedule up to the stop, so its stream ends right there
        stop = streams[3][10]
        cut = streams[3].index(stop)
        jobs[3] = (prompts[3], 32, dict(stop_tokens=frozenset({stop})))
        again, _, _ = await serve(engine, jobs)
        assert again[3] == streams[3][:cut], (again[3], streams[3], stop)
        assert again[1] == streams[1], "the seeded sampled stream changed"
        assert len(engine._free) == rt.max_batch_size and not engine._active
    finally:
        await engine.stop()
    numbers, peak = graph_numbers(engine), torch.cuda.max_memory_allocated(dev)
    result = dict(
        init_s=init_s, wall_s=wall, ttft_ms=sorted(x * 1e3 for x in ttft),
        ttft_median_ms=statistics.median(ttft) * 1e3, ttft_max_ms=max(ttft) * 1e3,
        **round1, launches=launches,
        launches_per_request={k: n / len(jobs) for k, n in launches.items()},
        stop_cut=cut, graphs=numbers, max_memory_allocated=peak,
    )
    print(
        f"  serving llama-3-8b bf16, 6 requests x 32 tokens: init {init_s:.2f} s, "
        f"TTFT median {result['ttft_median_ms']:.1f} ms max {result['ttft_max_ms']:.1f} ms, "
        f"decode {result['decode_tok_s']:.1f} tok/s over {result['decode_dispatches']} dispatches, "
        f"launches {launches}; {graph_note(numbers, peak)}"
    )
    return result


PAGED_RUNTIME = RuntimeConfig(
    max_batch_size=16, max_seq_len=2048, kv_layout="paged", page_size=64,
    prefill_chunk=512, chunked_prefill=True, prefix_cache=True,
    decode_steps_per_dispatch=8,
)


def paged_serving_jobs(vocab_size: int) -> "tuple[list[list[int]], list[list[int]]]":
    """Agent-shaped traffic, from seed 2: burst A is 4 requests of one shared
    1024-token instruction prefix plus unique 100-400-token suffixes; burst
    B is 4 more of the same prefix with other suffixes, plus 2 unrelated
    prompts of 17 and 700 tokens → (burst A prompts, burst B prompts)."""
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab_size, 1024).tolist()

    def agent(n):
        return prefix + rng.integers(0, vocab_size, n).tolist()

    burst_a = [agent(n) for n in (100, 250, 330, 400)]
    burst_b = [agent(n) for n in (120, 200, 310, 380)]
    burst_b += [rng.integers(0, vocab_size, n).tolist() for n in (17, 700)]
    return burst_a, burst_b


async def paged_serving_phase(dev, speculative: bool = False) -> dict:
    """The paged serving drive; with ``speculative``, ``SpecConfig(k=4)``
    with the target's own weights as the draft model."""
    cfg = preset("llama-3-8b")
    rt = PAGED_RUNTIME
    new_tokens = 48
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    if speculative:
        rt = replace(rt, speculative=SpecConfig(k=4, draft=cfg))
        g = torch.Generator(device=dev).manual_seed(0)
        params = M.init_params(cfg, g)  # shared by target and draft: one copy
        engine = InferenceEngine(cfg, rt, params=params, draft_params=params, device=dev)
        del params
    else:
        engine = InferenceEngine(cfg, rt, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    burst_a, burst_b = paged_serving_jobs(cfg.vocab_size)

    async def stream(prompt, t_submit, ttft, out):
        async for tok in engine.generate(prompt, max_new_tokens=new_tokens):
            if not out:
                ttft.append(time.perf_counter() - t_submit)
            out.append(tok)

    await engine.start()
    try:
        await serve(engine, [([1, 2, 3, 4, 5, 6, 7, 8], 2, {})])  # warm-up
        engine.stats = EngineStats()
        A.reset_launch_counts()
        with verify_shapes("ragged_attention_paged") as tally, prefill_shapes() as prefills, \
                decode_shapes() as decodes:
            started = time.perf_counter()
            ttft_a: list[float] = []
            ttft_b: list[float] = []
            out_a: list[list[int]] = [[] for _ in burst_a]
            out_b: list[list[int]] = [[] for _ in burst_b]
            tasks = [
                asyncio.create_task(stream(p, started, ttft_a, o))
                for p, o in zip(burst_a, out_a)
            ]
            while not all(len(o) >= 2 for o in out_a):  # burst A is decoding
                if any(t.done() for t in tasks):
                    await asyncio.gather(*tasks)  # surfaces a failure; else one ended early
                    raise AssertionError("a burst-A stream ended before burst B arrived")
                await asyncio.sleep(0.002)
            at_b = time.perf_counter()
            tasks += [
                asyncio.create_task(stream(p, at_b, ttft_b, o)) for p, o in zip(burst_b, out_b)
            ]
            await asyncio.gather(*tasks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - started
            launches = dict(A.launch_counts)
        stats = engine.stats
    finally:
        await engine.stop()
    numbers, peak = graph_numbers(engine), torch.cuda.max_memory_allocated(dev)
    assert [len(o) for o in out_a + out_b] == [new_tokens] * 10
    assert all(0 <= tok < cfg.vocab_size for o in out_a + out_b for tok in o)
    assert launches["prefill_attention"] > 0, launches
    assert launches["decode_attention"] == 0, launches  # the dense kernel is not on this path
    if speculative:  # every token through a verify, none through decode
        assert launches["ragged_attention_paged"] > 0, launches
        assert launches["paged_decode_attention"] == 0, launches
        assert stats.tokens_per_dispatch > 1.5, vars(stats)
    else:
        assert launches["paged_decode_attention"] > 0, launches
        assert launches["ragged_attention_paged"] == 0, launches
        assert stats.unified_dispatches >= 1, vars(stats)
    assert stats.prefix_hits >= 4 and stats.prefix_reused_tokens >= 4096, vars(stats)
    shapes = _shape_rows(tally)
    assert sum(r["launches"] for r in shapes) == launches["ragged_attention_paged"], shapes
    prefill_rows = _shape_rows(prefills)
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"], prefill_rows
    decode_rows = _shape_rows(decodes)
    assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"], decode_rows
    # the no-leak law: every page free or held by the prefix cache, every slot free
    free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
    assert free_pages + cached == rt.pool_pages() - 1, (free_pages, cached)
    assert len(engine._free) == rt.max_batch_size and not engine._active
    result = dict(
        init_s=init_s, wall_s=wall,
        ttft_a_ms=sorted(x * 1e3 for x in ttft_a), ttft_b_ms=sorted(x * 1e3 for x in ttft_b),
        ttft_a_median_ms=statistics.median(ttft_a) * 1e3, ttft_a_max_ms=max(ttft_a) * 1e3,
        ttft_b_median_ms=statistics.median(ttft_b) * 1e3, ttft_b_max_ms=max(ttft_b) * 1e3,
        decode_tokens=stats.decode_tokens, decode_time_s=stats.decode_time_s,
        decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
        mean_occupancy=stats.mean_occupancy, prefill_waves=stats.prefill_waves,
        prefill_time_s=stats.prefill_time_s, prefix_hits=stats.prefix_hits,
        prefix_reused_tokens=stats.prefix_reused_tokens,
        prefix_evictions=stats.prefix_evictions, alloc_stalls=stats.alloc_stalls,
        prefill_absorbed_tokens=stats.prefill_absorbed_tokens,
        unified_dispatches=stats.unified_dispatches, launches=launches,
        pages_free=free_pages, pages_cached=cached,
        spec_proposed=stats.spec_proposed, spec_accepted=stats.spec_accepted,
        spec_emitted=stats.spec_emitted, spec_rows=stats.spec_rows,
        acceptance_rate=stats.acceptance_rate, tokens_per_dispatch=stats.tokens_per_dispatch,
        tok_s_wall=stats.decode_tokens / wall, verify_shapes=shapes, prefill_shapes=prefill_rows,
        decode_shapes=decode_rows, graphs=numbers, max_memory_allocated=peak,
    )
    spec_note = (
        f", spec k=4 draft = target: acceptance {stats.acceptance_rate:.3f}, tokens/dispatch "
        f"{stats.tokens_per_dispatch:.2f}" if speculative else ""
    )
    print(
        f"  paged serving llama-3-8b bf16{spec_note}, 10 requests x {new_tokens} tokens: init "
        f"{init_s:.2f} s, TTFT burst A median {result['ttft_a_median_ms']:.1f} ms max "
        f"{result['ttft_a_max_ms']:.1f} ms, burst B median {result['ttft_b_median_ms']:.1f} "
        f"ms max {result['ttft_b_max_ms']:.1f} ms, decode {result['decode_tok_s']:.1f} tok/s "
        f"over {result['decode_dispatches']} dispatches ({result['tok_s_wall']:.1f} tok/s over "
        f"the run's wall), prefix hits {stats.prefix_hits} "
        f"({stats.prefix_reused_tokens} tokens), unified dispatches "
        f"{stats.unified_dispatches}, launches {launches}, pages free {free_pages} + "
        f"cached {cached} of {rt.pool_pages() - 1}"
        + (f", ragged launches by (B, S, wpages) "
           f"{[(r['B'], r['S'], r['window'], r['launches']) for r in shapes]}"
           if speculative else "")
        + f", prefill launches by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}"
        + ("" if speculative else f", paged decode launches by (B, wpages) "
           f"{[(r['B'], r['window'], r['launches']) for r in decode_rows]}")
        + f"; {graph_note(numbers, peak)}"
    )
    return result


async def spec_serving_phase(dev) -> dict:
    """Dense serving with the n-gram drafter: the serving phase's six
    requests (32 new tokens each, request 1 sampled), every token through a
    verify dispatch and the dense ragged kernel."""
    cfg = preset("llama-3-8b")
    rt = replace(SERVING_RUNTIME, speculative=SpecConfig(k=4))
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, rt, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _, jobs = serving_jobs(cfg.vocab_size)
    await engine.start()
    try:
        await serve(engine, [([1, 2, 3, 4, 5, 6, 7, 8], 2, {})])  # warm-up
        engine.stats = EngineStats()
        A.reset_launch_counts()
        with verify_shapes("ragged_attention") as tally:
            streams, ttft, wall = await serve(engine, jobs)
            launches = dict(A.launch_counts)
        stats = engine.stats
    finally:
        await engine.stop()
    numbers, peak = graph_numbers(engine), torch.cuda.max_memory_allocated(dev)
    assert [len(s) for s in streams] == [32] * 6, [len(s) for s in streams]
    shapes = _shape_rows(tally)
    assert sum(r["launches"] for r in shapes) == launches["ragged_attention"], shapes
    assert launches["ragged_attention"] > 0 and launches["prefill_attention"] > 0, launches
    assert launches["decode_attention"] == 0, launches  # every token through a verify
    assert launches["paged_decode_attention"] == launches["ragged_attention_paged"] == 0
    assert len(engine._free) == rt.max_batch_size and not engine._active
    result = dict(
        init_s=init_s, wall_s=wall, ttft_ms=sorted(x * 1e3 for x in ttft),
        ttft_median_ms=statistics.median(ttft) * 1e3, ttft_max_ms=max(ttft) * 1e3,
        decode_tokens=stats.decode_tokens, decode_time_s=stats.decode_time_s,
        decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
        spec_proposed=stats.spec_proposed, spec_accepted=stats.spec_accepted,
        spec_emitted=stats.spec_emitted, spec_rows=stats.spec_rows,
        acceptance_rate=stats.acceptance_rate, tokens_per_dispatch=stats.tokens_per_dispatch,
        tok_s_wall=stats.decode_tokens / wall, launches=launches, verify_shapes=shapes,
        graphs=numbers, max_memory_allocated=peak,
    )
    print(
        f"  spec serving llama-3-8b bf16, n-gram k=4, 6 requests x 32 tokens: init "
        f"{init_s:.2f} s, TTFT median {result['ttft_median_ms']:.1f} ms max "
        f"{result['ttft_max_ms']:.1f} ms, decode {result['decode_tok_s']:.1f} tok/s over "
        f"{result['decode_dispatches']} verify dispatches ({result['tok_s_wall']:.1f} tok/s "
        f"over the run's wall), acceptance "
        f"{stats.acceptance_rate:.3f}, tokens/dispatch {stats.tokens_per_dispatch:.2f}, "
        f"launches {launches}, ragged launches by (B, S, W) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in shapes]}; "
        f"{graph_note(numbers, peak)}"
    )
    return result


# --------------------------------------------------------------------------- #
# client phase: agent turns through the model client
# --------------------------------------------------------------------------- #

# the model client's stats_snapshot() keys before start(), and live on the
# paged runtime (prefix cache on, no speculation) on a card; the CPU tests
# hold both equal to the JAX client's (tests/test_torch_client.py)
CLIENT_COLD_KEYS = frozenset({
    "model_name", "platform", "tokens_per_second", "mean_occupancy", "active_requests",
    "pending_requests", "free_slots", "max_batch_size", "kv_layout", "prefill_tokens",
    "decode_tokens", "decode_dispatches", "overlap_dispatch", "overlap_wasted_tokens",
    "ragged_waves", "prefill_absorbed_tokens", "unified_dispatches", "tokens_per_dispatch",
    "max_pending", "shed_requests", "expired_requests", "interactive_shed", "batch_shed",
    "interactive_expired", "batch_expired", "interactive_pending", "batch_pending",
    "cancelled_requests", "cancel_propagated", "delivery_stalled", "orphaned_requests",
    "dispatch_ewma_ms", "wedged", "watchdog_trips", "watchdog_faulted", "flightrec",
    "pages_total", "pages_in_use", "prefix_resident_pages", "evictions_window",
    "alloc_stalls", "capacity", "capacity_samples",
})
CLIENT_LIVE_KEYS = CLIENT_COLD_KEYS | {
    "free_pages", "prefix_cached_pages", "prefix_hits", "prefix_reused_tokens", "hbm_gb_in_use",
    "latency_ms",
}

# an agent's instruction block of 1,000 bytes, shared by every conversation;
# with the tool block the conversations share 24 whole pages of 64 tokens,
# which the chunk lane's reuse (whole chunks of 512, one chunk recomputed)
# covers in full
AGENT_INSTRUCTIONS = (
    "You are the travel desk of a small agency. Answer in plain English, in "
    "short paragraphs, and never invent a booking reference. When the user asks "
    "about weather, flights or hotels, call the matching tool with arguments "
    "taken from the conversation; if an argument is missing, ask for it first. "
    "Quote prices in the currency the user wrote, and temperatures in the unit "
    "they used, defaulting to Celsius. Never book anything without an explicit "
    "yes from the user in the same conversation. When a tool returns an error, "
    "apologise once, explain what failed in one sentence and offer the next "
    "best option. Keep a running summary of decisions at the end of each "
    "answer, as a bulleted list of at most five items. Respect the user's "
    "budget: flag any option above it and propose a cheaper one. Dates are "
    "written as YYYY-MM-DD. Cities are written with their country when the "
    "name is ambiguous. If the user changes their mind, update the summary and "
    "say what changed. Do not discuss topics outside travel planning."
)
AGENT_TOOLS = [
    ToolDef(name="get_weather", description="Forecast for a city", parameters_schema={
        "type": "object", "properties": {"city": {"type": "string"}}}),
    ToolDef(name="search_flights", description="Flights on a date", parameters_schema={
        "type": "object", "properties": {
            "origin": {"type": "string"}, "destination": {"type": "string"},
            "date": {"type": "string"}}}),
    ToolDef(name="book_hotel", description="Reserve a hotel room", parameters_schema={
        "type": "object",
        "properties": {"city": {"type": "string"}, "nights": {"type": "integer"}}}),
]
# AGENT_TOOLS as the mesh's schema extraction derives them from the
# functions below: each derived schema adds "additionalProperties": false
# and "required" (every parameter: none has a default), its keys sorted as
# pydantic's are (phase 15 holds the port's pydantic-free extraction equal
# to these; the JAX package's pydantic extraction gives the same)
MESH_TOOLS = [
    t.model_copy(update={"parameters_schema": dict(sorted({
        **t.parameters_schema, "additionalProperties": False,
        "required": list(t.parameters_schema["properties"])}.items()))})
    for t in AGENT_TOOLS
]


def get_weather(city: str) -> dict:
    """Forecast for a city"""
    # three days: phase 15's turn-1 prompts pass 2,048 tokens, so turn 2
    # reuses a fourth whole chunk of 512 beyond the shared instructions
    return {"city": city, "days": [
        {"day": d, "sky": sky, "high_c": 10 + len(city) + d, "low_c": 2 + d, "rain_mm": 3 * d}
        for d, sky in enumerate(("clear", "cloudy", "showers"))]}


def search_flights(origin: str, destination: str, date: str) -> list:
    """Flights on a date"""
    return [{"from": origin, "to": destination, "date": date, "price_eur": 120}]


def book_hotel(city: str, nights: int) -> dict:
    """Reserve a hotel room"""
    return {"city": city, "nights": nights, "booked": False}


AGENT_CITIES = ["Lisbon", "Oslo", "Kyoto", "Lima", "Nairobi", "Hanoi", "Quebec", "Tbilisi"]
CLIENT_MAX_TOKENS = 32

class CharTokenizer:
    """Every id decodes to one character (``chr(0x100 + id)``), so a stream
    on random weights shows text from its first token; text below U+0100
    encodes to its ordinal.  The client phase's tokenizer: the byte
    tokenizer drops the ids past 258 that random weights mostly emit."""

    pad_id, bos_id, eos_id = 0, 1, 2

    def encode(self, text: str) -> "list[int]":
        return [ord(c) - 0x100 if ord(c) >= 0x100 else ord(c) for c in text]

    def decode(self, ids: "list[int]") -> str:
        return "".join(chr(0x100 + i) for i in ids if i >= 0)


async def _client_turn(client, messages, params, max_tokens: int = CLIENT_MAX_TOKENS) -> dict:
    """One agent turn through ``client.request_stream`` → its events, and
    its clocks: submit, first ``TextDelta`` (absent if none came), done."""
    clock = {"submit": time.perf_counter()}
    events = []
    async for event in client.request_stream(
        messages, ModelSettings(max_tokens=max_tokens), params
    ):
        if isinstance(event, TextDelta) and "first" not in clock:
            clock["first"] = time.perf_counter()
        events.append(event)
    clock["done"] = time.perf_counter()
    return dict(events=events, **clock)


def _turn_numbers(turns: "list[dict]", started: float) -> dict:
    ttft = sorted((t["first"] - t["submit"]) * 1e3 for t in turns if "first" in t)
    tokens = sum(t["events"][-1].response.usage.output_tokens for t in turns)
    wall = max(t["done"] for t in turns) - started
    return dict(ttft_ms=ttft, ttft_median_ms=statistics.median(ttft), ttft_max_ms=max(ttft),
                output_tokens=tokens, wall_s=wall, tok_s=tokens / wall)


async def client_phase(dev, card: str = "") -> dict:
    """The paged serving drive's model and runtime, built and served through
    ``TorchLocalModelClient``: 8 agent conversations, 2 turns each, every
    turn rendered by the port's ``render_messages`` and tokenized by
    :class:`CharTokenizer`.  Turn 1: the shared instruction block, 3 tools
    with JSON schemas and a user message unique to the conversation; turn 2
    re-sends turn 1's history, its response and a tool return.  32 new
    tokens a request, greedy; a turn's 8 requests run concurrently.  TTFT is
    ``request_stream`` to the first ``TextDelta``.  ``card`` (the card's
    name and power limit) is printed beside the numbers."""
    cfg = preset("llama-3-8b")
    rt = PAGED_RUNTIME
    platform = "gpu" if dev.type == "cuda" else "cpu"
    tok = CharTokenizer()
    torch.cuda.reset_peak_memory_stats(dev)
    client = TorchLocalModelClient(config=cfg, runtime=rt, tokenizer=tok, device=dev)
    cold = client.stats_snapshot()
    assert set(cold) == CLIENT_COLD_KEYS, set(cold) ^ CLIENT_COLD_KEYS
    assert client.ready() == (False, "engine not built (weights not loaded)")
    t0 = time.perf_counter()
    await client.start()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    assert client.ready() == (True, "engine running"), client.ready()
    engine = client._engine
    params = ModelRequestParameters(tool_defs=AGENT_TOOLS)
    turn1 = [
        [ModelRequest(instructions=AGENT_INSTRUCTIONS, parts=[UserPart(content=(
            f"Trip {i}: weather in {city} on 2026-0{i + 1}-1{i}, and a hotel for {i + 2} nights?"
        ))])]
        for i, city in enumerate(AGENT_CITIES)
    ]
    prompts1 = [[tok.bos_id, *tok.encode(render_messages(m, params))] for m in turn1]
    shared = next(n for n in range(min(map(len, prompts1)))
                  if len({p[n] for p in prompts1}) > 1)
    shared_pages = shared // rt.page_size
    try:
        await client.request([user_message("warm up")], ModelSettings(max_tokens=2))
        engine.stats = EngineStats()
        A.reset_launch_counts()
        with prefill_shapes() as prefills, decode_shapes() as decodes:
            started = time.perf_counter()
            first = await asyncio.gather(*[_client_turn(client, m, params) for m in turn1])
            at_turn2 = time.perf_counter()
            hits, reused = engine.stats.prefix_hits, engine.stats.prefix_reused_tokens
            turn2 = [
                messages + [t["events"][-1].response, ModelRequest(parts=[ToolReturnPart(
                    tool_call_id=f"call_{i}", tool_name="get_weather",
                    content={"city": AGENT_CITIES[i], "temp_c": 14 + i, "sky": "clear"},
                )])]
                for i, (messages, t) in enumerate(zip(turn1, first))
            ]
            second = await asyncio.gather(*[_client_turn(client, m, params) for m in turn2])
            launches = dict(A.launch_counts)
        live = client.stats_snapshot(window=True)
        # the two turns' counters, before the abandoned stream below adds to them
        s = engine.stats
        stats = dict(
            prefix_hits=s.prefix_hits, prefix_reused_tokens=s.prefix_reused_tokens,
            decode_tokens=s.decode_tokens, decode_dispatches=s.decode_dispatches,
            decode_tok_s=s.tokens_per_second, unified_dispatches=s.unified_dispatches,
        )
        hits2, reused2 = stats["prefix_hits"] - hits, stats["prefix_reused_tokens"] - reused
        turns = first + second
        for messages, t in zip(turn1 + turn2, turns):
            events = t["events"]
            response = events[-1].response
            assert isinstance(events[-1], ResponseDone), events[-1]
            prompt = [tok.bos_id, *tok.encode(render_messages(messages, params))]
            assert 1 <= response.usage.output_tokens <= CLIENT_MAX_TOKENS, response.usage
            assert response.usage.input_tokens == len(prompt), (response.usage, len(prompt))
            deltas = "".join(e.text for e in events[:-1] if isinstance(e, TextDelta))
            assert deltas == response.text(), (deltas, response.text())
        text_chars = sum(len(t["events"][-1].response.text()) for t in turns)
        assert text_chars > 0 and all("first" in t for t in first) and \
            all("first" in t for t in second), "the streams carried no text"
        tokens = sum(t["events"][-1].response.usage.output_tokens for t in turns)
        assert hits2 >= 8 and reused2 >= 8 * shared_pages * rt.page_size, (hits2, reused2)
        assert set(live) == (CLIENT_LIVE_KEYS if platform == "gpu"
                             else CLIENT_LIVE_KEYS - {"hbm_gb_in_use"}) | {"window"}, set(live)
        assert live["platform"] == platform, live["platform"]
        assert live["window"]["decode_tokens"] == tokens, (live["window"], tokens)
        assert launches["paged_decode_attention"] > 0 and launches["prefill_attention"] > 0, \
            launches
        prefill_rows, decode_rows = _shape_rows(prefills), _shape_rows(decodes)
        assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
        assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"]
        # the client's own host work on a request, apart from the engine,
        # with the port's byte tokenizer: render and encode each history,
        # and the re-decodes of a 32-token stream (at tokens 1, 4, 8, ...,
        # 32, and the tail), ten times over
        byte_tok = ByteTokenizer()
        ids = np.random.default_rng(0).integers(0, 259, CLIENT_MAX_TOKENS).tolist()
        host0 = time.perf_counter()
        for _ in range(10):
            for messages in turn1 + turn2:
                byte_tok.encode(render_messages(messages, params))
        render_ms = (time.perf_counter() - host0) * 1e3 / (10 * len(turns))
        host0 = time.perf_counter()
        for _ in range(10):
            for n in [1, *range(4, CLIENT_MAX_TOKENS + 1, 4), CLIENT_MAX_TOKENS]:
                byte_tok.decode(ids[:n]).rstrip("\ufffd")
        redecode_ms = (time.perf_counter() - host0) * 1e3 / 10
        # a stream abandoned after its first event gives its slot back
        stream = client.request_stream([user_message("abandon me")], ModelSettings(max_tokens=256))
        assert isinstance(await anext(stream), TextDelta)
        await stream.aclose()
        at_close = engine.stats.decode_dispatches
        deadline = time.perf_counter() + 60
        while engine._active or len(engine._free) != rt.max_batch_size:
            assert time.perf_counter() < deadline, "the abandoned stream kept its slot"
            await asyncio.sleep(0.002)
        ticks = engine.stats.decode_dispatches - at_close
        assert ticks <= 100, ticks
    finally:
        await client.stop()
    numbers, peak = graph_numbers(engine), torch.cuda.max_memory_allocated(dev)
    # the no-leak law: every page free or held by the prefix cache, every slot free
    free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
    assert free_pages + cached == rt.pool_pages() - 1, (free_pages, cached)
    assert len(engine._free) == rt.max_batch_size and not engine._active
    result = dict(
        init_s=init_s, shared_prompt_tokens=shared, shared_pages=shared_pages,
        prompt_tokens=[len(p) for p in prompts1],
        turn1=_turn_numbers(first, started), turn2=_turn_numbers(second, at_turn2),
        tok_s=tokens / (max(t["done"] for t in second) - started), output_tokens=tokens,
        turn2_prefix_hits=hits2, turn2_prefix_reused_tokens=reused2, **stats,
        launches=launches, prefill_shapes=prefill_rows, decode_shapes=decode_rows,
        abandon_ticks=ticks, hbm_gb_in_use=live.get("hbm_gb_in_use"),
        render_encode_ms=render_ms, redecode_ms=redecode_ms, text_chars=text_chars,
        graphs=numbers, max_memory_allocated=peak,
    )
    t1, t2 = result["turn1"], result["turn2"]
    print(
        f"  client llama-3-8b bf16, 8 agent conversations x 2 turns x <= {CLIENT_MAX_TOKENS} "
        f"tokens through TorchLocalModelClient (one run, no spread; {card}): "
        f"init {init_s:.2f} s, "
        f"prompts {min(result['prompt_tokens'])}-{max(result['prompt_tokens'])} tokens "
        f"({shared} shared, {shared_pages} whole pages); TTFT (request_stream -> first "
        f"TextDelta) turn 1 median {t1['ttft_median_ms']:.1f} ms max "
        f"{t1['ttft_max_ms']:.1f} ms, turn 2 median {t2['ttft_median_ms']:.1f} ms max "
        f"{t2['ttft_max_ms']:.1f} ms; {tokens} tokens ({text_chars} characters) at "
        f"{result['tok_s']:.1f} tok/s over both turns' wall (turn 1 {t1['tok_s']:.1f}, turn 2 "
        f"{t2['tok_s']:.1f}); decode {stats['decode_tok_s']:.1f} tok/s over "
        f"{stats['decode_dispatches']} dispatches; turn 2 prefix hits {hits2} ({reused2} "
        f"tokens); the client's host work a request (byte tokenizer): render + encode "
        f"{render_ms:.3f} ms, re-decodes {redecode_ms:.3f} ms; launches {launches}; prefill "
        f"launches by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}, paged "
        f"decode launches by (B, wpages) "
        f"{[(r['B'], r['window'], r['launches']) for r in decode_rows]}; abandoned stream's "
        f"slot back after {ticks} dispatches; pages free {free_pages} + cached {cached} of "
        f"{rt.pool_pages() - 1}; {graph_note(numbers, peak)}"
    )
    return result


# --------------------------------------------------------------------------- #
# the checkpoint path: quantized weights, an HF checkpoint, the north star
# --------------------------------------------------------------------------- #


def same_tree(a, b) -> bool:
    """Two params trees hold the same keys and bit-identical tensors."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a params tree (payloads and scales)."""
    return sum(tree_bytes(w) if isinstance(w, dict) else w.numel() * w.element_size()
               for w in tree.values())


async def quant_exactness_phase(dev) -> dict:
    """The exactness phase's model (Llama-3-8B widths, 4 layers, f32) with
    int8 and then int4 weights: dense KV (the engine quantizing the
    full-precision params at construction, bit for bit the tree quantized
    beforehand) and paged KV with the prefix cache over two bursts; every
    greedy stream equals a step-by-step recompute through ``model.forward``
    with the plain attention on the same quantized tree."""
    cfg = preset("llama-3-8b", n_layers=4, dtype="float32")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    rng = np.random.default_rng(11)
    dense_rt = dict(
        max_batch_size=4, max_seq_len=1024, prefill_chunk=128, decode_steps_per_dispatch=8
    )
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 77, 300)]
    prefix = rng.integers(0, cfg.vocab_size, 256).tolist()
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).tolist()  # noqa: E731
    bursts = [
        [(prefix + tail(40), 12, {}), (prefix + tail(90), 12, {})],
        [(prefix + tail(60), 12, {}), (tail(50), 12, {})],
    ]
    out = {}
    for quantization in ("int8", "int4"):
        qparams = Q.quantize_params(params, bits=Q.bits_of(quantization))
        rt = RuntimeConfig(**dense_rt, quantization=quantization)
        # a shallow copy: the engine consumes the tree it quantizes
        full = {**params, "layers": dict(params["layers"])}
        engine = InferenceEngine(cfg, rt, params=full, device=dev)
        assert same_tree(engine.params, qparams), "quantized at construction != beforehand"
        await engine.start()
        A.reset_launch_counts()
        try:
            dense = (await serve(engine, [(p, 12, {}) for p in prompts]))[0]
        finally:
            await engine.stop()
        dense_launches = dict(A.launch_counts)
        del engine
        assert [len(s) for s in dense] == [12] * 3
        assert dense_launches["decode_attention"] > 0 and dense_launches["prefill_attention"] > 0
        _check_recompute(cfg, qparams, prompts, dense, dev)
        paged_rt = RuntimeConfig(
            **dense_rt, kv_layout="paged", page_size=64, chunked_prefill=True,
            prefix_cache=True, quantization=quantization,
        )
        A.reset_launch_counts()
        paged, stats = await _serve_fresh(cfg, paged_rt, qparams, dev, bursts)
        paged_launches = dict(A.launch_counts)
        assert [len(s) for s in paged] == [12] * 4
        assert stats.prefix_hits == 1 and stats.prefix_reused_tokens == 256, vars(stats)
        assert paged_launches["paged_decode_attention"] > 0, paged_launches
        _check_recompute(cfg, qparams, [p for jobs in bursts for p, _, _ in jobs], paged, dev)
        out[quantization] = dict(dense_launches=dense_launches, paged_launches=paged_launches,
                                 weight_bytes=tree_bytes(qparams))
        print(
            f"  exactness, {quantization} (dequantized to bf16, f32 activations): 3 dense "
            f"streams (quantized at construction) and 4 paged+prefix streams x 12 tokens == "
            f"recompute on the same quantized tree; prefix hits {stats.prefix_hits}; weights "
            f"{tree_bytes(qparams) / 1e9:.3f} GB (f32 {tree_bytes(params) / 1e9:.3f} GB)"
        )
        del qparams
    return out


def write_safetensors(path, tensors: "dict[str, torch.Tensor]") -> None:
    """Write ``tensors`` (CPU, bf16 or f32) as one safetensors file: the
    8-byte little-endian header length, the JSON header of each tensor's
    dtype, shape and byte range in the data section, padded to 8 bytes,
    then the raw little-endian bytes (the format's own writer is not
    needed)."""
    codes = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(torch.uint8).numpy().data)


def hf_tensors(cfg, dev, seed: int) -> "dict[str, torch.Tensor]":
    """Random bf16 weights of ``cfg`` under HF Llama names, projections in
    HF's [out, in] layout, drawn on the card from ``seed``; norms around 1
    so a swapped norm shows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    D, H, K, hd, Fd, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                          cfg.vocab_size)

    def draw(rows, cols):
        return (torch.randn((rows, cols), generator=g, device=dev) / math.sqrt(cols)).to(
            torch.bfloat16)

    def norm():
        return (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(torch.bfloat16)

    tensors = {"model.embed_tokens.weight": draw(V, D)}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        tensors |= {
            pre + "self_attn.q_proj.weight": draw(H * hd, D),
            pre + "self_attn.k_proj.weight": draw(K * hd, D),
            pre + "self_attn.v_proj.weight": draw(K * hd, D),
            pre + "self_attn.o_proj.weight": draw(D, H * hd),
            pre + "mlp.gate_proj.weight": draw(Fd, D),
            pre + "mlp.up_proj.weight": draw(Fd, D),
            pre + "mlp.down_proj.weight": draw(D, Fd),
            pre + "input_layernorm.weight": norm(),
            pre + "post_attention_layernorm.weight": norm(),
        }
    tensors |= {"model.norm.weight": norm(), "lm_head.weight": draw(V, D)}
    return tensors


def hf_layout(cfg, tensors, name: str) -> torch.Tensor:
    """The port's stacked leaf ``name`` built from HF ``tensors`` by hand
    (transposes and reshapes), for holding the loader to."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if name == "embed":
        return tensors["model.embed_tokens.weight"]
    if name == "final_norm":
        return tensors["model.norm.weight"]
    if name == "lm_head":
        return tensors["lm_head.weight"].T
    hf, shape = {
        "wq": ("self_attn.q_proj.weight", (D, H, hd)), "wk": ("self_attn.k_proj.weight", (D, K, hd)),
        "wv": ("self_attn.v_proj.weight", (D, K, hd)), "wo": ("self_attn.o_proj.weight", (H, hd, D)),
        "w_gate": ("mlp.gate_proj.weight", (D, -1)), "w_up": ("mlp.up_proj.weight", (D, -1)),
        "w_down": ("mlp.down_proj.weight", (-1, D)), "attn_norm": ("input_layernorm.weight", None),
        "mlp_norm": ("post_attention_layernorm.weight", None),
    }[name]
    per_layer = [tensors[f"model.layers.{i}.{hf}"] for i in range(cfg.n_layers)]
    return torch.stack([w if shape is None else w.T.reshape(shape) for w in per_layer])


CKPT_TURNS = 4
CKPT_MAX_TOKENS = 16


async def checkpoint_phase(dev, card: str = "") -> dict:
    """An HF-layout BF16 checkpoint at Llama-3-8B widths and 2 layers (two
    shards behind ``model.safetensors.index.json``, and ``config.json``),
    written by :func:`write_safetensors` into a temporary directory; then
    ``TorchLocalModelClient(checkpoint=...)`` on the paged runtime serves
    4 agent turns, its bf16 leaves bit for bit the written tensors; then
    ``load_params(quantize="int8")`` quantizes on the host, its payloads and
    scales those of ``quantize_array_host`` of the same arrays, the card's
    peak allocation over the load within the int8 tree's bytes (the bf16
    embedding and norms among them) plus 5%.  The turns' prefill and paged
    decode launches are tallied by shape (:func:`prefill_shapes`,
    :func:`decode_shapes`)."""
    base = preset("llama-3-8b")
    cfg = replace(base, n_layers=2)
    tok = CharTokenizer()
    with tempfile.TemporaryDirectory(prefix="calfkit-ckpt-") as tmp:
        path = Path(tmp)
        t0 = time.perf_counter()
        drawn = hf_tensors(cfg, dev, seed=5)
        host = {name: t.cpu() for name, t in drawn.items()}
        names = list(host)
        shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
                  "model-00002-of-00002.safetensors": names[len(names) // 2:]}
        for shard, members in shards.items():
            write_safetensors(path / shard, {name: host[name] for name in members})
        (path / "model.safetensors.index.json").write_text(json.dumps({
            "metadata": {"total_size": sum(t.numel() * 2 for t in host.values())},
            "weight_map": {name: shard for shard, members in shards.items() for name in members},
        }))
        (path / "config.json").write_text(json.dumps({
            "_name_or_path": "llama-3-8b-random-2-layers", "vocab_size": cfg.vocab_size,
            "hidden_size": cfg.d_model, "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.d_ff, "rope_theta": cfg.rope_theta,
            "rms_norm_eps": cfg.norm_eps, "max_position_embeddings": cfg.max_seq_len,
            "tie_word_embeddings": False, "torch_dtype": "bfloat16",
        }))
        disk_gb = sum(f.stat().st_size for f in path.glob("*.safetensors")) / 1e9
        write_s = time.perf_counter() - t0
        loaded_cfg = config_from_hf(path)
        assert loaded_cfg == replace(cfg, name="llama-3-8b-random-2-layers"), loaded_cfg

        torch.cuda.reset_peak_memory_stats(dev)
        client = TorchLocalModelClient(
            checkpoint=str(path), tokenizer=tok, runtime=PAGED_RUNTIME, device=dev
        )
        assert client.model_name == str(path)
        t0 = time.perf_counter()
        await client.start()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        engine = client._engine
        assert client.model_name == "llama-3-8b-random-2-layers"
        params = engine.params
        for name in ("embed", "final_norm", "lm_head"):
            assert torch.equal(params[name], hf_layout(cfg, drawn, name)), name
        for name in params["layers"]:
            assert torch.equal(params["layers"][name], hf_layout(cfg, drawn, name)), name
        bf16_bytes = tree_bytes(params)
        turns = [
            [ModelRequest(instructions=AGENT_INSTRUCTIONS, parts=[UserPart(
                content=f"Weather in {city} tomorrow?")])]
            for city in AGENT_CITIES[:CKPT_TURNS]
        ]
        request_params = ModelRequestParameters(tool_defs=AGENT_TOOLS)
        try:
            A.reset_launch_counts()
            with prefill_shapes() as prefills, decode_shapes() as decodes:
                started = time.perf_counter()
                done = await asyncio.gather(*[
                    _client_turn(client, m, request_params, CKPT_MAX_TOKENS) for m in turns
                ])
                launches = dict(A.launch_counts)
        finally:
            await client.stop()
        numbers, serve_peak = graph_numbers(engine), torch.cuda.max_memory_allocated(dev)
        first_turn_s = max(t["done"] for t in done) - started
        for t in done:
            response = t["events"][-1].response
            assert 1 <= response.usage.output_tokens <= CKPT_MAX_TOKENS, response.usage
            assert "first" in t and response.text(), "a turn streamed no text"
        assert launches["prefill_attention"] > 0 and launches["paged_decode_attention"] > 0, \
            launches
        prefill_rows, decode_rows = _shape_rows(prefills), _shape_rows(decodes)
        assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
        assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"]
        free_pages = engine._page_alloc.free_pages
        assert free_pages + engine._prefix.size == PAGED_RUNTIME.pool_pages() - 1
        del engine, params, client
        torch.cuda.empty_cache()

        # the int8 load: quantized on the host, only int8 payloads, f32
        # scales and the bf16 embedding and norms reach the card
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        qparams = load_params(path, loaded_cfg, device=dev, quantize="int8")
        torch.cuda.synchronize()
        load8_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - before
    # the tree's bytes (the bf16 embedding and norms among them) plus 5%:
    # less than one bf16 layer leaf of this checkpoint (w_gate, 0.235 GB),
    # so a full-precision copy left on the card breaks it
    q_bytes = tree_bytes(qparams)
    assert peak <= 1.05 * q_bytes, (peak, q_bytes)
    for name, leaf in [*qparams["layers"].items(), ("lm_head", qparams["lm_head"])]:
        if not isinstance(leaf, dict):
            assert torch.equal(leaf, hf_layout(cfg, drawn, name)), name
            continue
        axes = Q.LM_HEAD_REDUCTION_AXES if name == "lm_head" else Q.LAYER_REDUCTION_AXES[name]
        want = Q.quantize_array_host(hf_layout(cfg, drawn, name).float().cpu().numpy(), axes)
        for key in ("q8", "scale"):
            assert torch.equal(leaf[key].cpu(), torch.from_numpy(want[key])), (name, key)
    del qparams, drawn, host
    result = dict(
        disk_gb=disk_gb, write_s=write_s, load_s=load_s, load_int8_s=load8_s,
        first_turn_s=first_turn_s, turn=_turn_numbers(done, started), bf16_weight_bytes=bf16_bytes,
        int8_weight_bytes=q_bytes, int8_load_peak_bytes=peak, launches=launches,
        prefill_shapes=prefill_rows, decode_shapes=decode_rows, graphs=numbers,
        max_memory_allocated=serve_peak,
    )
    print(
        f"  checkpoint: llama-3-8b widths, 2 layers, BF16 in 2 shards ({disk_gb:.2f} GB) "
        f"written in {write_s:.2f} s; TorchLocalModelClient(checkpoint=...) loaded and started "
        f"in {load_s:.2f} s ({bf16_bytes / 1e9:.3f} GB of weights, bit for bit the written "
        f"tensors); {CKPT_TURNS} agent turns in {first_turn_s:.3f} s (TTFT median "
        f"{result['turn']['ttft_median_ms']:.1f} ms); int8 load {load8_s:.2f} s, "
        f"{q_bytes / 1e9:.3f} GB, peak allocation {peak / 1e9:.3f} GB (law: <= "
        f"{1.05 * q_bytes / 1e9:.3f} GB); launches {launches}; prefill (B, Sq, Skv, launches) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}, paged decode "
        f"(B, wpages, launches) {[(r['B'], r['window'], r['launches']) for r in decode_rows]}; "
        f"turns' {graph_note(numbers, serve_peak)} ({card})"
    )
    return result


NORTH_STAR_RUNTIME = RuntimeConfig(
    max_batch_size=32, max_seq_len=1024, prefill_chunk=128, decode_steps_per_dispatch=32,
    kv_layout="paged", page_size=64, num_kv_pages=32 * 4 + 65, chunked_prefill=True,
)
NORTH_STAR_REQUESTS = 32
NORTH_STAR_PROMPT = 64
NORTH_STAR_NEW = 128


def north_star_jobs(requests: int = NORTH_STAR_REQUESTS) -> "list[tuple]":
    """``bench.py``'s ``llama8b`` requests: 64-token prompts, 128 new tokens
    each → [(prompt, max_new, kwargs)]."""
    return [([3 + (i % 41), *range(7, 6 + NORTH_STAR_PROMPT)], NORTH_STAR_NEW, {})
            for i in range(requests)]


def north_star_params(cfg, quantization: "str | None"):
    """The north star's int8 or int4 params, built quantized on the host
    from seed 0 (the JAX package's draws); None for bf16 (the engine's
    random init)."""
    if quantization is None:
        return None
    return Q.random_quantized_params_host(cfg, 0, bits=Q.bits_of(quantization))


async def north_star_phase(
    dev, quantization: "str | None", card: str = "", requests: int = NORTH_STAR_REQUESTS,
    keep: "dict | None" = None,
) -> dict:
    """The JAX package's north-star shape (``bench.py``'s ``llama8b``): the
    full llama-3-8b preset at ``max_seq_len`` 1024, 32 rows, 32 decode steps
    a dispatch, paged KV (page 64, 193 pages), chunked prefill (chunk 128);
    int8 and int4 weights from ``random_quantized_params_host`` (seed 0),
    bf16 from the engine's random init.  One wave of ``requests`` (32)
    requests of 64 prompt tokens (``bench.py``'s prompts) and 128 new
    tokens, greedy.  The prefill and paged decode launches are tallied by
    shape (:func:`prefill_shapes`, :func:`decode_shapes`).  ``keep``, when
    given, receives the engine's weights (``keep["params"]``) for a later
    phase of the same model."""
    cfg = preset("llama-3-8b", max_seq_len=NORTH_STAR_RUNTIME.max_seq_len)
    rt = replace(NORTH_STAR_RUNTIME, quantization=quantization)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = north_star_params(cfg, quantization)
    host_s = time.perf_counter() - t0
    engine = InferenceEngine(cfg, rt, params=params, seed=0, device=dev)
    del params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(engine.params)
    jobs = north_star_jobs(requests)
    await engine.start()
    try:
        await serve(engine, [([5, *range(6, 5 + NORTH_STAR_PROMPT)], 40, {})])  # warm-up
        engine.stats = EngineStats()
        A.reset_launch_counts()
        with prefill_shapes() as prefills, decode_shapes() as decodes:
            streams, ttft, wall = await serve(engine, jobs)
            launches = dict(A.launch_counts)
        stats = engine.stats
    finally:
        await engine.stop()
    peak = torch.cuda.max_memory_allocated(dev)
    numbers = graph_numbers(engine)
    assert [len(s) for s in streams] == [NORTH_STAR_NEW] * requests
    assert all(0 <= t < cfg.vocab_size for s in streams for t in s)
    assert launches["prefill_attention"] > 0 and launches["paged_decode_attention"] > 0, launches
    assert launches["decode_attention"] == 0, launches
    prefill_rows, decode_rows = _shape_rows(prefills), _shape_rows(decodes)
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
    assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"]
    # the no-leak law (no prefix cache): every page and slot free
    assert engine._page_alloc.free_pages == rt.pool_pages() - 1, engine._page_alloc.free_pages
    assert len(engine._free) == rt.max_batch_size and not engine._active
    name = quantization or "bf16"
    if keep is not None:
        keep["params"] = engine.params
    result = dict(
        host_params_s=host_s, init_s=init_s, wall_s=wall, ttft_ms=sorted(x * 1e3 for x in ttft),
        ttft_median_ms=statistics.median(ttft) * 1e3, ttft_max_ms=max(ttft) * 1e3,
        decode_tokens=stats.decode_tokens, decode_time_s=stats.decode_time_s,
        decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
        mean_dispatch_ms=stats.decode_time_s / stats.decode_dispatches * 1e3,
        unified_dispatches=stats.unified_dispatches, prefill_waves=stats.prefill_waves,
        requests=requests, tok_s_wall=requests * NORTH_STAR_NEW / wall,
        weight_bytes=weight_bytes, max_memory_allocated=peak, launches=launches,
        prefill_shapes=prefill_rows, decode_shapes=decode_rows, graphs=numbers,
    )
    print(
        f"  north star llama-3-8b {name}, {requests} requests x "
        f"{NORTH_STAR_PROMPT} prompt + {NORTH_STAR_NEW} new tokens (one run, no spread; "
        f"{card}): params on the host {host_s:.2f} s, engine built {init_s:.2f} s; TTFT median "
        f"{result['ttft_median_ms']:.1f} ms max {result['ttft_max_ms']:.1f} ms; decode "
        f"{result['decode_tok_s']:.1f} tok/s over {stats.decode_dispatches} dispatches, mean "
        f"dispatch {result['mean_dispatch_ms']:.1f} ms; {result['tok_s_wall']:.1f} tok/s over "
        f"the wall {wall:.2f} s; weights {weight_bytes / 1e9:.3f} GB, max allocated "
        f"{peak / 1e9:.3f} GB; launches {launches}; prefill (B, Sq, Skv, launches) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}, paged decode "
        f"(B, wpages, launches) {[(r['B'], r['window'], r['launches']) for r in decode_rows]}; "
        f"{graph_note(numbers, peak)}"
    )
    del engine
    return result


# --------------------------------------------------------------------------- #
# the compiled-dispatch layer: graphs against eager(), the same drives
# --------------------------------------------------------------------------- #

GRAPH_PEAK_LAW = 1.25  # graph serving's peak allocation over eager()'s, at most


async def _graph_drive(cfg, rt, params, dev, jobs, eager: bool, draft: bool = False) -> dict:
    """A fresh engine on ``params`` serves ``jobs`` at once, under
    :func:`graphs.eager` or on graphs → its streams and numbers; the peak
    allocation is counted from before the engine (``params`` already on
    the card)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    proposals: list = []
    with graphs.eager() if eager else contextlib.nullcontext():
        engine = InferenceEngine(cfg, rt, params=params, device=dev,
                                 draft_params=params if draft else None)
        if draft:  # every proposal of the run, in order
            propose = engine._drafter.propose
            engine._drafter.propose = lambda entries: proposals.append(
                propose(entries)) or proposals[-1]
        await engine.start()
        try:
            streams, ttft, wall = await serve(engine, jobs)
        finally:
            await engine.stop()
            if draft:  # the recorder holds the drafter: break that cycle, or
                # the draft cache outlives the engine into the next drive's peak
                del engine._drafter.propose
        numbers = graph_numbers(engine)
    peak = torch.cuda.max_memory_allocated(dev)
    stats = engine.stats
    assert len(engine._free) == rt.max_batch_size and not engine._active
    out = dict(
        streams=streams, wall_s=wall, ttft_median_ms=statistics.median(ttft) * 1e3,
        decode_tok_s=stats.tokens_per_second, decode_dispatches=stats.decode_dispatches,
        mean_dispatch_ms=stats.decode_time_s / max(stats.decode_dispatches, 1) * 1e3,
        max_memory_allocated=peak, engine_peak_bytes=peak - base, graphs=numbers,
        proposals=proposals,
    )
    del engine
    return out


async def graph_phase(dev, card: str = "") -> dict:
    """The lockstep dense, paged and speculative paged drives and the bf16
    north star, each served by a fresh engine under :func:`graphs.eager`
    and then by one on graphs, on one set of llama-3-8b weights (seed 0):
    the schedule and the kernels are the same, so every token stream is
    bit for bit the same; graph serving's peak allocation is at most
    ``GRAPH_PEAK_LAW`` x eager's at the paged and north-star drives.  The
    dense drive is the serving phase's six requests (one sampled); the
    paged ones serve both of the paged phase's bursts at once, 16 new
    tokens each, the speculative one with ``SpecConfig(k=4)`` and the
    target as its draft; the north star is its 32 requests of 64 + 128
    tokens.  The speculative drive's draft model proposes through one
    graph a catch-up width: none is captured under ``eager()``, every width
    is on graphs, and the two runs make the same proposals; its streams
    equal the paged drive's (spec-on == spec-off), or leave them only at a
    step where both runs chose a token at a bf16 tie (phase 13's law)."""
    cfg = preset("llama-3-8b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    burst_a, burst_b = paged_serving_jobs(cfg.vocab_size)
    paged_jobs = [(p, 16, {}) for p in burst_a + burst_b]
    lockstep = dict(overlap_dispatch=False)
    drives = (
        ("dense", cfg, replace(SERVING_RUNTIME, **lockstep), serving_jobs(cfg.vocab_size)[1],
         False, False),
        ("paged", cfg, replace(PAGED_RUNTIME, **lockstep), paged_jobs, False, True),
        ("spec-paged", cfg, replace(PAGED_RUNTIME, **lockstep,
                                    speculative=SpecConfig(k=4, draft=cfg)),
         paged_jobs, True, False),
        ("north-bf16", replace(cfg, max_seq_len=NORTH_STAR_RUNTIME.max_seq_len),
         replace(NORTH_STAR_RUNTIME, **lockstep), north_star_jobs(), False, True),
    )
    result, streams = {}, {}
    for name, drive_cfg, rt, jobs, draft, peak_law in drives:
        eager = await _graph_drive(drive_cfg, rt, params, dev, jobs, eager=True, draft=draft)
        graphed = await _graph_drive(drive_cfg, rt, params, dev, jobs, eager=False, draft=draft)
        if dev.type == "cuda":  # (a CPU rehearsal runs every body eagerly)
            assert eager["graphs"]["eager"] == eager["graphs"]["calls"] > 0, eager["graphs"]
            assert eager["graphs"]["captures"] == eager["graphs"]["replays"] == 0, eager["graphs"]
            if draft:
                e, g = eager["graphs"]["draft"], graphed["graphs"]["draft"]
                assert e["captures"] == e["replays"] == 0 < e["eager"], e
                assert 0 < g["captures"] == len(g["keys"]) and g["eager"] == 0, g
                assert g["keys"] == e["keys"], (g, e)
        assert graphed["streams"] == eager["streams"], f"{name}: graph streams differ from eager"
        assert graphed["proposals"] == eager["proposals"], f"{name}: graph drafts differ from eager"
        assert bool(graphed["proposals"]) == draft, name
        streams[name] = graphed["streams"]
        ratio = graphed["max_memory_allocated"] / eager["max_memory_allocated"]
        if peak_law:
            assert ratio <= GRAPH_PEAK_LAW, (name, ratio)
        result[name] = dict(
            eager={k: v for k, v in eager.items() if k not in ("streams", "proposals")},
            graphs={k: v for k, v in graphed.items() if k not in ("streams", "proposals")},
            peak_ratio=ratio, tokens=sum(map(len, graphed["streams"])),
            proposals=len(graphed["proposals"]),
        )
        e, g = eager, graphed
        print(
            f"  graphs vs eager(), {name} lockstep ({len(jobs)} requests, "
            f"{result[name]['tokens']} tokens, one run each, no spread; {card}): streams equal "
            f"bit for bit; wall {e['wall_s']:.2f} -> {g['wall_s']:.2f} s, TTFT median "
            f"{e['ttft_median_ms']:.1f} -> {g['ttft_median_ms']:.1f} ms, decode "
            f"{e['decode_tok_s']:.1f} -> {g['decode_tok_s']:.1f} tok/s, mean dispatch "
            f"{e['mean_dispatch_ms']:.1f} -> {g['mean_dispatch_ms']:.1f} ms; max allocated "
            f"{e['max_memory_allocated'] / 1e9:.3f} -> {g['max_memory_allocated'] / 1e9:.3f} GB "
            f"(x{ratio:.3f}{f', law <= {GRAPH_PEAK_LAW}' if peak_law else ''}; above the "
            f"weights {e['engine_peak_bytes'] / 1e9:.3f} -> {g['engine_peak_bytes'] / 1e9:.3f} "
            f"GB); {graph_note(g['graphs'], g['max_memory_allocated'])}"
            + (f"; {len(g['proposals'])} proposal rounds, drafts equal bit for bit"
               if draft else "")
        )
    # spec-on == spec-off: the speculative drive serves the paged drive's
    # jobs; a stream may leave the other only at a step where both runs
    # chose a token at a bf16 tie of the f32 witness
    on, off = streams["spec-paged"], streams["paged"]
    differ = [(f"job{i}", prompt, a, b)
              for i, ((prompt, _, _), a, b) in enumerate(zip(paged_jobs, on, off)) if a != b]
    law = tie_law(cfg, params, differ, dev, labels=("spec-on", "spec-off")) if differ else None
    result["spec-paged"]["spec_on_off"] = dict(equal=len(on) - len(differ), law=law)
    print(f"  graphs, spec-paged against paged: spec-on == spec-off in {len(on) - len(differ)} of "
          f"{len(on)} streams" + (f"; the others differ at a bf16 tie: {law}" if law else ""))
    del params
    return result


# --------------------------------------------------------------------------- #
# phase 13: the robustness layer and its telemetry under overload
# --------------------------------------------------------------------------- #

# the paged serving runtime with a pool of half what 16 rows x 2048 tokens
# need (513 pages), bounded admission, the delivery stall bound, the
# watchdog and the occupancy timeline
OVERLOAD_RUNTIME = RuntimeConfig(
    max_batch_size=16, max_seq_len=2048, kv_layout="paged", page_size=64,
    prefill_chunk=512, chunked_prefill=True, prefix_cache=True, decode_steps_per_dispatch=8,
    num_kv_pages=257, max_pending=16, max_out_blocks=2, watchdog_stall_s=30.0,
    capacity_samples=1 << 12, flightrec_events=1 << 16,
)
OVERLOAD_REQUESTS = 48
OVERLOAD_NEW = 32
# the drill's roles by request index: every third request is batch-class;
# 0, 4 and 21 carry a deadline 5 s out, 1, 4 and 22 a lease that stops
# beating (TTL 5 s), 3 a live lease; 6's consumer stops reading
OVERLOAD_DEADLINED = (0, 4, 21)
OVERLOAD_DEAD_LEASE = (1, 4, 22)
OVERLOAD_LIVE_LEASE = (3,)
OVERLOAD_STALLED = 6
# the two endings of EngineOverloadedError: a shed at admission, a stall
_ENDINGS = {
    "shed": ("EngineOverloadedError", "short"),
    "stalled": ("EngineOverloadedError", "delivery"),
}


class VirtualClock:
    """The wall clock of the phase: ``cancellation.wall_clock`` reads it,
    and only the script advances it, so deadlines, lease lapse and the
    watchdog fire at the same point of every run."""

    def __init__(self, now: float = 1_700_000_000.0):
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> None:
        self.now += seconds


class Pace:
    """The engine's chaos seam as the phase's script: at the start of each
    scheduler pass it fires the armed actions whose condition holds; a
    decode tick blocks on ``gate`` once :meth:`block_next_dispatch` armed
    it (a landing held past the watchdog's threshold)."""

    def __init__(self):
        self.armed: list = []
        self.gate = None
        self.blocked = False

    def when(self, condition, action) -> None:
        self.armed.append((condition, action))

    def block_next_dispatch(self, gate) -> None:
        self.gate = gate

    def __call__(self, point: str) -> None:
        if point == "tick":
            for entry in list(self.armed):
                if entry[0]():
                    self.armed.remove(entry)
                    entry[1]()
        elif self.gate is not None:
            gate, self.gate = self.gate, None
            self.blocked = True
            gate.wait()


def overload_prompts(vocab_size: int) -> "list[list[int]]":
    """Agent-shaped prompts from seed 13: 9 instruction blocks of 1,000
    tokens, each shared by six agents (the ninth by the wedge drill's
    requests), plus a unique tail of 40-200 tokens a request."""
    rng = np.random.default_rng(13)
    blocks = [rng.integers(0, vocab_size, 1000).tolist() for _ in range(9)]
    return [blocks[i // 6] + rng.integers(0, vocab_size, int(rng.integers(40, 200))).tolist()
            for i in range(OVERLOAD_REQUESTS + 6)]


async def _settle(condition, seconds: float = 120.0, what: str = "") -> None:
    deadline = time.perf_counter() + seconds
    while not condition():
        assert time.perf_counter() < deadline, f"never settled: {what}"
        await asyncio.sleep(0.002)


def quiescent(engine) -> bool:
    """Nothing queued, admitting, in flight or active."""
    return (not engine._active and engine._pend is None and engine._inflight is None
            and not engine._pending and not engine._carry and not engine._admitting)


async def overload_drive(cfg, rt, params, dev, dump_dir: str) -> dict:
    """One run of the overload phase's script (see :func:`overload_phase`)
    → the engine (stopped) and every request's ending."""
    import threading

    from calfkit_tpu_torch import cancellation, leases
    from calfkit_tpu_torch.exceptions import CalfkitError
    from calfkit_tpu_torch.observability.capacity import CapacitySampler

    engine = InferenceEngine(cfg, rt, params=params, device=dev)
    pool = engine._page_alloc.num_pages - 1
    sampled: list = []

    class CheckedSampler(CapacitySampler):
        """At every occupancy sample: pages by owner + free pages == pool."""

        def append(self, *args, **kw):
            b = engine._ledger.breakdown()
            sampled.append(b["private_pages"] + b["prefix_resident_pages"]
                           + engine._page_alloc.free_pages)
            super().append(*args, **kw)

    engine._sampler = CheckedSampler(rt.capacity_samples, label="overload", ledger=engine._ledger)
    pace = Pace()
    engine._chaos = pace
    prompts = overload_prompts(cfg.vocab_size)
    outcomes: dict = {}

    def live(corr):
        return next((r for r in list(engine._active.values()) if r.corr == corr), None)

    async def run(corr, prompt, hold=None, **kw):
        toks = []
        stream = engine.generate(prompt, max_new_tokens=OVERLOAD_NEW, corr=corr, **kw)
        try:
            async for tok in stream:
                toks.append(tok)
                if hold is not None and len(toks) == 1:
                    await hold.wait()
            outcomes[corr] = ("ok", toks)
        except CalfkitError as exc:
            outcomes[corr] = (type(exc).__name__, getattr(exc, "lane", None))
        finally:
            await stream.aclose()

    clock = VirtualClock()
    previous = cancellation.wall_clock
    cancellation.wall_clock = clock
    tag = f"{'overlap' if rt.overlap_dispatch else 'lockstep'}-{id(engine):x}"
    dead, alive = f"dead-{tag}", f"live-{tag}"
    leases.note_beat(dead, 5.0)
    leases.note_beat(alive, 30.0)
    await engine.start()
    try:
        t0 = time.perf_counter()
        # overload, deadlines, orphans and a stalled consumer: one burst; the
        # clock passes the deadlines and the dead lease's TTL once request 0
        # decodes
        pace.when(lambda: (r := live("ov-0")) is not None and r.generated >= 2,
                  lambda: clock.advance(6.0))
        hold = asyncio.Event()
        jobs = []
        for i in range(OVERLOAD_REQUESTS):
            kw = dict(priority="batch" if i % 3 == 2 else "interactive")
            if i in OVERLOAD_DEADLINED:
                kw["deadline"] = clock.now + 5.0
            if i in OVERLOAD_DEAD_LEASE:
                kw["lease"] = (dead, 5.0)
            if i in OVERLOAD_LIVE_LEASE:
                kw["lease"] = (alive, 30.0)
            if i == OVERLOAD_STALLED:
                kw["hold"] = hold
            jobs.append(asyncio.ensure_future(run(f"ov-{i}", prompts[i], **kw)))
        others = [j for i, j in enumerate(jobs) if i != OVERLOAD_STALLED]
        await asyncio.gather(*others)
        await _settle(lambda: quiescent(engine), what="the overload burst")
        hold.set()
        await jobs[OVERLOAD_STALLED]
        burst_s = time.perf_counter() - t0
        # the wedge: a landing held past watchdog_stall_s
        gate = threading.Event()
        pace.when(lambda: (r := live("wg-0")) is not None and r.generated >= 2,
                  lambda: pace.block_next_dispatch(gate))
        wedged = asyncio.gather(*[run(f"wg-{k}", prompts[OVERLOAD_REQUESTS + k])
                                  for k in range(3)])
        try:
            await _settle(lambda: pace.blocked, what="the held landing")
            clock.advance(2 * rt.watchdog_stall_s)
            await _settle(lambda: engine._wedged, 30.0, "the watchdog's trip")
            await wedged
            await run("wg-late", prompts[OVERLOAD_REQUESTS + 3])  # refused while wedged
            dumps = sorted(Path(dump_dir).glob("flightrec-*.jsonl"))
        finally:
            clock.advance(0.01)
            gate.set()
        await _settle(lambda: not engine._wedged and quiescent(engine), what="the un-wedge")
        await run("wg-after", prompts[OVERLOAD_REQUESTS + 4])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        await engine.stop()
        cancellation.wall_clock = previous
    return dict(engine=engine, outcomes=outcomes, wall_s=wall, burst_s=burst_s, dumps=dumps,
                sampled=sampled, pool=pool, graphs=graph_numbers(engine))


def check_overload_run(run: dict, rt) -> dict:
    """Every law of one overload run → its counters."""
    from calfkit_tpu_torch.observability import flightrec
    from calfkit_tpu_torch.observability.metrics import metrics_text

    engine, out = run["engine"], run["outcomes"]
    stats = engine.stats
    # every request ends in exactly one typed error or a full stream
    assert len(out) == OVERLOAD_REQUESTS + 5, sorted(out)
    assert all(o[0] != "ok" or len(o[1]) == OVERLOAD_NEW for o in out.values()), out
    kinds = [o[:2] if o[0] != "ok" else ("ok",) for o in out.values()]
    n = {k: kinds.count(v) for k, v in _ENDINGS.items()}
    n["expired"] = sum(1 for o in out.values() if o[0] == "DeadlineExceededError")
    n["orphaned"] = sum(1 for o in out.values() if o[0] == "RunOrphanedError")
    n["wedged"] = sum(1 for o in out.values() if o[0] == "EngineWedgedError")
    # the script's roles: batch sheds first, an interactive submit at a full
    # lane evicts a queued batch request; deadlines, orphans, precedence
    burst = {i: out[f"ov-{i}"] for i in range(OVERLOAD_REQUESTS)}
    shed_batch = [i for i, o in burst.items() if o[:2] == _ENDINGS["shed"] and i % 3 == 2]
    shed_inter = [i for i, o in burst.items() if o[:2] == _ENDINGS["shed"] and i % 3 != 2]
    admitted_inter = [i for i in range(rt.max_pending, OVERLOAD_REQUESTS)
                      if i % 3 != 2 and burst[i][:2] != _ENDINGS["shed"]]
    assert shed_batch == [i for i in range(OVERLOAD_REQUESTS) if i % 3 == 2], shed_batch
    assert admitted_inter and min(shed_inter) > max(admitted_inter), (shed_inter, admitted_inter)
    for i in OVERLOAD_DEADLINED:
        assert burst[i][0] == "DeadlineExceededError", (i, burst[i])
    for i in set(OVERLOAD_DEAD_LEASE) - set(OVERLOAD_DEADLINED):
        assert burst[i][0] == "RunOrphanedError", (i, burst[i])
    assert burst[OVERLOAD_LIVE_LEASE[0]][0] == "ok"
    assert burst[OVERLOAD_STALLED][:2] == _ENDINGS["stalled"], burst[OVERLOAD_STALLED]
    assert [out[f"wg-{k}"][0] for k in range(3)] == ["EngineWedgedError"] * 3, out
    assert out["wg-late"][0] == "EngineWedgedError" and out["wg-after"][0] == "ok"
    assert run["dumps"], "the wedge wrote no flight-recorder dump"
    # each counter equals its endings and the count of its journal event
    assert engine._journal.counts()["dropped"] == 0, engine._journal.counts()
    journal = [(flightrec.EVENT_NAMES[e[2]], e[4], e[5], e[6]) for e in engine._journal.snapshot()]
    events = {name: [e for e in journal if e[0] == name] for name in flightrec.EVENT_NAMES}
    expired_slots = [e[1] for e in events["EXPIRE"]]
    assert min(expired_slots) == -1 < max(expired_slots), expired_slots  # queued and active
    assert stats.shed_requests == n["shed"] == len(events["SHED"]), (n, vars(stats))
    assert stats.expired_requests == n["expired"] == len(events["EXPIRE"]), (n, vars(stats))
    assert stats.orphaned_requests == n["orphaned"] == len(events["ORPHAN"]), (n, vars(stats))
    assert stats.delivery_stalled == n["stalled"] == sum(1 for e in events["CANCEL"] if e[2]), n
    assert stats.watchdog_trips == len(events["WEDGE"]) == 1, vars(stats)
    assert stats.watchdog_faulted == n["wedged"] == events["WEDGE"][0][3] + 1, (n, vars(stats))
    assert stats.interactive_shed == len(shed_inter) and stats.batch_shed == len(shed_batch)
    # the /metrics exposition counts every decode dispatch
    text = metrics_text(engine._own_registry)
    count = next(int(line.split()[-1]) for line in text.splitlines()
                 if line.startswith("calfkit_engine_decode_dispatch_ms_count "))
    assert count == stats.decode_dispatches > 0, (count, stats.decode_dispatches)
    assert stats.prefix_evictions > 0, vars(stats)
    # at every occupancy sample, and after stop(): nothing leaked
    assert run["sampled"] and set(run["sampled"]) == {run["pool"]}, set(run["sampled"])
    assert len(engine._free) == rt.max_batch_size and not engine._active
    free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
    assert free_pages + cached == run["pool"], (free_pages, cached)
    assert engine._ledger.pages_in_use == 0, engine._ledger.breakdown()
    return dict(
        endings=n, shed_batch=len(shed_batch), shed_interactive=len(shed_inter),
        survivors=sum(1 for o in out.values() if o[0] == "ok"),
        decode_dispatches=stats.decode_dispatches, decode_tokens=stats.decode_tokens,
        decode_tok_s=stats.tokens_per_second, prefix_hits=stats.prefix_hits,
        prefix_evictions=stats.prefix_evictions, alloc_stalls=stats.alloc_stalls,
        cancelled=stats.cancelled_requests, journal_events=len(journal),
        samples=len(run["sampled"]), dispatch_ewma_ms=stats.dispatch_ewma_ms,
        wall_s=run["wall_s"], burst_s=run["burst_s"], graphs=run["graphs"],
    )


def tie_gaps(cfg, params, prompt: "list[int]", stream: "list[int]", dev) -> "list[tuple]":
    """Teacher-force ``stream`` after ``prompt`` through one plain forward
    (``model.forward`` with the plain attention, one row) → for each step
    (the top logit - the chosen token's logit, the tie band: two bf16
    spacings at the top logit's magnitude).  The model's logits are bf16:
    a gap inside the band is a tie that the rounding of any earlier sum can
    flip."""
    seq = prompt + stream
    n = len(seq)
    logits, _ = M.forward(
        params, cfg, torch.tensor([seq], dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev)[None],
        M.make_empty_cache(cfg, 1, n, device=dev),
        torch.tensor([n], dtype=torch.int32, device=dev), attn_impl="plain",
    )
    lg = logits[0, len(prompt) - 1:n - 1].float()  # row t predicts stream[t]
    top = lg.max(dim=1).values
    chosen = lg.gather(1, torch.tensor(stream, device=dev)[:, None])[:, 0]
    band = 2.0 * torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(2.0 ** -126))) - 7)
    return list(zip((top - chosen).tolist(), band.tolist()))


# Phase 13's law: a greedy token of a bf16 run lies within this many bf16
# spacings (at its step's top logit's magnitude) of the top logit of the f32
# plain forward.  Set on the card (scripts/torch_agent_mesh.py; PERF.md §6,
# PR 13) between the largest gap of the sound bf16 streams (the engine's,
# and the plain forward's own greedy ones: 2.94 at most) and that of the
# plain forward's own greedy streams with its K/V rounded to 3 mantissa bits
# (3.86).
TIE_SPACINGS = 3


class _F32Rows:
    """A stacked layer leaf read one layer at a time, in f32."""

    def __init__(self, stacked: torch.Tensor):
        self.stacked = stacked

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.stacked[i].float()


def f32_params(params) -> dict:
    """bf16 ``params`` for the f32 plain forward: the embedding, the final
    norm and the head in f32, each layer's leaves cast to f32 when the
    forward reaches that layer (4 GB at llama-3-8b's widths, not a 32 GB
    copy)."""
    return {**{k: v.float() for k, v in params.items() if k != "layers"},
            "layers": {k: _F32Rows(v) for k, v in params["layers"].items()}}


def witness_gaps(cfg, params, prompt: "list[int]", streams: "list[list[int]]",
                 dev) -> "list[list[tuple]]":
    """Each of ``streams``, greedy continuations of ``prompt``, teacher-forced
    through the plain forward in f32 (``model.forward`` with the plain
    attention, one row, ``params`` cast to f32 layer by layer) → per stream,
    per step (the top logit - the chosen token's logit, one bf16 spacing at
    the top logit's magnitude).  The prompt runs once; each stream then runs
    as one chunk on its cache."""
    cfg32, p32 = replace(cfg, dtype="float32"), f32_params(params)
    n = len(prompt)
    cache = M.make_empty_cache(cfg32, 1, n + max(len(s) for s in streams), device=dev)

    def run(tokens: "list[int]", at: int) -> torch.Tensor:
        logits, _ = M.forward(
            p32, cfg32, torch.tensor([tokens], dtype=torch.int32, device=dev),
            torch.arange(at, at + len(tokens), dtype=torch.int32, device=dev)[None], cache,
            torch.tensor([at + len(tokens)], dtype=torch.int32, device=dev), attn_impl="plain")
        return logits[0]

    first = run(prompt, 0)[-1:]  # predicts each stream's first token
    out = []
    for stream in streams:
        lg = torch.cat([first, run(stream[:-1], n)]) if len(stream) > 1 else first[:len(stream)]
        top = lg.max(dim=1).values
        chosen = lg.gather(1, torch.tensor(stream, device=dev, dtype=torch.long)[:, None])[:, 0]
        spacing = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(2.0 ** -126))) - 7)
        out.append(list(zip((top - chosen).tolist(), spacing.tolist())))
    return out


def tie_law(cfg, params, cases, dev, labels=("overlapped", "lockstep")) -> dict:
    """Phase 13's law over ``cases`` of (name, prompt, stream, other), two
    greedy bf16 runs of one prompt: every token of both runs within
    :data:`TIE_SPACINGS` bf16 spacings of its step's top logit in the f32
    plain forward (:func:`witness_gaps`; a wrong K/V page would put a token
    far below it), and the streams equal, or equal up to a step where the
    two runs chose two tokens both within that band.  Gaps are reported in
    spacings."""
    diverged, off_top, max_gap = [], 0, 0.0
    for name, prompt, stream, other in cases:
        both = witness_gaps(cfg, params, prompt, [stream] if other == stream else [stream, other],
                            dev)
        gaps = {labels[0]: [g / s for g, s in both[0]], labels[1]: [g / s for g, s in both[-1]]}
        for run, steps in gaps.items():
            assert all(g <= TIE_SPACINGS for g in steps), (name, run, TIE_SPACINGS, steps)
            off_top += sum(1 for g in steps if g > 0)
            max_gap = max(max_gap, max(steps, default=0.0))
        d = next((i for i, (a, b) in enumerate(zip(stream, other)) if a != b), None)
        if d is not None:
            # the common prefix gives step d the same logits in both forwards
            diverged.append({"corr": name, "step": d, f"gap_{labels[0]}": gaps[labels[0]][d],
                             f"gap_{labels[1]}": gaps[labels[1]][d]})
    return dict(diverged=diverged, tokens_below_top=off_top, max_gap=max_gap,
                band=TIE_SPACINGS)


def check_survivor_streams(cfg, params, prompts, on: dict, off: dict, dev) -> dict:
    """The survivors' greedy streams of the overlapped and the lockstep run
    under :func:`tie_law`."""
    cases = [
        (corr, prompts[OVERLOAD_REQUESTS + 4] if corr == "wg-after" else prompts[int(corr[3:])],
         stream, off[corr][1])
        for corr, (kind, stream) in on.items() if kind == "ok"
    ]
    return dict(survivors=len(cases), **tie_law(cfg, params, cases, dev))


@contextlib.contextmanager
def _last_paged_tables():
    """While the block runs, keep the block tables and kv lengths of the
    paged decode wrapper's last launch at each (B, 1, wpages) (a graph's
    at its replays, :func:`observe_call`)."""
    inner = A.paged_decode_attention
    last: dict = {}
    open_ = [True]

    def keep(q, pool_k, pool_v, layer, tables, lens, **kw):
        key = (q.shape[0], 1, kw["wpages"])

        def record(n, copies):
            last[key] = tuple(copies)

        observe_call(("tables", key), [tables, lens], record, lambda: open_[0])
        return inner(q, pool_k, pool_v, layer, tables, lens, **kw)

    A.paged_decode_attention = keep
    try:
        yield last
    finally:
        open_[0] = False
        A.paged_decode_attention = inner


async def overload_phase(dev, params, card: str = "") -> "tuple[dict, list[dict]]":
    """Phase 13: the robustness layer and its telemetry on the card, at
    llama-3-8b's full width with the pool full.  ``params``: the bf16
    weights an earlier phase built (seed 0).  The runtime
    (``OVERLOAD_RUNTIME``): paged, page 64, chunk 512, prefix cache, 16
    rows, a pool of 257 pages (~2.1 GB), max_pending 16, max_out_blocks 2,
    watchdog 30 s, the occupancy sampler; ``cancellation.wall_clock`` is a
    virtual clock only the script advances; flight-recorder dumps go to a
    temporary ``CALFKIT_FLIGHTREC_DIR``.

    The drive: 48 agent requests submitted at once (a 1,000-token
    instruction block shared by six, a unique tail, 32 new tokens, every
    third batch-class; deadlines, a lease that stops beating, a live lease
    and a consumer that stops reading among them); then a wedge (a landing
    held past the watchdog's threshold, a submit during it, the release and
    a request after it).  It runs overlapped (the main path: #2 and #5
    tallied by shape), overlapped again and then lockstep, and holds every
    law of :func:`check_overload_run` in each, the same endings in all
    three, the repeat's streams bit for bit the first run's, and the
    lockstep survivors' streams equal to the overlapped ones up to a bf16
    tie (:func:`check_survivor_streams`: the two schedules batch the rows
    differently, which moves the rounding of the walk's partial sums and of
    the prefill products).  Then #5 and #2 against their plain versions at
    the phase's most launched shapes, #2 over the phase's own pool after
    eviction, through the block tables of its last launch."""
    import os

    cfg = preset("llama-3-8b")
    rt = OVERLOAD_RUNTIME
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = {}
    with tempfile.TemporaryDirectory() as dump_dir:
        before = os.environ.get("CALFKIT_FLIGHTREC_DIR")
        os.environ["CALFKIT_FLIGHTREC_DIR"] = dump_dir
        try:
            A.reset_launch_counts()
            with prefill_shapes() as prefills, decode_shapes() as decodes, \
                    _last_paged_tables() as tables:
                runs["overlap"] = await overload_drive(cfg, rt, params, dev, dump_dir)
                launches = dict(A.launch_counts)
            peak = torch.cuda.max_memory_allocated(dev)
            runs["repeat"] = await overload_drive(cfg, rt, params, dev, dump_dir)
            runs["lockstep"] = await overload_drive(
                cfg, replace(rt, overlap_dispatch=False), params, dev, dump_dir)
        finally:
            if before is None:
                os.environ.pop("CALFKIT_FLIGHTREC_DIR", None)
            else:
                os.environ["CALFKIT_FLIGHTREC_DIR"] = before
    checked = {name: check_overload_run(r, r["engine"].runtime) for name, r in runs.items()}
    on, off = runs["overlap"]["outcomes"], runs["lockstep"]["outcomes"]
    assert runs["repeat"]["outcomes"] == on, "the repeat's endings or streams changed"
    assert {k: v[:2] if v[0] != "ok" else "ok" for k, v in on.items()} == \
        {k: v[:2] if v[0] != "ok" else "ok" for k, v in off.items()}, (on, off)
    streams = check_survivor_streams(cfg, params, overload_prompts(cfg.vocab_size), on, off, dev)
    assert launches["paged_decode_attention"] > 0 and launches["prefill_attention"] > 0, launches
    assert launches["decode_attention"] == launches["ragged_attention"] == \
        launches["ragged_attention_paged"] == 0, launches
    prefill_rows, decode_rows = _shape_rows(prefills), _shape_rows(decodes)
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
    assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"]
    # the kernels at the phase's shapes: #2 over the overlap run's own pool
    # (pages evicted and reused, ids as the allocator handed them out)
    engine = runs["overlap"]["engine"]
    top = decode_rows[0]
    used, lens = tables[(top["B"], 1, top["window"])]
    cases = [
        path_case(dev, "prefill_attention", prefill_rows),
        paged_decode_case(dev, torch.bfloat16, top["B"], 8, 4, 128, rt.page_size,
                          lens.tolist(), top["window"], 43, 1, torch.bfloat16,
                          f"overload phase, {top['launches']} launches",
                          pool=(engine._k, engine._v, used)),
    ]
    del runs, engine
    result = dict(
        overlap=checked["overlap"], repeat=checked["repeat"], lockstep=checked["lockstep"],
        streams=streams, launches=launches, prefill_shapes=prefill_rows,
        decode_shapes=decode_rows, max_memory_allocated=peak,
    )
    o, s = checked["overlap"], checked["lockstep"]
    print(
        f"  overload llama-3-8b bf16, {OVERLOAD_REQUESTS} agent requests x {OVERLOAD_NEW} "
        f"tokens + the wedge drill, pool {rt.pool_pages()} pages of {rt.page_size} (one run "
        f"each, no spread; {card}): overlapped wall {o['wall_s']:.2f} s (burst "
        f"{o['burst_s']:.2f} s), again {checked['repeat']['wall_s']:.2f} s, lockstep "
        f"{s['wall_s']:.2f} s; endings {o['endings']} (batch shed {o['shed_batch']}, "
        f"interactive shed {o['shed_interactive']}), {o['survivors']} full streams, the "
        f"repeat's bit for bit; against lockstep {len(streams['diverged'])} diverge at a tie "
        f"(gaps in bf16 spacings under the f32 plain forward, band {TIE_SPACINGS}) "
        f"{[(d['corr'], d['step'], round(d['gap_overlapped'], 3), round(d['gap_lockstep'], 3)) for d in streams['diverged']]}"
        f" (tokens below their step's top logit {streams['tokens_below_top']}, largest gap "
        f"{streams['max_gap']:.3f}); lockstep evictions {s['prefix_evictions']}; decode "
        f"{o['decode_tok_s']:.1f} tok/s "
        f"over {o['decode_dispatches']} dispatches (EWMA {o['dispatch_ewma_ms']:.1f} ms), "
        f"prefix hits {o['prefix_hits']}, evictions {o['prefix_evictions']}, alloc stalls "
        f"{o['alloc_stalls']}, journal {o['journal_events']} events, {o['samples']} occupancy "
        f"samples; overlapped {graph_note(o['graphs'], peak)}, lockstep graphs "
        f"{s['graphs']['captures']} captures ({s['graphs']['capture_s']:.2f} s) + "
        f"{s['graphs']['replays']} replays; launches {launches}; prefill (B, Sq, Skv, "
        f"launches) {[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}, "
        f"paged decode (B, wpages, launches) "
        f"{[(r['B'], r['window'], r['launches']) for r in decode_rows]}"
    )
    return result, cases


# --------------------------------------------------------------------------- #
# phase 14: the long-context lane
# --------------------------------------------------------------------------- #

LONG_LENS = (5000, 1500)  # padded to 8,192 and 2,048 positions
LONG_NEW = 64
LONG_EXACT_NEW = 32
LONG_SHORT_NEW = 128
# the exactness runtime: dense, 8B widths; its roomier twin serves the same
# prompts through the short lane
LONG_EXACT_RT = RuntimeConfig(
    max_batch_size=2, max_seq_len=1024, prefill_chunk=128, decode_steps_per_dispatch=8,
    long_context=True,
)
LONG_ROOMY_RT = RuntimeConfig(
    max_batch_size=2, max_seq_len=8192, prefill_chunk=128, decode_steps_per_dispatch=8,
)
# the north star's runtime with the lane on (its own dense prefix of 8,192
# positions beside the paged pool)
LONG_RUNTIME = replace(NORTH_STAR_RUNTIME, long_context=True)


def long_prompts(vocab_size: int, seed: int) -> "list[list[int]]":
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size, n).tolist() for n in LONG_LENS]


def long_landings(new_tokens: "list[int]", steps: int) -> int:
    """The long dispatches the JAX engine's lane lands for requests of
    ``new_tokens`` (the first token comes from the prefill; one landing a
    dispatch of ``steps``; an overlapped follow-up abandoned at a retirement
    does not land)."""
    return sum(-(-(n - 1) // steps) for n in new_tokens)


class LaneEngine(InferenceEngine):
    """The engine with the long lane's clocks, read by phase 14: each long
    prefill's (prompt tokens, start, landing), and each landed long
    dispatch's exclusive wall (what the engine adds to ``decode_time_s``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.long_prefills: list = []
        self.long_walls: list = []

    def _install_long_state(self, request, padded, n, first, started):
        self.long_prefills.append((n, started, time.perf_counter()))
        super()._install_long_state(request, padded, n, first, started)

    def _long_decode_tick(self):
        before, landed = self.stats.decode_time_s, self.stats.long_dispatches
        super()._long_decode_tick()
        if self.stats.long_dispatches > landed:
            self.long_walls.append(self.stats.decode_time_s - before)


class LaneDecodeTally:
    """Phase 14's tally of the dense decode wrapper's launches by (B, 1, W),
    as :func:`_tally` does: the wrapper is installed while the object is
    entered (its engines capture their graphs inside it, so the earlier
    phases' graphs carry no observer of this wrapper), and counts only
    inside :meth:`window`."""

    def __init__(self):
        self.tally: "dict | None" = None
        self._inner = None

    def __enter__(self):
        inner = self._inner = A.decode_attention

        def tallied(q, k_cache, v_cache, lens):
            key = (q.shape[0], 1, k_cache.shape[2])

            def record(n, copies):
                entry = self.tally.setdefault(key, [0, None])
                entry[0] += n
                entry[1] = copies[0]

            observe_call(("decode_attention", key), [lens], record,
                         lambda: self.tally is not None)
            return inner(q, k_cache, v_cache, lens)

        A.decode_attention = tallied
        return self

    def __exit__(self, *exc):
        A.decode_attention = self._inner

    @contextlib.contextmanager
    def window(self):
        self.tally = {}
        try:
            yield self.tally
        finally:
            self.tally = None


async def _timed_stream(engine, prompt, n, arrivals: list) -> "list[int]":
    """A greedy stream, with each token's arrival on the host clock (the
    submit first)."""
    arrivals.append(time.perf_counter())
    out = []
    async for tok in engine.generate(prompt, max_new_tokens=n):
        arrivals.append(time.perf_counter())
        out.append(tok)
    return out


def _gaps_during(arrivals: "list[list[float]]", windows: "list[tuple]") -> float:
    """The longest stretch of a window (start, end) in which a stream, once
    it had its first token, received none: each gap between two token
    arrivals clipped to the window → seconds (0 when none overlaps)."""
    worst = 0.0
    for times in arrivals:
        for a, b in zip(times[1:], times[2:]):  # from the first token on
            for start, end in windows:
                worst = max(worst, min(b, end) - max(a, start))
    return worst


async def _long_exact_streams(cfg, rt, params, dev, prompts) -> "tuple[list, EngineStats]":
    torch.cuda.reset_peak_memory_stats(dev)
    engine = InferenceEngine(cfg, rt, params=params, device=dev)
    await engine.start()
    try:
        streams = (await serve(engine, [(p, LONG_EXACT_NEW, {}) for p in prompts]))[0]
    finally:
        await engine.stop()
    numbers = graph_numbers(engine)
    assert engine._long is None and not engine._long_pending and len(engine._free) == 2
    print(f"    {graph_note(numbers, torch.cuda.max_memory_allocated(dev))}")
    return streams, engine.stats


async def long_exactness(dev) -> dict:
    """Phase 14 (a): a 1,500- and a 5,000-token prompt, 32 new tokens, on
    the f32 exactness model (8B widths, 4 layers) at ``max_seq_len`` 1024:
    the monolithic and the chunked long prefill, each overlapped and
    lockstep; every stream equals the short lane of a roomier engine
    (``max_seq_len`` 8192) and a step-by-step recompute with the plain
    attention, and the lane lands the JAX engine's count of dispatches."""
    cfg = preset("llama-3-8b", n_layers=4, dtype="float32")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(1))
    prompts = long_prompts(cfg.vocab_size, 14)
    roomy, _ = await _long_exact_streams(cfg, LONG_ROOMY_RT, params, dev, prompts)
    landings = long_landings([LONG_EXACT_NEW] * 2, LONG_EXACT_RT.decode_steps_per_dispatch)
    runs = {}
    for name, over in (("monolithic", {}), ("chunked", dict(chunked_prefill=True)),
                       ("monolithic-lockstep", dict(overlap_dispatch=False)),
                       ("chunked-lockstep", dict(chunked_prefill=True, overlap_dispatch=False))):
        streams, st = await _long_exact_streams(
            cfg, replace(LONG_EXACT_RT, **over), params, dev, prompts)
        assert streams == roomy, f"{name}: the long lane's streams differ from the short lane's"
        assert st.long_requests == 2 and st.long_dispatches == landings, vars(st)
        assert st.decode_dispatches == 0, vars(st)
        wasted = 0 if "lockstep" in name else 2 * LONG_EXACT_RT.decode_steps_per_dispatch
        assert st.overlap_wasted_tokens == wasted, vars(st)
        runs[name] = dict(long_requests=st.long_requests, long_dispatches=st.long_dispatches,
                          overlap_wasted_tokens=st.overlap_wasted_tokens)
    _check_recompute(cfg, params, prompts, roomy, dev)
    print(f"  long lane exactness (f32, 8B widths, 4 layers; prompts {list(LONG_LENS)}, "
          f"{LONG_EXACT_NEW} new tokens): monolithic == chunked == short lane (max_seq_len "
          f"8192) == recompute, overlapped and lockstep; {runs}")
    del params
    return dict(runs=runs, landings=landings, streams=roomy)


async def _lane_round(engine, prompts, shorts) -> dict:
    """One round of phase 14 (b)'s drive on a started engine: the short
    requests decode; at the scheduler tick where all of them hold a first
    token, the long prompts arrive → streams and each token's arrival."""
    pace = Pace()
    engine._chaos = pace
    short_arrivals = [[] for _ in shorts]
    long_arrivals = [[] for _ in prompts]
    long_jobs: list = []
    pace.when(
        lambda: len(engine._active) == len(shorts)
        and all(r.generated >= 1 for r in engine._active.values()),
        lambda: long_jobs.extend(
            asyncio.ensure_future(_timed_stream(engine, p, LONG_NEW, arr))
            for p, arr in zip(prompts, long_arrivals)),
    )
    t0 = time.perf_counter()
    short_streams = await asyncio.gather(*[
        _timed_stream(engine, p, n, arr) for (p, n, _), arr in zip(shorts, short_arrivals)
    ])
    await _settle(lambda: len(long_jobs) == len(prompts), what="the long arrivals")
    long_streams = await asyncio.gather(*long_jobs)
    torch.cuda.synchronize()
    return dict(short_streams=short_streams, long_streams=long_streams,
                short_arrivals=short_arrivals, long_arrivals=long_arrivals,
                wall_s=time.perf_counter() - t0)


async def long_drive(cfg, rt, params, dev, prompts, shorts, eager=False, warm=True,
                     count=contextlib.nullcontext) -> dict:
    """Phase 14 (b)'s drive (:func:`_lane_round`) on a fresh engine: a
    warm-up round that captures every graph key of the round (``warm``),
    then the measured round inside ``count()`` → streams, clocks and
    numbers of the measured round, the capture seconds of both."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    with graphs.eager() if eager else contextlib.nullcontext():
        engine = LaneEngine(cfg, rt, params=params, device=dev)
        await engine.start()
        try:
            if warm:
                await _lane_round(engine, prompts, shorts)
            warm_graphs = dict(engine._graphs.stats)
            engine.stats = EngineStats()
            engine.long_prefills.clear()
            engine.long_walls.clear()
            with count():
                r = await _lane_round(engine, prompts, shorts)
        finally:
            await engine.stop()
        numbers = graph_numbers(engine)
    peak = torch.cuda.max_memory_allocated(dev)
    # the no-leak law: every slot free, every page free (no prefix cache)
    assert engine._page_alloc.free_pages == rt.pool_pages() - 1, engine._page_alloc.free_pages
    assert len(engine._free) == rt.max_batch_size and not engine._active
    assert engine._long is None and engine._long_inflight is None and not engine._long_pending
    st = engine.stats
    windows = [(start, end) for _, start, end in engine.long_prefills]
    long_tokens = sum(len(s) - 1 for s in r["long_streams"])
    return dict(
        engine=engine, short_streams=r["short_streams"], long_streams=r["long_streams"],
        wall_s=r["wall_s"],
        ttft_ms=[(arr[1] - arr[0]) * 1e3 for arr in r["long_arrivals"]],
        prefill_s=[end - start for _, start, end in engine.long_prefills],
        prefill_lens=[n for n, _, _ in engine.long_prefills],
        long_decode_tok_s=long_tokens / sum(engine.long_walls),
        mean_long_dispatch_ms=sum(engine.long_walls) / len(engine.long_walls) * 1e3,
        short_gap_during_prefill_ms=_gaps_during(r["short_arrivals"], windows) * 1e3,
        short_gap_max_ms=_gaps_during(r["short_arrivals"], [(0.0, float("inf"))]) * 1e3,
        long_requests=st.long_requests, long_dispatches=st.long_dispatches,
        decode_dispatches=st.decode_dispatches, overlap_wasted_tokens=st.overlap_wasted_tokens,
        scratch_bytes=sum(t.numel() * t.element_size() for t in engine._long_scratch),
        fresh_bytes=sum(t.numel() * t.element_size() for t in engine._long_fresh),
        max_memory_allocated=peak, engine_peak_bytes=peak - base, graphs=numbers,
        warm_graphs=warm_graphs,
        long_graphs=_lane_graphs(engine),
    )


def _lane_graphs(engine) -> dict:
    """The lane's own graphs (``_long_graphs``): keys, calls, captures,
    replays and capture seconds (on the CPU every call runs eagerly)."""
    fns = engine._long_graphs.values()
    captured = [fn for fn in fns if fn.capture_s > 0]
    calls = sum(fn.calls for fn in fns)
    return dict(keys=sorted(map(str, engine._long_graphs)), calls=calls,
                captures=len(captured), replays=calls - len(captured) if captured else 0,
                capture_s=sum(fn.capture_s for fn in captured))


def _lane_note(name: str, r: dict) -> str:
    return (
        f"{name}: long TTFT {[round(x, 1) for x in r['ttft_ms']]} ms, prefill "
        f"{[round(x, 3) for x in r['prefill_s']]} s for {r['prefill_lens']} tokens; long "
        f"decode {r['long_decode_tok_s']:.1f} tok/s, mean long dispatch "
        f"{r['mean_long_dispatch_ms']:.1f} ms over {r['long_dispatches']} dispatches; short "
        f"requests' longest stretch without a token while a long prefill is in flight "
        f"{r['short_gap_during_prefill_ms']:.1f} ms (largest gap over the drive "
        f"{r['short_gap_max_ms']:.1f} ms); wall {r['wall_s']:.2f} s; long scratch "
        f"{r['scratch_bytes'] / 1e9:.3f} GB + fresh cache {r['fresh_bytes'] / 1e9:.3f} GB; "
        f"{graph_note(r['graphs'], r['max_memory_allocated'])} (of them before the measured "
        f"round: {r['warm_graphs']['captures']} captures, {r['warm_graphs']['capture_s']:.2f} "
        f"s); the lane's graphs {r['long_graphs']['keys']}: {r['long_graphs']['calls']} "
        f"calls, {r['long_graphs']['captures']} captures "
        f"({r['long_graphs']['capture_s']:.2f} s), {r['long_graphs']['replays']} replays"
    )


async def long_lane_phase(dev, params, card: str = "") -> "tuple[dict, list[dict]]":
    """Phase 14: the long-context lane (``RuntimeConfig.long_context``) on
    the card.  (a) :func:`long_exactness`.  (b) the full ``llama-3-8b``
    preset in bf16 on ``params`` (the last bf16 north-star drive's weights)
    with the north star's runtime and the lane on: 8 short requests of 64 +
    128 tokens decode when a 5,000- and a 1,500-token prompt (64 new tokens
    each) arrive; chunked (the main path: #1 and #5 counted and tallied by
    shape) and monolithic; the long streams equal a plain bf16 recompute up
    to a tie (:func:`tie_gaps`), no dispatch runs outside a graph, and
    every slot and page is free after ``stop()``.  (c) the chunked drive
    lockstep under ``graphs.eager()`` and on graphs: streams equal bit for
    bit, graph peak at most ``GRAPH_PEAK_LAW`` x eager's.  (d) one agent
    turn through ``TorchLocalModelClient`` on (b)'s chunked engine whose
    rendered conversation is longer than ``max_seq_len``.  (e) #5 on a
    whole 8,192-position prompt (5,000 valid) as the ring passes it and on
    a 128-token chunk at offset 4,992 of the 8,192 scratch, and #1 at B = 1
    over W = 8,192 (5,000 valid), against their plain versions and SDPA."""
    exact = await long_exactness(dev)
    torch.cuda.empty_cache()
    cfg = preset("llama-3-8b")
    rt = LONG_RUNTIME
    prompts = long_prompts(cfg.vocab_size, 15)
    shorts = [(p, LONG_SHORT_NEW, kw) for p, _, kw in north_star_jobs(8)]
    counted: dict = {}

    @contextlib.contextmanager
    def count():
        # the lane's main path: the counts set to 0 just before the measured
        # round of the chunked drive, read just after it
        A.reset_launch_counts()
        with prefill_shapes() as prefills, lane.window() as decodes:
            yield
            counted.update(launches=dict(A.launch_counts), prefills=prefills, decodes=decodes)

    with LaneDecodeTally() as lane:
        chunked = await long_drive(cfg, rt, params, dev, prompts, shorts, count=count)
        monolithic = await long_drive(cfg, replace(rt, chunked_prefill=False), params, dev,
                                      prompts, shorts)
    launches = counted["launches"]
    prefill_rows, decode_rows = _shape_rows(counted["prefills"]), _shape_rows(counted["decodes"])
    assert launches["decode_attention"] > 0 and launches["prefill_attention"] > 0, launches
    assert sum(r["launches"] for r in decode_rows) == launches["decode_attention"], decode_rows
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
    assert (1, 1, 8192) in {(r["B"], r["S"], r["window"]) for r in decode_rows}, decode_rows
    engine = chunked.pop("engine")
    monolithic.pop("engine")
    landings = long_landings([LONG_NEW] * 2, rt.decode_steps_per_dispatch)
    ties = {}
    for name, r in (("chunked", chunked), ("monolithic", monolithic)):
        assert [len(s) for s in r["long_streams"]] == [LONG_NEW] * 2, name
        assert [len(s) for s in r["short_streams"]] == [LONG_SHORT_NEW] * 8, name
        assert r["long_requests"] == 2 and r["long_dispatches"] == landings, (name, r)
        gaps = [tie_gaps(cfg, params, p, s, dev) for p, s in zip(prompts, r["long_streams"])]
        assert all(g <= band for steps in gaps for g, band in steps), (name, gaps)
        ties[name] = dict(tokens_below_top=sum(g > 0 for steps in gaps for g, _ in steps),
                          max_gap=max(g for steps in gaps for g, _ in steps))
        print(f"  long lane llama-3-8b bf16 ({card}; one run, no spread), {_lane_note(name, r)}; "
              f"against a plain recompute every token within a bf16 tie of its step's top "
              f"logit ({ties[name]})")
    print(f"  long lane launches (chunked drive): {launches}; #1 (B, 1, W, launches) "
          f"{[(r['B'], r['window'], r['launches']) for r in decode_rows]}; #5 (B, Sq, Skv, "
          f"launches) {[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}")

    # (c) graphs against eager(), the chunked drive lockstep
    lockstep = replace(rt, overlap_dispatch=False)
    eager = await long_drive(cfg, lockstep, params, dev, prompts, shorts, eager=True, warm=False)
    eager.pop("engine")
    graphed = await long_drive(cfg, lockstep, params, dev, prompts, shorts, warm=False)
    graphed.pop("engine")
    assert graphed["long_streams"] == eager["long_streams"], "long streams: graphs != eager"
    assert graphed["short_streams"] == eager["short_streams"], "short streams: graphs != eager"
    if dev.type == "cuda":  # (a CPU rehearsal runs every body eagerly)
        assert eager["graphs"]["eager"] == eager["graphs"]["calls"] > 0, eager["graphs"]
    ratio = graphed["max_memory_allocated"] / eager["max_memory_allocated"]
    assert ratio <= GRAPH_PEAK_LAW, ratio
    print(f"  long lane graphs vs eager(), chunked lockstep ({card}): streams equal bit for bit; "
          f"max allocated {eager['max_memory_allocated'] / 1e9:.3f} -> "
          f"{graphed['max_memory_allocated'] / 1e9:.3f} GB (x{ratio:.3f}, law <= "
          f"{GRAPH_PEAK_LAW}); eager {_lane_note('eager', eager)}; graphs "
          f"{_lane_note('graphs', graphed)}")

    # (d) one agent turn longer than max_seq_len through the client
    tok = CharTokenizer()
    client = TorchLocalModelClient(engine=engine, tokenizer=tok)
    plans = " ".join(f"Plan a trip to {city}: flights, a hotel and the weather, within a "
                     "budget." for city in AGENT_CITIES[:4])
    messages = [ModelRequest(instructions=AGENT_INSTRUCTIONS, parts=[UserPart(content=plans)])]
    request_params = ModelRequestParameters(tool_defs=AGENT_TOOLS)
    # the client's prompt: BOS and the rendered conversation; longer than
    # max_seq_len, within (b)'s 2,048-position bucket, whose graphs it replays
    rendered = 1 + len(tok.encode(render_messages(messages, request_params)))
    assert rt.max_seq_len <= rendered <= 2048, rendered
    before = engine.stats.long_requests
    try:
        turn = await _client_turn(client, messages, request_params)
    finally:
        await client.stop()
    assert engine.stats.long_requests == before + 1, engine.stats.long_requests
    done = turn["events"][-1]
    assert isinstance(done, ResponseDone) and "first" in turn, turn["events"][-3:]
    assert done.response.usage.input_tokens == rendered, done.response.usage
    assert 0 < done.response.usage.output_tokens <= CLIENT_MAX_TOKENS, done.response.usage
    assert engine._page_alloc.free_pages == rt.pool_pages() - 1
    assert len(engine._free) == rt.max_batch_size and engine._long is None
    client_numbers = dict(rendered_tokens=rendered, ttft_ms=(turn["first"] - turn["submit"]) * 1e3,
                          turn_s=turn["done"] - turn["submit"],
                          output_tokens=done.response.usage.output_tokens,
                          graphs=graph_numbers(engine))
    print(f"  long lane client turn ({card}): a {rendered}-token conversation through "
          f"TorchLocalModelClient served by the lane, TTFT {client_numbers['ttft_ms']:.1f} ms, "
          f"{CLIENT_MAX_TOKENS} tokens in {client_numbers['turn_s']:.2f} s")
    del engine, client

    # (e) the kernels at the lane's shapes
    bf16 = torch.bfloat16
    cases = run_cases(dev, [
        ("prefill_attention", prefill_case,
         (bf16, 1, 8192, 32, 8, 128, 70, 0, 8192, [LONG_LENS[0]], True)),
        ("prefill_attention", prefill_case, (bf16, 1, 128, 32, 8, 128, 71, 4992, 8192)),
        ("decode_attention", decode_case, (bf16, 1, 8, 4, 128, 8192, [LONG_LENS[0]], 72, bf16)),
    ])
    result = dict(
        exactness=exact, chunked={k: v for k, v in chunked.items() if "streams" not in k},
        monolithic={k: v for k, v in monolithic.items() if "streams" not in k},
        graphs=dict(eager={k: v for k, v in eager.items() if "streams" not in k},
                    graphs={k: v for k, v in graphed.items() if "streams" not in k},
                    peak_ratio=ratio),
        client=client_numbers, ties=ties, launches=launches, prefill_shapes=prefill_rows,
        decode_shapes=decode_rows,
    )
    return result, cases


# --------------------------------------------------------------------------- #
# phase 15: the agent mesh (Agent, agent_tool, Worker, Client, InMemoryMesh)
# --------------------------------------------------------------------------- #

MESH_AGENT = "travel_desk"
# the client phase's paged runtime with room for the mesh's turn 2, which
# re-sends turn 1's scripted tool call, the tool's return and the answer
# (~2,300 tokens against the client phase's ~1,700)
MESH_RUNTIME = replace(PAGED_RUNTIME, max_seq_len=4096)
MESH_LANES = 8  # the Worker's max_workers: dispatcher lanes a subscription
MESH_ID_SEED = 0  # the client's ids, so every run puts the conversations on the same lanes
# every dispatcher's lane waits (ms a record sat queued behind its key's lane)
LANE_WAIT = REGISTRY.histogram("calfkit_dispatch_queue_wait_ms")


@contextlib.contextmanager
def seeded_client_ids(seed: int):
    """The client's run, correlation and task ids (``client.caller.new_id``)
    from a seeded generator for the block.  A conversation's task id picks
    its dispatch lane (crc32 % lanes), and the client mints its ids in
    ``execute``'s order, so a fixed seed gives every run the same lanes."""
    rng = random.Random(seed)
    original = caller.new_id
    caller.new_id = lambda: uuid.UUID(int=rng.getrandbits(128), version=4).hex
    try:
        yield
    finally:
        caller.new_id = original


class MeshTurnModel(ModelClient):
    """Phase 15's agent model: the first step of a conversation is scripted
    (the port's ``FunctionModelClient``: a ``get_weather`` call for the
    conversation's city); every later step is the local engine's turn
    through ``local`` (a ``TorchLocalModelClient``), recorded with its
    correlation id, its request and its clocks (call, first ``TextDelta``,
    done)."""

    def __init__(self, local: TorchLocalModelClient):
        self.local = local
        self.scripted = FunctionModelClient(self._first_step, name="travel-desk-script")
        self.calls: "list[dict]" = []
        # the engine-stats advert of an engine-backed agent
        self.stats_snapshot = local.stats_snapshot

    @property
    def model_name(self) -> str:
        return self.local.model_name

    @staticmethod
    def _first_step(messages, params) -> ModelResponse:
        text = messages[-1].parts[-1].content
        city = next(c for c in AGENT_CITIES if c in text)
        return ModelResponse(parts=[ToolCallOutput(
            tool_call_id=f"call_{city}", tool_name="get_weather", args={"city": city})])

    async def request(self, messages, settings=None, params=None):
        async for event in self.request_stream(messages, settings, params):
            if isinstance(event, ResponseDone):
                return event.response
        raise RuntimeError("stream ended without a terminal response")

    def _scripted_first(self, messages) -> bool:
        """Whether this step is a conversation's scripted first step."""
        return not any(isinstance(m, ModelResponse) for m in messages)

    async def request_stream(self, messages, settings=None, params=None):
        if self._scripted_first(messages):
            async for event in self.scripted.request_stream(messages, settings, params):
                yield event
            return
        trace = current_context.get()
        call = dict(corr=trace.trace_id if trace is not None else None, messages=list(messages),
                    settings=settings, params=params, submit=time.perf_counter())
        async for event in self.local.request_stream(messages, settings, params):
            if isinstance(event, TextDelta) and "first" not in call:
                call["first"] = time.perf_counter()
            if isinstance(event, ResponseDone):
                # recorded before the terminal is handed on: the consumer
                # stops iterating at it
                call.update(response=event.response, done=time.perf_counter())
                self.calls.append(call)
            yield event


def _mesh_prompts(round_: str) -> "list[list[str]]":
    """A round's two turns of user text, one per conversation."""
    n = len(AGENT_CITIES)
    return [
        [f"{round_} trip {i}: weather in {city} on 2026-0{i + 1}-1{i}, and a hotel for "
         f"{i + 2} nights?" for i, city in enumerate(AGENT_CITIES)],
        [f"Thanks. Flights from {city} to {AGENT_CITIES[(i + 1) % n]} on 2026-0{i + 1}-2{i}, "
         "within 400 EUR?" for i, city in enumerate(AGENT_CITIES)],
    ]


async def _mesh_round(client, engines, models, prompts, first_token) -> dict:
    """Every conversation's two turns through ``Client.execute``, a turn's
    conversations concurrently; per turn the executes' clocks and results,
    the engine calls (of every model in ``models``), the prefix counters of
    ``engines`` (summed, and each engine's) and the lanes' waits over the
    turn."""
    gateway = client.agent(MESH_AGENT)
    histories: "list[list | None]" = [None] * len(AGENT_CITIES)
    turns = []
    started = time.perf_counter()
    for turn, texts in enumerate(prompts):
        prefix = [(e.stats.prefix_hits, e.stats.prefix_reused_tokens) for e in engines]
        calls_before, waited = [len(m.calls) for m in models], LANE_WAIT.sum

        async def one(i: int, text: str) -> dict:
            t = time.perf_counter()
            result = await gateway.execute(text, message_history=histories[i], timeout=600)
            return dict(start=t, end=time.perf_counter(), result=result)

        runs = await asyncio.gather(*[one(i, text) for i, text in enumerate(texts)])
        for i, run in enumerate(runs):
            result = run["result"]
            assert isinstance(result.output, str) and result.output, (turn, i, result.output)
            histories[i] = result.state.message_history
            run["first_token"] = first_token.get(result.correlation_id)
        per_engine = [(e.stats.prefix_hits - h, e.stats.prefix_reused_tokens - r)
                      for e, (h, r) in zip(engines, prefix)]
        turns.append(dict(
            runs=runs, calls=[c for m, n in zip(models, calls_before) for c in m.calls[n:]],
            lane_wait_ms=LANE_WAIT.sum - waited,
            prefix_hits=sum(h for h, _ in per_engine),
            prefix_reused_tokens=sum(r for _, r in per_engine), per_engine_prefix=per_engine,
        ))
    return dict(turns=turns, started=started, wall_s=time.perf_counter() - started)


def counting(mesh, published: dict) -> None:
    """Count every record ``mesh`` publishes, by topic, into ``published``."""
    publish = mesh.publish

    async def counted(topic, value, *, key=None, headers=None):
        published[topic] = published.get(topic, 0) + 1
        return await publish(topic, value, key=key, headers=headers)

    mesh.publish = counted


def _stream_ids(tok, response) -> "list[int]":
    # every id decodes to one character: the text is the stream
    return tok.encode(response.text())


def _mesh_turn_numbers(turn: dict, lanes: int) -> dict:
    calls = {c["corr"]: c for c in turn["calls"]}
    # the worker's dispatcher serves a key's deliveries on lane
    # crc32(task id) % lanes, one at a time: conversations sharing a lane
    # wait for one another's whole hop (the model turn included); a
    # conversation alone on its lane adds only the codec's and the hops'
    # host time
    lane = [lane_of(partition_key(r["result"].task_id), lanes) for r in turn["runs"]]
    mesh, engine_ttft, added, free, shared = [], [], [], [], []
    for run, at in zip(turn["runs"], lane):
        call = calls[run["result"].correlation_id]
        assert run["first_token"] is not None and "first" in call, "no token step"
        mesh.append((run["first_token"] - run["start"]) * 1e3)
        engine_ttft.append((call["first"] - call["submit"]) * 1e3)
        added.append(mesh[-1] - engine_ttft[-1])
        (free if lane.count(at) == 1 else shared).append(added[-1])
    tokens = sum(c["response"].usage.output_tokens for c in turn["calls"])
    wall = max(r["end"] for r in turn["runs"]) - min(r["start"] for r in turn["runs"])
    execute_ms = sum(r["end"] - r["start"] for r in turn["runs"]) * 1e3
    return dict(
        lanes_occupied=len(set(lane)),
        mesh_ttft_ms=mesh, mesh_ttft_median_ms=statistics.median(mesh),
        mesh_ttft_max_ms=max(mesh), engine_ttft_median_ms=statistics.median(engine_ttft),
        engine_ttft_max_ms=max(engine_ttft), added_ms=added,
        added_median_ms=statistics.median(added), added_max_ms=max(added),
        free_lane_runs=len(free),
        free_lane_added_median_ms=statistics.median(free) if free else None,
        free_lane_added_max_ms=max(free, default=None),
        shared_lane_added_median_ms=statistics.median(shared) if shared else None,
        # the records' lane waits (every dispatcher) over the executes' time
        lane_wait_ms=turn["lane_wait_ms"], lane_wait_share=turn["lane_wait_ms"] / execute_ms,
        output_tokens=tokens, wall_s=wall, tok_s=tokens / wall,
        prefix_hits=turn["prefix_hits"], prefix_reused_tokens=turn["prefix_reused_tokens"],
    )


async def agent_mesh_phase(dev, params, card: str = "") -> dict:
    """Phase 15: the agent mesh on the card.  ``Worker([Agent, 3 tools])`` on
    an ``InMemoryMesh``; the agent's model is :class:`MeshTurnModel` over a
    ``TorchLocalModelClient`` serving the full ``llama-3-8b`` preset in bf16
    on ``params`` (the last bf16 north-star drive's weights) with the
    client phase's paged runtime at ``max_seq_len`` 4096
    (``MESH_RUNTIME``) and :class:`CharTokenizer`, 32 new tokens
    a step, greedy, ``stream_tokens=True``.  The tools are ``@agent_tool``
    functions whose port-derived schemas must equal ``MESH_TOOLS``
    (``AGENT_TOOLS`` with the keys a derived schema adds).  8
    conversations x 2 turns run through ``Client.execute``, a turn's 8
    concurrently: turn 1 is the scripted ``get_weather`` call, the tool's
    hop, and the engine's answer over the history holding its return; turn
    2 re-sends the history.  The client's ids come from a seeded generator
    (:func:`seeded_client_ids`), so every run puts the conversations on the
    same dispatch lanes.  Two warm-up rounds of other text capture the
    graph keys; the measured round follows with every launch count reset.
    Checks: every run ends with a result; turn 2 has prefix hits and more
    reused tokens than turn 1; each of the measured round's 16 engine turns
    and a direct ``request`` on the same messages (a turn's 8 again
    concurrently, after the round) hold phase 13's law (:func:`tie_law`):
    every token of both within the tie band of its step's top logit in
    the f32 plain forward, and the two equal or parting at a step where both
    tokens are within it; #5 and #2 launched in the round; after ``stop()``
    every page is free or cached and every slot free.  Prints the TTFT
    through the mesh (``execute`` to the first token step on the client's
    firehose) and the engine's own (the model client's ``request_stream``
    to its first ``TextDelta``) per turn, the mesh's added ms (apart for
    the conversations alone on their lane: the codec's and the hops' host
    time), the lanes' wait share, tok/s and the records published by
    topic."""
    cfg = preset("llama-3-8b")
    rt = MESH_RUNTIME
    tok = CharTokenizer()
    tools = [agent_tool(fn) for fn in (get_weather, search_flights, book_hotel)]
    derived = [t.schema.tool_def for t in tools]
    assert derived == MESH_TOOLS, [t.model_dump() for t in derived]
    torch.cuda.reset_peak_memory_stats(dev)
    engine = InferenceEngine(cfg, rt, params=params, device=dev)
    local = TorchLocalModelClient(engine=engine, tokenizer=tok, max_new_tokens=CLIENT_MAX_TOKENS)
    model = MeshTurnModel(local)
    agent = Agent(
        MESH_AGENT, model=model, instructions=AGENT_INSTRUCTIONS, tools=tools,
        model_settings=ModelSettings(max_tokens=CLIENT_MAX_TOKENS), stream_tokens=True,
    )
    mesh = InMemoryMesh()
    published: "dict[str, int]" = {}
    counting(mesh, published)
    first_token: "dict[str, float]" = {}
    await local.start()
    try:
        with seeded_client_ids(MESH_ID_SEED):
            async with Worker([agent, *tools], mesh=mesh, max_workers=MESH_LANES):
                client = Client.connect(mesh)
                firehose = client.events()

                async def watch() -> None:
                    async for event in firehose:
                        if event.step.kind == "token":
                            first_token.setdefault(event.correlation_id, time.perf_counter())

                watcher = asyncio.create_task(watch())
                try:
                    # two warm-up rounds: a round's waves (and so its graph
                    # keys) depend on when each conversation reaches the engine
                    for name in ("Warm-up", "Warm-up again"):
                        await _mesh_round(client, [engine], [model], _mesh_prompts(name),
                                          first_token)
                    model.calls.clear()
                    published.clear()
                    engine.stats = EngineStats()
                    graphs_before = graph_numbers(engine)
                    A.reset_launch_counts()
                    with prefill_shapes() as prefills, decode_shapes() as decodes:
                        measured = await _mesh_round(
                            client, [engine], [model], _mesh_prompts("Trip desk"), first_token)
                        launches = dict(A.launch_counts)
                    graphs_after = graph_numbers(engine)
                    records = dict(sorted(published.items()))
                finally:
                    firehose.close()
                    watcher.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await watcher
                    await client.close()
        # a direct request on each engine turn's messages, a turn's 8 at once
        direct = []
        for turn in measured["turns"]:
            direct += await asyncio.gather(*[
                local.request(c["messages"], c["settings"], c["params"]) for c in turn["calls"]])
        fallback = await fallback_step(engine, local, tok, params, dev, card)
    finally:
        await local.stop()
    peak = torch.cuda.max_memory_allocated(dev)
    calls = [c for turn in measured["turns"] for c in turn["calls"]]
    streams = tie_law(cfg, params, [
        (c["corr"], [tok.bos_id, *tok.encode(render_messages(c["messages"], c["params"]))],
         _stream_ids(tok, c["response"]), _stream_ids(tok, d))
        for c, d in zip(calls, direct)
    ], dev, labels=("mesh", "direct"))
    t1, t2 = (_mesh_turn_numbers(t, MESH_LANES) for t in measured["turns"])
    assert t2["prefix_hits"] >= 1 and t2["prefix_reused_tokens"] > t1["prefix_reused_tokens"], \
        (t1["prefix_reused_tokens"], t2["prefix_reused_tokens"])
    assert launches["prefill_attention"] > 0 and launches["paged_decode_attention"] > 0, launches
    prefill_rows, decode_rows = _shape_rows(prefills), _shape_rows(decodes)
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
    assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"]
    # the no-leak law
    free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
    assert free_pages + cached == rt.pool_pages() - 1, (free_pages, cached)
    assert len(engine._free) == rt.max_batch_size and not engine._active
    tokens = t1["output_tokens"] + t2["output_tokens"]
    captures = graphs_after["captures"] - graphs_before["captures"]
    result = dict(
        turn1=t1, turn2=t2, output_tokens=tokens, tok_s=tokens / measured["wall_s"],
        wall_s=measured["wall_s"], records=records, records_total=sum(records.values()),
        launches=launches, prefill_shapes=prefill_rows, decode_shapes=decode_rows,
        engine_turns=len(calls), streams=streams,
        measured_captures=captures, graphs=graphs_after, max_memory_allocated=peak,
        fallback=fallback,
    )

    def lane_note(t: dict) -> str:
        if not t["free_lane_runs"]:
            return "no conversation alone on its lane"
        return (f"{t['free_lane_runs']} alone on their lane, added median "
                f"{t['free_lane_added_median_ms']:.1f} max {t['free_lane_added_max_ms']:.1f}")

    print(
        f"  agent mesh llama-3-8b bf16, Worker([Agent, 3 tools]) on an InMemoryMesh, 8 "
        f"conversations x 2 turns through Client.execute, <= {CLIENT_MAX_TOKENS} tokens an "
        f"engine step (one run, no spread; {card}): TTFT through the mesh (execute -> first "
        f"token step) turn 1 median {t1['mesh_ttft_median_ms']:.1f} ms max "
        f"{t1['mesh_ttft_max_ms']:.1f} ms, turn 2 median {t2['mesh_ttft_median_ms']:.1f} ms "
        f"max {t2['mesh_ttft_max_ms']:.1f} ms; the engine's own (request_stream -> first "
        f"TextDelta) turn 1 median {t1['engine_ttft_median_ms']:.1f} ms max "
        f"{t1['engine_ttft_max_ms']:.1f} ms, turn 2 median {t2['engine_ttft_median_ms']:.1f} "
        f"ms max {t2['engine_ttft_max_ms']:.1f} ms; the mesh's added ms turn 1 median "
        f"{t1['added_median_ms']:.1f} max {t1['added_max_ms']:.1f} (the scripted step and "
        f"the tool's hop included; {lane_note(t1)}), turn 2 median "
        f"{t2['added_median_ms']:.1f} max {t2['added_max_ms']:.1f} ({lane_note(t2)}); the 8 "
        f"conversations' task ids (seed {MESH_ID_SEED}) on {t1['lanes_occupied']} (turn 1) "
        f"and {t2['lanes_occupied']} (turn 2) of the worker's {MESH_LANES} dispatch lanes, "
        f"lane waits {t1['lane_wait_share']:.3f} and {t2['lane_wait_share']:.3f} of the "
        f"executes' time; {tokens} tokens at {result['tok_s']:.1f} tok/s over the "
        f"round's {measured['wall_s']:.2f} s (turn 1 {t1['tok_s']:.1f}, turn 2 "
        f"{t2['tok_s']:.1f}); prefix reuse turn 1 {t1['prefix_hits']} hits "
        f"({t1['prefix_reused_tokens']} tokens), turn 2 {t2['prefix_hits']} "
        f"({t2['prefix_reused_tokens']}); {result['records_total']} records published "
        f"{records}; the {len(calls)} engine turns and their direct requests within "
        f"{TIE_SPACINGS} bf16 spacings of the f32 plain forward's top logit at every token "
        f"({streams['tokens_below_top']} tokens below it, max gap {streams['max_gap']:.3f} "
        f"spacings), "
        f"{len(calls) - len(streams['diverged'])} equal, the rest parting at a tie "
        f"{[(d['step'], round(d['gap_mesh'], 3), round(d['gap_direct'], 3)) for d in streams['diverged']]}"
        f"; launches {launches}; prefill launches by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}, paged decode "
        f"by (B, wpages) {[(r['B'], r['window'], r['launches']) for r in decode_rows]}; "
        f"captures in the measured round {captures}; pages free {free_pages} + cached {cached} "
        f"of {rt.pool_pages() - 1}; {graph_note(graphs_after, peak)}"
    )
    print(fallback["note"])
    return result


# --------------------------------------------------------------------------- #
# phase 15's fallback step: the remote providers over a loopback HTTP server
# --------------------------------------------------------------------------- #

PARACHUTE_TEXT = "The parachute opened: this answer came from the remote API, not the card."
# turn (a)'s text: with the travel desk's instructions and tools its prompt
# falls in the prefill bucket of the measured round's engine turns, whose
# graph keys the warm engine holds
PARACHUTE_TURN = (
    "Fallback trip: weather in Lisbon on 2026-05-14, and a hotel for 3 nights? We land at "
    "noon, travel with two children and one bag each, and would like a quiet room away from "
    "the lifts. Breakfast should be included, the budget is 180 EUR a night, and we would "
    "rather walk than take taxis, so somewhere central near a tram stop is best. If rain "
    "is likely, suggest one museum for the afternoon; if it is sunny, suggest a viewpoint "
    "and a place for dinner that opens early."
)
# longer than MESH_RUNTIME's max_seq_len in CharTokenizer's ids (one a character)
PARACHUTE_PROMPT = "Plan every leg of this trip, one day at a time: " + " ".join(
    f"day {i}: {city} to {AGENT_CITIES[(i + 1) % len(AGENT_CITIES)]}, a hotel for 2 nights;"
    for i, city in enumerate(AGENT_CITIES * 12))


class Parachute:
    """The fallback step's remote API: an OpenAI-compatible chat-completions
    endpoint on a loopback port, inside this script.  A path under
    ``/down/`` answers 503; any other streams :data:`PARACHUTE_TEXT` as
    server-sent events, a word a chunk.  ``requests`` records each
    request's path."""

    def __init__(self):
        self.requests: "list[str]" = []

    async def _serve(self, reader, writer) -> None:
        try:
            head = []
            while line := (await reader.readline()).decode("latin-1").rstrip("\r\n"):
                head.append(line)
            length = next((int(h.split(":", 1)[1]) for h in head
                           if h.lower().startswith("content-length:")), 0)
            await reader.readexactly(length)
            path = head[0].split(" ")[1]
            self.requests.append(path)
            if path.startswith("/down/"):
                writer.write(b"HTTP/1.1 503 Service Unavailable\r\nContent-Type: text/plain\r\n"
                             b"Content-Length: 11\r\n\r\noverloaded.")
            else:
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Type: text/event-stream\r\n"
                             b"Transfer-Encoding: chunked\r\n\r\n")
                words = PARACHUTE_TEXT.split(" ")
                events = [{"model": "parachute", "choices": [{"delta": {"content": w}}]}
                          for w in [words[0], *(" " + w for w in words[1:])]]
                events.append({"choices": [{"finish_reason": "stop", "delta": {}}],
                               "usage": {"prompt_tokens": 0, "completion_tokens": len(words)}})
                for data in [*map(json.dumps, events), "[DONE]"]:
                    chunk = f"data: {data}\n\n".encode()
                    writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                    await writer.drain()
                writer.write(b"0\r\n\r\n")
            await writer.drain()
        finally:
            writer.close()

    async def __aenter__(self) -> "Parachute":
        self.server = await asyncio.start_server(self._serve, "127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.server.sockets[0].getsockname()[1]}"
        return self

    async def __aexit__(self, *exc) -> None:
        self.server.close()
        await self.server.wait_closed()


class FallbackTurnModel(MeshTurnModel):
    """The fallback step's agent model: every step goes to ``model`` (a
    ``FallbackModelClient``), recorded as :class:`MeshTurnModel` records
    the engine's turns; the engine-stats advert is ``local``'s."""

    def __init__(self, model: ModelClient, local: TorchLocalModelClient):
        super().__init__(local)
        self.local = model

    def _scripted_first(self, messages) -> bool:
        return False


async def fallback_step(engine, local, tok, params, dev, card: str = "") -> dict:
    """Phase 15's fallback step, on the phase's warm engine and weights:
    :class:`Parachute` on a loopback port, and two agents on a fresh
    ``InMemoryMesh`` with the travel desk's instructions and tools, each
    one turn through ``Client.execute``:

    (a) remote first: ``FallbackModelClient(OpenAIModelClient(<loopback
        /down/, answering 503>), local)``; the card serves the turn, the
        loopback saw exactly one request, #5 and #2 launched, and the
        turn's tokens and a direct ``local.request`` on the same messages
        hold phase 13's law (:func:`tie_law`);
    (b) local first: ``FallbackModelClient(local, OpenAIModelClient(
        <loopback, streaming PARACHUTE_TEXT>), fallback_on=(InferenceError,
        ModelAPIError))`` on a prompt longer than ``max_seq_len`` (the long
        lane is off): the engine refuses it, the turn's text is the
        script, the loopback saw one request, and the engine admitted
        nothing (its prefill tokens, free pages and free slots as before).

    The step's two turns add no graph key and capture nothing, and the engine is
    quiescent after each.  Returns both turns' TTFT (the fallback client's
    ``request_stream`` call to its first ``TextDelta``) and execute times,
    the loopback's request paths, the launches, the law's result, the
    step's seconds and a line (``note``) that the phase prints."""
    started = time.perf_counter()
    cfg, rt = engine.config, engine.runtime
    settings = ModelSettings(max_tokens=CLIENT_MAX_TOKENS)
    async with Parachute() as parachute:
        down = OpenAIModelClient("parachute", api_key="loopback", base_url=f"{parachute.url}/down/v1")
        up = OpenAIModelClient("parachute", api_key="loopback", base_url=f"{parachute.url}/v1")
        first = FallbackTurnModel(FallbackModelClient(down, local), local)
        second = FallbackTurnModel(
            FallbackModelClient(local, up, fallback_on=(InferenceError, ModelAPIError)), local)
        tools = [agent_tool(fn) for fn in (get_weather, search_flights, book_hotel)]
        agents = [Agent(name, model=model, instructions=AGENT_INSTRUCTIONS, tools=tools,
                        model_settings=settings, stream_tokens=True)
                  for name, model in (("parachute_remote_first", first),
                                      ("parachute_local_first", second))]
        graphs_before, launched = graph_numbers(engine), dict(A.launch_counts)
        mesh = InMemoryMesh()
        turns = {}
        try:
            async with Worker([*agents, *tools], mesh=mesh, max_workers=2):
                client = Client.connect(mesh)
                try:
                    for label, agent, text in (
                        ("remote_first", agents[0], PARACHUTE_TURN),
                        ("local_first", agents[1], PARACHUTE_PROMPT),
                    ):
                        before = (engine.stats.prefill_tokens, engine._page_alloc.free_pages,
                                  len(engine._free), len(parachute.requests))
                        t = time.perf_counter()
                        result = await client.agent(agent.name).execute(text, timeout=120)
                        call = agent.model.calls[-1]
                        await _settle(lambda: quiescent(engine), 30, f"the {label} turn")
                        turns[label] = dict(
                            output=result.output, call=call, before=before,
                            execute_ms=(time.perf_counter() - t) * 1e3,
                            ttft_ms=(call["first"] - call["submit"]) * 1e3,
                            after=(engine.stats.prefill_tokens, engine._page_alloc.free_pages,
                                   len(engine._free), len(parachute.requests)),
                        )
                finally:
                    await client.close()
            graphs_after = graph_numbers(engine)
            new_keys = graphs_after["keys"] - graphs_before["keys"]
            captures = graphs_after["captures"] - graphs_before["captures"]
            launches = {k: v - launched.get(k, 0) for k, v in A.launch_counts.items()}
            a = turns["remote_first"]["call"]
            direct = await local.request(a["messages"], a["settings"], a["params"])
        finally:
            await down.aclose()
            await up.aclose()
    remote_first, local_first = turns["remote_first"], turns["local_first"]
    law = tie_law(cfg, params, [(
        a["corr"], [tok.bos_id, *tok.encode(render_messages(a["messages"], a["params"]))],
        _stream_ids(tok, a["response"]), _stream_ids(tok, direct))], dev, labels=("mesh", "direct"))
    # (a): one request to the loopback (answered 503), then the card's turn
    assert parachute.requests[0].startswith("/down/"), parachute.requests
    assert remote_first["after"][3] - remote_first["before"][3] == 1, parachute.requests
    assert remote_first["after"][0] > remote_first["before"][0], "the card served no prefill"
    assert a["response"].usage.output_tokens > 0 and remote_first["output"]
    assert launches["prefill_attention"] > 0 and launches["paged_decode_attention"] > 0, launches
    # (b): the engine refused the prompt, the loopback's script is the answer
    b = local_first["call"]["response"]
    assert len(tok.encode(PARACHUTE_PROMPT)) > rt.max_seq_len and not rt.long_context
    assert local_first["output"] == b.text() == PARACHUTE_TEXT, local_first["output"]
    assert local_first["after"][3] - local_first["before"][3] == 1, parachute.requests
    assert parachute.requests[1] == "/v1/chat/completions", parachute.requests
    assert local_first["after"][:3] == local_first["before"][:3], (
        local_first["before"], local_first["after"])
    assert len(engine._free) == rt.max_batch_size and not engine._active
    assert new_keys == captures == 0, f"the fallback step added {new_keys} graph keys"
    out = dict(
        remote_first_ttft_ms=remote_first["ttft_ms"], remote_first_execute_ms=remote_first[
            "execute_ms"], local_first_ttft_ms=local_first["ttft_ms"],
        local_first_execute_ms=local_first["execute_ms"], loopback_requests=parachute.requests,
        remote_first_tokens=a["response"].usage.output_tokens, launches=launches,
        new_graph_keys=new_keys, captures=captures, law=law, prompt_tokens=len(tok.encode(PARACHUTE_PROMPT)),
        seconds=time.perf_counter() - started,
    )
    out["note"] = (
        f"  fallback step on phase 15's engine ({card}): (a) remote first: the loopback's "
        f"503 to {remote_first['after'][3] - remote_first['before'][3]} request, then the card "
        f"served the turn: TTFT (the fallback client's request_stream -> first TextDelta, "
        f"the 503's round trip included) {out['remote_first_ttft_ms']:.1f} ms, execute "
        f"{out['remote_first_execute_ms']:.1f} ms, {out['remote_first_tokens']} tokens, "
        f"launches {launches}, the turn and its direct request within {TIE_SPACINGS} bf16 "
        f"spacings of the f32 plain forward's top logit (max gap {law['max_gap']:.3f}, "
        f"{'equal' if not law['diverged'] else 'parting at a tie'}); (b) local first, a "
        f"{out['prompt_tokens']}-token prompt past max_seq_len {rt.max_seq_len}: refused by "
        f"the engine, answered by the loopback's stream: TTFT "
        f"{out['local_first_ttft_ms']:.1f} ms, execute {out['local_first_execute_ms']:.1f} ms, "
        f"text == the script, no page or slot taken; loopback requests "
        f"{len(parachute.requests)} {parachute.requests}; new graph keys {new_keys}, "
        f"captures {captures}; "
        f"step {out['seconds']:.2f} s"
    )
    return out


# --------------------------------------------------------------------------- #
# phase 16: the agent mesh over the wire transports
# --------------------------------------------------------------------------- #

# two warm-up rounds, then the measured round: a round's waves, and so its
# graph keys, depend on when each conversation reaches the engine; after one
# warm-up round the first card call still captured 3 keys in the measured
# round over kafka://
WIRE_ROUNDS = ("Warm-up", "Warm-up again", "Trip desk")
WIRE_TRANSPORTS = ("kafka", "tcp")
KAFKA_TOPIC_EXISTS = 36  # CreateTopics' TOPIC_ALREADY_EXISTS
# the two processes' clocks: time.perf_counter is CLOCK_MONOTONIC on Linux,
# one clock for every process of the machine, so the client process's
# readings and the worker's subtract


def _say(event: dict) -> None:
    sys.stdout.write(json.dumps(event) + "\n")
    sys.stdout.flush()


def wire_crc() -> str:
    """The name of the CRC function the Kafka wire client loaded:
    ``_crc32c_native`` (the native library) or ``_crc32c_py`` (the
    pure-Python fallback)."""
    from calfkit_tpu_torch.mesh import kafka_wire

    return kafka_wire.crc32c.__name__


def timed_subscribes(mesh, joins: list) -> None:
    """Record (group, seconds) of every ``mesh.subscribe`` (group ``None``: a
    broadcast tap): over ``kafka://`` it returns at the consumer's first
    assignment, over ``tcp://`` when meshd has answered every SUB (meshd
    assigns the group's partitions as it answers)."""
    subscribe = mesh.subscribe

    async def timed(topics, handler, **kw):
        t = time.perf_counter()
        sub = await subscribe(topics, handler, **kw)
        joins.append((kw.get("group_id"), time.perf_counter() - t))
        return sub

    mesh.subscribe = timed


async def wire_client(url: str) -> int:
    """``chip_smoke.py --wire-client URL``: phase 16's ``Client``, in a process
    of its own that starts no CUDA context, on its own connection to the
    broker at ``url``.  It runs :data:`WIRE_ROUNDS`, each phase 15's 8
    conversations x 2 turns (a turn's 8 ``execute`` calls at once), with
    the ids of :func:`seeded_client_ids`.  Before each turn it prints a
    ``turn`` line and waits for ``go`` on its standard input, so the worker's
    process can read its counters at the turn's edges; after each turn it
    prints the turn's runs (clocks, ids, output), the lane waits of its own
    dispatchers and the records it published by topic; at the end, the CRC
    its wire client loaded and its subscriptions' seconds to their first
    assignment.  One JSON object a line on standard output."""
    from calfkit_tpu_torch.mesh.urls import mesh_from_url

    mesh = mesh_from_url(url)
    published: "dict[str, int]" = {}
    joins: list = []
    first_token: "dict[str, float]" = {}
    counting(mesh, published)
    timed_subscribes(mesh, joins)
    loop = asyncio.get_running_loop()
    with seeded_client_ids(MESH_ID_SEED):
        client = Client.connect(mesh)
        firehose = client.events()

        async def watch() -> None:
            async for event in firehose:
                if event.step.kind == "token":
                    first_token.setdefault(event.correlation_id, time.perf_counter())

        watcher = asyncio.create_task(watch())
        gateway = client.agent(MESH_AGENT)
        try:
            for round_ in WIRE_ROUNDS:
                histories: "list[list | None]" = [None] * len(AGENT_CITIES)
                for turn, texts in enumerate(_mesh_prompts(round_)):
                    _say({"event": "turn", "round": round_, "turn": turn})
                    go = await loop.run_in_executor(None, sys.stdin.readline)
                    if go.strip() != "go":
                        raise RuntimeError(f"wire client: expected go, got {go!r}")
                    published.clear()
                    waited = LANE_WAIT.sum

                    async def one(i: int, text: str):
                        t = time.perf_counter()
                        result = await gateway.execute(
                            text, message_history=histories[i], timeout=600)
                        return t, time.perf_counter(), result

                    done = await asyncio.gather(*[one(i, t) for i, t in enumerate(texts)])
                    # the token steps precede the terminal on the mesh, but
                    # the firehose is another subscription: let it catch up
                    for _ in range(500):
                        if all(r.correlation_id in first_token for _, _, r in done):
                            break
                        await asyncio.sleep(0.01)
                    runs = []
                    for i, (start, end, result) in enumerate(done):
                        assert isinstance(result.output, str) and result.output, (turn, i)
                        histories[i] = result.state.message_history
                        runs.append(dict(
                            start=start, end=end,
                            first_token=first_token.get(result.correlation_id),
                            correlation_id=result.correlation_id, task_id=result.task_id,
                            output=result.output))
                    _say({"event": "done", "round": round_, "turn": turn, "runs": runs,
                          "lane_wait_ms": LANE_WAIT.sum - waited, "records": dict(published)})
        finally:
            firehose.close()
            watcher.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await watcher
            await client.close()
            await mesh.stop()
    _say({"event": "end", "crc": wire_crc() if url.startswith("kafka") else None,
          "joins": joins})
    return 0


async def second_boot(transport: str, address: str) -> dict:
    """A second ``Worker`` of phase 15's nodes (its model a scripted one)
    booting through ``provision()`` on the broker where the first provisioned
    every topic it needs, on a plain ``KafkaWireMesh`` or ``TcpMesh``.  The
    topics it ensures are recorded; over ``kafka://`` so are the broker's
    CreateTopics answers (its producer's ``create_topics`` wrapped, its
    answers passed on as they are) and every call of the provisioner's
    classifier.  The wire mesh's ``ensure_topics`` drops the broker's
    per-topic answers, so TOPIC_ALREADY_EXISTS raises nothing and the
    classifier is not reached; meshd's ENSURE answers OK whether a topic
    exists or not."""
    from calfkit_tpu_torch.mesh import KafkaWireMesh, TcpMesh
    from calfkit_tpu_torch.provisioning import (
        ProvisioningConfig,
        framework_topics_for_nodes,
        provisioner,
        topics_for_nodes,
    )

    mesh = KafkaWireMesh(address) if transport == "kafka" else TcpMesh(address)
    ensured: "list[str]" = []
    codes: "dict[str, int]" = {}
    ensure = mesh.ensure_topics

    async def recorded(names, *, compacted=False):
        ensured.extend(names)
        producer = getattr(mesh, "_producer", None)  # made by the mesh's start()
        if producer is not None and "create_topics" not in vars(producer):
            create = producer.create_topics

            async def answered(topics, partitions, *, compacted=False):
                out = await create(topics, partitions, compacted=compacted)
                for name, code in out.items():
                    codes.setdefault(name, code)  # each topic's first answer
                return out

            producer.create_topics = answered
        return await ensure(names, compacted=compacted)

    mesh.ensure_topics = recorded
    classified: "list[str]" = []
    classify = provisioner.classify_topic_error

    def recording(exc):
        classified.append(classify(exc))
        return classified[-1]

    tools = [agent_tool(fn) for fn in (get_weather, search_flights, book_hotel)]
    nodes = [Agent(MESH_AGENT, model=FunctionModelClient(MeshTurnModel._first_step),
                   instructions=AGENT_INSTRUCTIONS, tools=tools), *tools]
    provisioner.classify_topic_error = recording
    try:
        async with Worker(nodes, mesh=mesh, owns_transport=True,
                          provisioning=ProvisioningConfig()):
            pass
    finally:
        provisioner.classify_topic_error = classify
    expected = set(topics_for_nodes(nodes)) | set(framework_topics_for_nodes(nodes))
    return dict(ensured=sorted(set(ensured)), classified=classified, codes=codes,
                expected=sorted(expected))


async def wire_mesh_phase(dev, params, transport: str, in_memory: "dict | None",
                          card: str = "") -> dict:
    """Phase 16: phase 15's agent served over a wire transport, driven from
    another process.  ``transport`` is ``kafka`` (``kafkad`` on port 0, the
    port's ``KafkaWireMesh``) or ``tcp`` (``meshd`` on port 0, ``TcpMesh``);
    the brokers are the ones :func:`calfkit_tpu_torch.mesh._native.build_native`
    built.  The worker's process holds the engine: ``Worker([Agent, 3
    tools], provisioning=ProvisioningConfig())`` on the transport, the agent's
    model :class:`MeshTurnModel` over a ``TorchLocalModelClient`` serving the
    full ``llama-3-8b`` preset in bf16 on ``params`` with ``MESH_RUNTIME`` and
    :class:`CharTokenizer`, ``stream_tokens=True``, as phase 15.  The
    ``Client`` runs in a child process (:func:`wire_client`, no CUDA
    context): two warm-up rounds, then the measured round, each 8
    conversations x 2 turns, the client's ids seeded.  Launch counts are
    reset at the measured round's first turn and read after its last.
    Checks: the wire client uses the native CRC (in both processes, over
    ``kafka://``); the topics the worker provisioned equal
    ``topics_for_nodes`` ∪ ``framework_topics_for_nodes``, and over
    ``kafka://`` the broker holds them after the boot (it also holds the
    ones it created when a metadata request named them: printed); every run
    ends with a result; turn 2 reuses more prefix tokens than turn 1; #5 and
    #2 launch; after ``stop()`` every page is free or cached; a second
    worker booting on the same broker (:func:`second_boot`) succeeds (over
    ``kafka://``: the broker answers TOPIC_ALREADY_EXISTS for every topic,
    and the classifier is not reached).  Prints per turn TTFT through the mesh
    (the client's ``execute`` to the first token step on its firehose) and
    the engine's own, the added ms and its excess over phase 15's
    (``in_memory``, its result, when given), apart for conversations alone on their lane; the
    lanes' wait share (both processes' dispatchers); tok/s; records by
    topic; the worker's boot seconds and its subscriptions' seconds to their
    first assignment.  Last, after those numbers are printed: every token of
    the 16 engine turns and of a direct ``request`` on the same messages
    lies within the tie band of the f32 plain forward's top logit
    (:func:`tie_law`, phase 13's law)."""
    from calfkit_tpu_torch.mesh import KafkaWireMesh, TcpMesh
    from calfkit_tpu_torch.mesh.kafka_wire import spawn_kafkad
    from calfkit_tpu_torch.mesh.tcp import spawn_meshd
    from calfkit_tpu_torch.provisioning import (
        ProvisioningConfig,
        framework_topics_for_nodes,
        topics_for_nodes,
    )

    cfg = preset("llama-3-8b")
    rt = MESH_RUNTIME
    tok = CharTokenizer()
    tools = [agent_tool(fn) for fn in (get_weather, search_flights, book_hotel)]
    assert [t.schema.tool_def for t in tools] == MESH_TOOLS
    crc = None
    if transport == "kafka":
        crc = wire_crc()
        assert crc == "_crc32c_native", f"the wire client loaded the pure-Python CRC ({crc})"
    broker = spawn_kafkad(0) if transport == "kafka" else spawn_meshd(0)
    address = f"127.0.0.1:{broker.kafkad_port if transport == 'kafka' else broker.meshd_port}"
    child = None
    torch.cuda.reset_peak_memory_stats(dev)
    engine = InferenceEngine(cfg, rt, params=params, device=dev)
    local = TorchLocalModelClient(engine=engine, tokenizer=tok, max_new_tokens=CLIENT_MAX_TOKENS)
    model = MeshTurnModel(local)
    agent = Agent(
        MESH_AGENT, model=model, instructions=AGENT_INSTRUCTIONS, tools=tools,
        model_settings=ModelSettings(max_tokens=CLIENT_MAX_TOKENS), stream_tokens=True,
    )
    nodes = [agent, *tools]
    expected = set(topics_for_nodes(nodes)) | set(framework_topics_for_nodes(nodes))
    mesh = KafkaWireMesh(address) if transport == "kafka" else TcpMesh(address)
    published: "dict[str, int]" = {}
    joins: list = []
    ensured: "list[str]" = []
    counting(mesh, published)
    timed_subscribes(mesh, joins)
    ensure = mesh.ensure_topics

    async def recorded(names, *, compacted=False):
        ensured.extend(names)
        return await ensure(names, compacted=compacted)

    mesh.ensure_topics = recorded
    measured_round = WIRE_ROUNDS[-1]
    turns: "dict[str, list]" = {r: [] for r in WIRE_ROUNDS}
    await local.start()
    try:
        worker = Worker(nodes, mesh=mesh, max_workers=MESH_LANES, owns_transport=True,
                        provisioning=ProvisioningConfig())
        t = time.perf_counter()
        await worker.start()
        boot_s = time.perf_counter() - t
        try:
            assert set(ensured) == expected, sorted(set(ensured) ^ expected)
            on_broker = None
            if transport == "kafka":
                # the broker also holds the topics kafkad created when a
                # metadata request named them (the runs feed and the SLO
                # adverts, which no provisioner lists)
                on_broker = set((await mesh._producer.metadata(None))["topics"])
                assert on_broker >= expected, sorted(expected - on_broker)
            child = await asyncio.create_subprocess_exec(
                sys.executable, str(Path(__file__).resolve()), "--wire-client",
                f"{transport}://{address}", stdin=asyncio.subprocess.PIPE,
                stdout=asyncio.subprocess.PIPE, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
            )
            with contextlib.ExitStack() as tallies:
                while True:
                    line = await asyncio.wait_for(child.stdout.readline(), timeout=600)
                    assert line, "the client process ended before its last report"
                    event = json.loads(line)
                    if event["event"] == "end":
                        end = event
                        break
                    if event["event"] == "turn":
                        if event["round"] == measured_round and event["turn"] == 0:
                            model.calls.clear()
                            published.clear()
                            engine.stats = EngineStats()
                            graphs_before = graph_numbers(engine)
                            A.reset_launch_counts()
                            prefills = tallies.enter_context(prefill_shapes())
                            decodes = tallies.enter_context(decode_shapes())
                            measured_start = time.perf_counter()
                        mark = dict(calls=len(model.calls), hits=engine.stats.prefix_hits,
                                    reused=engine.stats.prefix_reused_tokens, waited=LANE_WAIT.sum)
                        child.stdin.write(b"go\n")
                        await child.stdin.drain()
                        continue
                    runs = [dict(start=r["start"], end=r["end"], first_token=r["first_token"],
                                 result=SimpleNamespace(task_id=r["task_id"],
                                                        correlation_id=r["correlation_id"]))
                            for r in event["runs"]]
                    turns[event["round"]].append(dict(
                        runs=runs, calls=model.calls[mark["calls"]:],
                        lane_wait_ms=LANE_WAIT.sum - mark["waited"] + event["lane_wait_ms"],
                        prefix_hits=engine.stats.prefix_hits - mark["hits"],
                        prefix_reused_tokens=engine.stats.prefix_reused_tokens - mark["reused"],
                        client_records=event["records"],
                    ))
                    if event["round"] == measured_round and len(turns[measured_round]) == 2:
                        launches = dict(A.launch_counts)
                        measured_wall = time.perf_counter() - measured_start
                        graphs_after = graph_numbers(engine)
                        worker_records = dict(published)
            assert await asyncio.wait_for(child.wait(), timeout=60) == 0, child.returncode
        finally:
            await worker.stop()
        again = await second_boot(transport, address)
        measured = turns[measured_round]
        # a direct request on each engine turn's messages, a turn's 8 at once
        direct = []
        for turn in measured:
            direct += await asyncio.gather(*[
                local.request(c["messages"], c["settings"], c["params"]) for c in turn["calls"]])
    finally:
        if child is not None and child.returncode is None:
            child.kill()
            await child.wait()
        await local.stop()
        broker.terminate()
        broker.wait(timeout=10)
    peak = torch.cuda.max_memory_allocated(dev)
    if transport == "kafka":
        assert end["crc"] == "_crc32c_native", f"the client process's CRC: {end['crc']}"
        # the second boot succeeded; the broker answered TOPIC_ALREADY_EXISTS
        # for every topic it asked for, all of which the first worker
        # provisioned, and the wire mesh took those answers without raising
        assert set(again["expected"]) <= expected, sorted(set(again["expected"]) - expected)
        assert again["codes"] == {n: KAFKA_TOPIC_EXISTS for n in again["expected"]}, again["codes"]
        assert not again["classified"], again["classified"]
    assert set(again["ensured"]) == set(again["expected"]), again["ensured"]
    calls = [c for turn in measured for c in turn["calls"]]
    t1, t2 = (_mesh_turn_numbers(t, MESH_LANES) for t in measured)
    assert len(calls) == 2 * len(AGENT_CITIES), len(calls)
    assert t2["prefix_hits"] >= 1 and t2["prefix_reused_tokens"] > t1["prefix_reused_tokens"], \
        (t1["prefix_reused_tokens"], t2["prefix_reused_tokens"])
    assert launches["prefill_attention"] > 0 and launches["paged_decode_attention"] > 0, launches
    prefill_rows, decode_rows = _shape_rows(prefills), _shape_rows(decodes)
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
    assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"]
    free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
    assert free_pages + cached == rt.pool_pages() - 1, (free_pages, cached)
    assert len(engine._free) == rt.max_batch_size and not engine._active
    records = dict(worker_records)
    for turn in measured:
        for topic, n in turn["client_records"].items():
            records[topic] = records.get(topic, 0) + n
    records = dict(sorted(records.items()))
    tokens = t1["output_tokens"] + t2["output_tokens"]
    worker_joins = [s for group, s in joins if group]
    over = {}
    for name, t in (("turn1", t1), ("turn2", t2)):
        base = (in_memory or {}).get(name, dict(added_median_ms=math.nan,
                                                free_lane_added_median_ms=None))
        over[name] = dict(
            added_median_ms=t["added_median_ms"] - base["added_median_ms"],
            free_lane_added_median_ms=(
                t["free_lane_added_median_ms"] - base["free_lane_added_median_ms"]
                if t["free_lane_added_median_ms"] is not None
                and base["free_lane_added_median_ms"] is not None else None),
        )
    result = dict(
        transport=transport, turn1=t1, turn2=t2, over_in_memory=over, output_tokens=tokens,
        tok_s=tokens / measured_wall, wall_s=measured_wall, records=records,
        records_total=sum(records.values()), launches=launches, prefill_shapes=prefill_rows,
        decode_shapes=decode_rows, engine_turns=len(calls), boot_s=boot_s,
        worker_joins=joins, client_joins=end["joins"],
        first_assignment_s=max(worker_joins), crc=crc, topics=sorted(expected),
        broker_topics=sorted(on_broker) if on_broker is not None else None,
        second_boot=again, measured_captures=graphs_after["captures"] - graphs_before["captures"],
        graphs=graphs_after, max_memory_allocated=peak,
    )

    def ms(x) -> str:
        return "n/a" if x is None else f"{x:.1f}"

    def turn_note(name: str, t: dict) -> str:
        o = over[name]
        return (f"{name}: TTFT through the mesh median {t['mesh_ttft_median_ms']:.1f} ms max "
                f"{t['mesh_ttft_max_ms']:.1f} ms, the engine's own median "
                f"{t['engine_ttft_median_ms']:.1f} ms max {t['engine_ttft_max_ms']:.1f} ms, "
                f"added median {t['added_median_ms']:.1f} max {t['added_max_ms']:.1f} ms "
                f"({ms(o['added_median_ms'])} over phase 15's in-memory median), "
                f"{t['free_lane_runs']} alone on their lane: added median "
                f"{ms(t['free_lane_added_median_ms'])} ({ms(o['free_lane_added_median_ms'])} "
                f"over in-memory), lanes {t['lanes_occupied']}, lane waits "
                f"{t['lane_wait_share']:.3f} of the executes' time, {t['tok_s']:.1f} tok/s, "
                f"prefix reuse {t['prefix_hits']} hits ({t['prefix_reused_tokens']} tokens)")

    print(
        f"  wire mesh over {transport}:// ({'kafkad' if transport == 'kafka' else 'meshd'} on "
        f"port {address.rsplit(':', 1)[1]}, CRC {crc or 'n/a'}), llama-3-8b bf16, the Client in "
        f"another process, 8 conversations x 2 turns after two warm-up rounds (one run, no "
        f"spread; {card}): {turn_note('turn1', t1)}; {turn_note('turn2', t2)}; {tokens} tokens "
        f"at {result['tok_s']:.1f} tok/s over {measured_wall:.2f} s; {result['records_total']} "
        f"records {records}; worker boot {boot_s:.3f} s, its {len(worker_joins)} group "
        f"subscriptions to their first assignment max {max(worker_joins):.3f} s, every "
        f"subscription {[(g, round(s, 4)) for g, s in joins]}, the client's "
        f"{[(g, round(s, 4)) for g, s in end['joins']]}; {len(expected)} topics provisioned "
        f"(= topics_for_nodes | framework_topics_for_nodes; on the broker besides them: "
        f"{sorted(on_broker - expected) if on_broker is not None else 'n/a'}); second boot: "
        f"{len(again['ensured'])} topics ensured, classified {sorted(set(again['classified']))} "
        f"x {len(again['classified'])}; launches {launches}; prefill by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}, paged decode "
        f"by (B, wpages) {[(r['B'], r['window'], r['launches']) for r in decode_rows]}; "
        f"captures in the measured round {result['measured_captures']}; pages free "
        f"{free_pages} + cached {cached} of {rt.pool_pages() - 1}; {graph_note(graphs_after, peak)}"
    )
    # phase 13's law last, so a run it fails has printed its numbers
    result["streams"] = streams = tie_law(cfg, params, [
        (c["corr"], [tok.bos_id, *tok.encode(render_messages(c["messages"], c["params"]))],
         _stream_ids(tok, c["response"]), _stream_ids(tok, d))
        for c, d in zip(calls, direct)
    ], dev, labels=("mesh", "direct"))
    print(f"  wire mesh over {transport}://: the {len(calls)} engine turns and their direct "
          f"requests within {TIE_SPACINGS} bf16 spacings of the f32 plain forward's top logit "
          f"at every token ({streams['tokens_below_top']} tokens below it, max gap "
          f"{streams['max_gap']:.3f} spacings), {len(calls) - len(streams['diverged'])} equal, "
          f"the rest parting at a tie "
          f"{[(d['step'], round(d['gap_mesh'], 3), round(d['gap_direct'], 3)) for d in streams['diverged']]}")
    return result


# --------------------------------------------------------------------------- #
# phase 17: the serving fleet (two replicas behind FleetRouter, failover)
# --------------------------------------------------------------------------- #

FLEET_REPLICAS = ("r0", "r1")  # pinned instance ids, so the placements are fixed
FLEET_HEARTBEAT_S = 0.2
FLEET_STALE_AFTER = 3.0  # the router's staleness bound: heartbeat x 15
FLEET_PROBE_S = 0.05  # FailoverPolicy.probe_interval
FLEET_STREAM_TOKENS = 160  # the kill drive's answer (>= 128 tokens)
# token steps the caller receives before the kill: a step carries the
# engine's first token, then 24 characters at a time (the agent's flush)
FLEET_KILL_AFTER = 2
# names no city, so the replica's model sends it straight to the engine;
# prefix affinity homes it on r0
FLEET_STREAM_PROMPT = (
    "Write a long travel diary of a slow train journey along the coast, one stop at a time.")

_REPLICA = threading.local()  # .tag: the replica whose dispatch runs on this thread


def _replica_call(tag: str, method, *args):
    _REPLICA.tag = tag
    try:
        return _call_weak(method, *args)
    finally:
        _REPLICA.tag = None


class ReplicaEngine(InferenceEngine):
    """Phase 17's replica engine: every dispatch runs on its
    ``asyncio.to_thread`` worker under the replica's ``tag``, so a launch
    tally tells the replicas apart (:func:`replica_launches`)."""

    def __init__(self, *args, tag: str, **kw):
        super().__init__(*args, **kw)
        self.tag = tag

    async def _on_worker(self, method, *args):
        return await asyncio.to_thread(_replica_call, self.tag, weakref.WeakMethod(method), *args)


@contextlib.contextmanager
def replica_launches(names=("prefill_attention", "paged_decode_attention")):
    """While the block runs, count the launches of the wrappers ``A.<names>``
    by the replica whose dispatch made them (the tag of the thread,
    :class:`ReplicaEngine`): an eager call at once, a graph's calls at each
    replay (:func:`observe_call`) → {tag: {name: launches}}.  The wrappers
    and their launch counts are unchanged."""
    counts: dict = {}
    inner = {name: getattr(A, name) for name in names}
    open_ = [True]

    def wrap(name: str):
        def counted(*args, **kw):
            def record(n, copies):
                tag = getattr(_REPLICA, "tag", None)
                if tag is not None:
                    per = counts.setdefault(tag, {})
                    per[name] = per.get(name, 0) + n

            observe_call(("replica", name), [], record, lambda: open_[0])
            return inner[name](*args, **kw)

        counted.tallied = True  # install_tallies: already wrapped
        return counted

    for name in names:
        setattr(A, name, wrap(name))
    try:
        yield counts
    finally:
        open_[0] = False
        for name, fn in inner.items():
            setattr(A, name, fn)


class FleetTurnModel(MeshTurnModel):
    """Phase 17's replica model: phase 15's, except that a conversation
    whose first text names no city (the kill drive's long answer) goes
    straight to the engine, with ``FLEET_STREAM_TOKENS`` to generate."""

    @staticmethod
    def _names_a_city(messages) -> bool:
        text = getattr(messages[-1].parts[-1], "content", "")
        return isinstance(text, str) and any(c in text for c in AGENT_CITIES)

    def _long_answer(self, messages) -> bool:
        return super()._scripted_first(messages) and not self._names_a_city(messages)

    def _scripted_first(self, messages) -> bool:
        return super()._scripted_first(messages) and self._names_a_city(messages)

    async def request_stream(self, messages, settings=None, params=None):
        if self._long_answer(messages):
            settings = (settings or ModelSettings()).model_copy(
                update={"max_tokens": FLEET_STREAM_TOKENS})
        async for event in super().request_stream(messages, settings, params):
            yield event


def _leaves(tree) -> "list[torch.Tensor]":
    return [x for v in tree.values() for x in (_leaves(v) if isinstance(v, dict) else [v])]


def _placed(fleet, corr: str) -> "str | None":
    """The instance whose worker admitted the call ``corr`` (the topology's
    delivery ledgers)."""
    return next((fleet.instance_id(i) for i in range(len(fleet.agents))
                 if corr in fleet.delivered[i]), None)


def _affinity_home(router, text: str) -> str:
    """The port's ``PrefixAffinity`` pick for a prompt over every replica of
    the agent the registry holds."""
    replicas = router.registry.replicas(agent=MESH_AGENT)
    assert len(replicas) == len(FLEET_REPLICAS), [r.key for r in replicas]
    request = RouteRequest(agent=MESH_AGENT, affinity_key=affinity_key_for(text))
    return PrefixAffinity().select(replicas, request).instance_id


async def _fleet_stream(gateway, kill=None) -> dict:
    """``Agent.stream`` of :data:`FLEET_STREAM_PROMPT` → its token steps'
    texts, offsets and arrival clocks, and the result; with ``kill``, also
    the clock at which ``kill()`` ran (after :data:`FLEET_KILL_AFTER` token
    steps)."""
    out = dict(texts=[], offsets=[], at=[], result=None, killed_at=None)
    async for item in gateway.stream(FLEET_STREAM_PROMPT, timeout=600):
        if isinstance(item, InvocationResult):
            out["result"] = item
            continue
        if getattr(item.step, "kind", "") != "token":
            continue
        out["texts"].append(item.step.text)
        out["offsets"].append(item.step.offset)
        out["at"].append(time.perf_counter())
        if kill is not None and out["killed_at"] is None \
                and len(out["texts"]) == FLEET_KILL_AFTER:
            out["killed_at"] = time.perf_counter()
            kill()
    assert out["result"] is not None, "the stream ended without a result"
    return out


async def fleet_phase(dev, params, agent_mesh: "dict | None" = None, card: str = "") -> dict:
    """Phase 17: the serving fleet on the card.  Two replicas of phase 15's
    agent (its model :class:`FleetTurnModel` over a ``TorchLocalModelClient``
    on a fresh :class:`ReplicaEngine` each: phase 15's paged runtime at
    ``max_seq_len`` 4096, its own pool and graph pool, both over ONE set of
    bf16 llama-3-8b weights, ``params``) run under the port's
    ``FleetTopology`` on one ``InMemoryMesh`` as instances ``r0`` and ``r1``
    (heartbeat every :data:`FLEET_HEARTBEAT_S` s, stale after
    :data:`FLEET_STALE_AFTER` s), the 3 tools on a third ``Worker``.  The
    ``Client`` routes by ``FleetRouter(mesh, "prefix-affinity")`` and
    recovers by ``FailoverPolicy(probe_interval=0.05, max_failovers=2)``,
    its ids seeded as phase 15's.  Three drives:

    1. routed round: two warm-up rounds capture each replica's graph keys;
       the measured round is phase 15's 8 conversations x 2 turns.  Checks:
       every run ends with a result; every call is placed on its prompt's
       ``PrefixAffinity`` home over {r0, r1}, and both replicas take calls;
       no failover; the tie law (:func:`tie_law`) on every engine turn and
       a direct ``request`` on its messages on the same replica; #5 and #2
       launch on both engines, and the two engines' launches add up to the
       round's.
    2. kill mid-stream: an unkilled ``Agent.stream`` of a long greedy
       answer (>= 128 tokens), then the same stream killed
       (``FleetTopology.kill``) on the replica that holds it after
       :data:`FLEET_KILL_AFTER` token steps.  Checks: one contiguous stream
       (each token step's offset is the text before it, their text is the
       result's); its text and the unkilled one's under the tie law; the
       survivor decodes only the remaining tokens and prefills the
       prompt and the delivered prefix (#5 launched there); exactly one
       failover.  The killed replica then resumes (its buffered cancel
       first) and re-advertises.
    3. drain handoff: a round's first turn in flight, ``drain`` of r1 once
       its calls are admitted, then 8 new calls when the registry shows r1
       draining.  Checks: r1 admits none of them; every run, the in-flight
       ones on r1 too, ends with a result.

    One set of weights: every weight tensor of both engines is
    ``params``'s own, each engine's memory beyond its pool is under half
    the weights, and the peak allocation (before the witness)
    is under weights + both engines + the graph pools + 4 GB.  After
    ``stop()`` every page of both engines is free or cached and every slot
    free.  Prints per replica its placements, prefix hits and reused
    tokens, captures and launches; TTFT through the fleet against phase
    15's; tok/s; the seconds from the kill to the first resumed token and
    the resumed offset."""
    cfg = preset("llama-3-8b")
    rt = MESH_RUNTIME
    tok = CharTokenizer()
    tools = [agent_tool(fn) for fn in (get_weather, search_flights, book_hotel)]
    weight_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    torch.cuda.reset_peak_memory_stats(dev)
    with replica_launches() as by_replica:
        engines, locals_, models, static = [], [], [], []
        for tag in FLEET_REPLICAS:
            before = torch.cuda.memory_allocated(dev)
            engine = ReplicaEngine(cfg, rt, params=params, device=dev, tag=tag)
            static.append(torch.cuda.memory_allocated(dev) - before)
            local = TorchLocalModelClient(engine=engine, tokenizer=tok,
                                          max_new_tokens=CLIENT_MAX_TOKENS)
            engines.append(engine)
            locals_.append(local)
            models.append(FleetTurnModel(local))
        # one set of weights: each engine's tensors are the caller's
        for engine in engines:
            assert all(a.data_ptr() == b.data_ptr()
                       for a, b in zip(_leaves(engine.params), _leaves(params)))
        pool_bytes = 2 * engines[0]._k.numel() * engines[0]._k.element_size()
        for s in static:
            # its pool, scratch and buffers: a copy of the weights would double it
            assert s - pool_bytes < weight_bytes / 2, (s, pool_bytes, weight_bytes)
        mesh = InMemoryMesh()
        fleet = FleetTopology(
            mesh, models, name=MESH_AGENT, heartbeat_interval=FLEET_HEARTBEAT_S,
            stale_multiplier=FLEET_STALE_AFTER / FLEET_HEARTBEAT_S, max_workers=MESH_LANES,
            agent_kwargs=dict(instructions=AGENT_INSTRUCTIONS, tools=tools, stream_tokens=True,
                              model_settings=ModelSettings(max_tokens=CLIENT_MAX_TOKENS)),
        )
        for agent, tag in zip(fleet.agents, FLEET_REPLICAS):
            agent.instance_id = tag
        first_token: "dict[str, float]" = {}
        for local in locals_:
            await local.start()
        try:
            with seeded_client_ids(MESH_ID_SEED):
                async with Worker(tools, mesh=mesh, max_workers=MESH_LANES), fleet:
                    router = FleetRouter(mesh, "prefix-affinity",
                                         stale_after=fleet.config.stale_after)
                    client = Client.connect(mesh, router=router, failover=FailoverPolicy(
                        probe_interval=FLEET_PROBE_S, max_failovers=2))
                    await router.start()
                    await settle(
                        lambda: len(router.registry.eligible(MESH_AGENT)) == len(FLEET_REPLICAS),
                        ticks=600, interval=0.05, message="the fleet never became routable")
                    firehose = client.events()

                    async def watch() -> None:
                        async for event in firehose:
                            if event.step.kind == "token":
                                first_token.setdefault(event.correlation_id, time.perf_counter())

                    watcher = asyncio.create_task(watch())
                    try:
                        out = await _fleet_drives(
                            dev, params, client, router, fleet, engines, locals_, models,
                            first_token, by_replica)
                    finally:
                        firehose.close()
                        watcher.cancel()
                        with contextlib.suppress(asyncio.CancelledError):
                            await watcher
                        await client.close()
        finally:
            for local in locals_:
                await local.stop()
            await mesh.stop()
    peak = out.pop("peak")
    # the no-leak law, both engines
    for engine in engines:
        free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
        assert free_pages + cached == rt.pool_pages() - 1, (engine.tag, free_pages, cached)
        assert len(engine._free) == rt.max_batch_size and not engine._active, engine.tag
    memory = dict(weights=weight_bytes, pool=pool_bytes, engines=static,
                  graphs=out["graph_bytes"], peak=peak)
    bound = weight_bytes + sum(static) + out["graph_bytes"] + 4e9
    assert peak <= bound, memory
    out.update(memory=memory)
    return _fleet_report(out, engines, agent_mesh, card)


async def _fleet_drives(dev, params, client, router, fleet, engines, locals_, models,
                        first_token, by_replica) -> dict:
    """Phase 17's three drives (see :func:`fleet_phase`) → their numbers."""
    cfg, tok = preset("llama-3-8b"), CharTokenizer()
    gateway = client.agent(MESH_AGENT)
    n = len(FLEET_REPLICAS)
    after_boot = torch.cuda.memory_allocated(dev)
    # ---- drive 1: the routed round
    for name in ("Warm-up", "Warm-up again"):
        await _mesh_round(client, engines, models, _mesh_prompts(name), first_token)
    graph_bytes = torch.cuda.memory_allocated(dev) - after_boot
    for model, engine in zip(models, engines):
        model.calls.clear()
        engine.stats = EngineStats()
    graphs_before = [graph_numbers(e) for e in engines]
    failovers_before = [a._failover_requests for a in fleet.agents]
    A.reset_launch_counts()
    by_replica.clear()
    with prefill_shapes() as prefills, decode_shapes() as decodes:
        measured = await _mesh_round(client, engines, models, _mesh_prompts("Trip desk"),
                                     first_token)
        launches = dict(A.launch_counts)
        replica_counts = {tag: dict(c) for tag, c in by_replica.items()}
    graphs_after = [graph_numbers(e) for e in engines]
    assert [a._failover_requests for a in fleet.agents] == failovers_before, "a failover"
    placements = []
    for turn, texts in zip(measured["turns"], _mesh_prompts("Trip desk")):
        for run, text in zip(turn["runs"], texts):
            placed = _placed(fleet, run["result"].correlation_id)
            home = _affinity_home(router, text)
            assert placed == home, (text, placed, home)
            placements.append(placed)
    assert set(placements) == set(FLEET_REPLICAS), placements
    for name in ("prefill_attention", "paged_decode_attention"):
        per = [replica_counts.get(tag, {}).get(name, 0) for tag in FLEET_REPLICAS]
        assert all(per) and sum(per) == launches[name], (name, per, launches[name])
    # the measured round's engine turns, each replayed on its replica
    owner = {id(c): i for i, m in enumerate(models) for c in m.calls}
    direct = []
    for turn in measured["turns"]:
        direct += await asyncio.gather(*[
            locals_[owner[id(c)]].request(c["messages"], c["settings"], c["params"])
            for c in turn["calls"]])
    peak_round = torch.cuda.max_memory_allocated(dev)
    # ---- drive 2: kill mid-stream
    home = _affinity_home(router, FLEET_STREAM_PROMPT)
    victim = FLEET_REPLICAS.index(home)
    survivor = 1 - victim
    calls_before = [len(m.calls) for m in models]
    unkilled = await _fleet_stream(gateway)
    assert [len(m.calls) - b for m, b in zip(models, calls_before)] == \
        [int(i == victim) for i in range(n)], "the unkilled stream left its home"
    unkilled_call = models[victim].calls[-1]
    stats0 = [(e.stats.prefill_tokens, e.stats.decode_tokens, e.stats.prefix_reused_tokens)
              for e in engines]
    launches0 = {tag: dict(c) for tag, c in by_replica.items()}
    failovers0 = [a._failover_requests for a in fleet.agents]
    delivered0 = [fleet.calls_delivered(i) for i in range(n)]
    killed = await _fleet_stream(gateway, kill=lambda: fleet.kill(victim))
    failovers = [a._failover_requests - f for a, f in zip(fleet.agents, failovers0)]
    assert failovers == [int(i == survivor) for i in range(n)], failovers
    assert [fleet.calls_delivered(i) - d for i, d in enumerate(delivered0)] == [1] * n
    text = "".join(killed["texts"])
    assert text == killed["result"].output, "the stream is not the answer"
    # a resumed attempt stamps its steps with their offset in the answer
    # (the first attempt's ride the ledger's cumulative law, unstamped)
    b = next((i for i, o in enumerate(killed["offsets"]) if o is not None), None)
    assert b is not None and b >= FLEET_KILL_AFTER, ("no resumed step", killed["offsets"])
    at = 0
    for i, (chunk, offset) in enumerate(zip(killed["texts"], killed["offsets"])):
        assert (offset is None) == (i < b) and offset in (None, at), ("offset", i, offset, at)
        at += len(chunk)  # no duplicate, no gap
    resumed = killed["offsets"][b]  # the delivered prefix
    kill_to_resume = killed["at"][b] - killed["killed_at"]
    total = len(tok.encode(text))
    assert total >= 128 and len(tok.encode(unkilled["result"].output)) >= 128, total
    p1, d1, r1 = (engines[survivor].stats.prefill_tokens, engines[survivor].stats.decode_tokens,
                  engines[survivor].stats.prefix_reused_tokens)
    p0, d0, r0 = stats0[survivor]
    prompt_ids = [tok.bos_id, *tok.encode(render_messages(unkilled_call["messages"],
                                                          unkilled_call["params"]))]
    survivor_decode, survivor_prefill, survivor_reused = d1 - d0, p1 - p0, r1 - r0
    assert survivor_decode == total - resumed, (survivor_decode, total, resumed)
    # the prompt and the delivered prefix enter by prefill (or the prefix cache)
    assert survivor_prefill + survivor_reused >= len(prompt_ids) + resumed, \
        (survivor_prefill, survivor_reused, len(prompt_ids), resumed)
    tag = FLEET_REPLICAS[survivor]
    survivor_prefill_launches = (by_replica.get(tag, {}).get("prefill_attention", 0)
                                 - launches0.get(tag, {}).get("prefill_attention", 0))
    assert survivor_prefill_launches > 0
    # the zombie returns: its buffered cancel first, then its heartbeat
    await fleet.resume(victim)
    await settle(lambda: len(router.registry.eligible(MESH_AGENT)) == n,
                 ticks=600, interval=0.05, message="the killed replica never re-advertised")
    # ---- drive 3: drain handoff of r1
    drained = 1
    texts = _mesh_prompts("Fleet drain")[0]
    on_drained = sum(1 for t in texts if _affinity_home(router, t) == FLEET_REPLICAS[drained])
    before = [fleet.calls_delivered(i) for i in range(n)]
    inflight = [asyncio.create_task(gateway.execute(t, timeout=600)) for t in texts]
    await settle(lambda: sum(fleet.calls_delivered(i) - before[i] for i in range(n)) == len(texts),
                 ticks=1200, interval=0.01, message="the in-flight calls were never admitted")
    assert fleet.calls_delivered(drained) - before[drained] == on_drained >= 1
    fleet.drain(drained)
    at_drain = fleet.calls_delivered(drained)
    await settle(lambda: [r.instance_id for r in router.registry.eligible(MESH_AGENT)]
                 == [FLEET_REPLICAS[1 - drained]], ticks=600, interval=0.05,
                 message="the drain never reached the registry")
    after = await asyncio.gather(*[gateway.execute(t, timeout=600)
                                   for t in _mesh_prompts("Fleet after drain")[0]])
    finished = await asyncio.gather(*inflight)
    assert all(isinstance(r.output, str) and r.output for r in [*after, *finished])
    assert fleet.calls_delivered(drained) == at_drain, "the drained replica took a new call"
    # the witness, last: the tie law on drive 1's engine turns and the two streams
    calls = [c for turn in measured["turns"] for c in turn["calls"]]
    streams = tie_law(cfg, params, [
        (c["corr"], [tok.bos_id, *tok.encode(render_messages(c["messages"], c["params"]))],
         _stream_ids(tok, c["response"]), _stream_ids(tok, d))
        for c, d in zip(calls, direct)
    ], dev, labels=("fleet", "direct"))
    kill_law = tie_law(cfg, params, [
        ("kill", prompt_ids, tok.encode(text), tok.encode(unkilled["result"].output))
    ], dev, labels=("failover", "unkilled"))
    return dict(
        measured=measured, launches=launches, replica_launches=replica_counts,
        prefill_rows=_shape_rows(prefills), decode_rows=_shape_rows(decodes),
        graphs_before=graphs_before, graphs_after=graphs_after, graph_bytes=graph_bytes,
        placements=placements, streams=streams, kill_law=kill_law, peak=peak_round,
        kill=dict(victim=FLEET_REPLICAS[victim], survivor=FLEET_REPLICAS[survivor],
                  kill_to_resume_s=kill_to_resume, resumed_offset=resumed, tokens=total,
                  survivor_decode_tokens=survivor_decode,
                  survivor_prefill_tokens=survivor_prefill,
                  survivor_reused_tokens=survivor_reused, prompt_tokens=len(prompt_ids),
                  survivor_prefill_launches=survivor_prefill_launches, failovers=failovers,
                  equal_to_unkilled=text == unkilled["result"].output),
        drain=dict(replica=FLEET_REPLICAS[drained], inflight_on_it=on_drained,
                   new_calls=len(after), delivered_after=[fleet.calls_delivered(i)
                                                          for i in range(n)]),
    )


def _fleet_report(out: dict, engines, agent_mesh: "dict | None", card: str) -> dict:
    """Phase 17's numbers (printed) from :func:`_fleet_drives`'s."""
    t1, t2 = (_mesh_turn_numbers(t, MESH_LANES) for t in out["measured"]["turns"])
    tokens = t1["output_tokens"] + t2["output_tokens"]
    per_replica = {}
    for i, tag in enumerate(FLEET_REPLICAS):
        hits = sum(t["per_engine_prefix"][i][0] for t in out["measured"]["turns"])
        reused = sum(t["per_engine_prefix"][i][1] for t in out["measured"]["turns"])
        per_replica[tag] = dict(
            placements=out["placements"].count(tag), prefix_hits=hits, prefix_reused_tokens=reused,
            captures=out["graphs_after"][i]["captures"] - out["graphs_before"][i]["captures"],
            graphs=out["graphs_after"][i], launches=out["replica_launches"].get(tag, {}))
    m = out["memory"]
    result = dict(
        turn1=t1, turn2=t2, output_tokens=tokens, tok_s=tokens / out["measured"]["wall_s"],
        wall_s=out["measured"]["wall_s"], replicas=per_replica, launches=out["launches"],
        prefill_shapes=out["prefill_rows"], decode_shapes=out["decode_rows"],
        streams=out["streams"], kill=out["kill"], kill_law=out["kill_law"], drain=out["drain"],
        memory=m, max_memory_allocated=m["peak"],
    )
    if agent_mesh is not None:
        result["vs_phase15"] = {
            f"turn{k}": dict(
                mesh_ttft_median_ms=(t["mesh_ttft_median_ms"],
                                     agent_mesh[f"turn{k}"]["mesh_ttft_median_ms"]),
                added_median_ms=(t["added_median_ms"], agent_mesh[f"turn{k}"]["added_median_ms"]))
            for k, t in ((1, t1), (2, t2))}
    k, s = out["kill"], out["streams"]
    versus = "".join(
        f"; phase 15's turn {i} {v['mesh_ttft_median_ms'][1]:.1f} ms, added "
        f"{v['added_median_ms'][1]:.1f}" for i, v in enumerate(result.get("vs_phase15", {})
                                                               .values(), 1))
    print(
        f"  serving fleet llama-3-8b bf16, replicas {', '.join(FLEET_REPLICAS)} of the agent "
        f"under FleetTopology on one InMemoryMesh behind FleetRouter(prefix-affinity, stale "
        f"after {FLEET_STALE_AFTER} s), FailoverPolicy(probe {FLEET_PROBE_S} s) (one run, no "
        f"spread; {card}): {per_replica_note(per_replica)}; TTFT through the fleet turn 1 "
        f"median {t1['mesh_ttft_median_ms']:.1f} ms max {t1['mesh_ttft_max_ms']:.1f}, turn 2 "
        f"median {t2['mesh_ttft_median_ms']:.1f} max {t2['mesh_ttft_max_ms']:.1f}, added "
        f"median {t1['added_median_ms']:.1f} and {t2['added_median_ms']:.1f}{versus}; "
        f"{tokens} tokens at {result['tok_s']:.1f} tok/s over {out['measured']['wall_s']:.2f} "
        f"s; the {len(out['measured']['turns'][0]['calls']) + len(out['measured']['turns'][1]['calls'])} "
        f"engine turns and their direct requests within {TIE_SPACINGS} bf16 spacings of the "
        f"f32 plain forward's top logit (max gap {s['max_gap']:.3f}, "
        f"{len(s['diverged'])} parting at a tie); launches {out['launches']}; prefill "
        f"launches by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in out['prefill_rows']]}, paged "
        f"decode by (B, wpages) "
        f"{[(r['B'], r['window'], r['launches']) for r in out['decode_rows']]}; kill "
        f"mid-stream: {k['victim']} killed after {FLEET_KILL_AFTER} token steps, the first "
        f"resumed token {k['kill_to_resume_s']:.3f} s later from {k['survivor']} at offset "
        f"{k['resumed_offset']} of {k['tokens']} tokens; the survivor decoded "
        f"{k['survivor_decode_tokens']} tokens and took the prompt ({k['prompt_tokens']}) and "
        f"the prefix by prefill ({k['survivor_prefill_tokens']} tokens, "
        f"{k['survivor_prefill_launches']} #5 launches) and the prefix cache "
        f"({k['survivor_reused_tokens']}); "
        f"failovers {k['failovers']}; equal to the unkilled stream: {k['equal_to_unkilled']} "
        f"(max gap {out['kill_law']['max_gap']:.3f}); drain of {out['drain']['replica']} with "
        f"{out['drain']['inflight_on_it']} of its calls in flight, then "
        f"{out['drain']['new_calls']} new calls: calls admitted "
        f"{out['drain']['delivered_after']}; weights {m['weights'] / 1e9:.3f} GB once, a pool "
        f"{m['pool'] / 1e9:.3f} GB, the engines {[round(x / 1e9, 3) for x in m['engines']]} "
        f"GB, graph pools {m['graphs'] / 1e9:.3f} GB, max allocated {m['peak'] / 1e9:.3f} GB"
    )
    return result


def per_replica_note(per_replica: dict) -> str:
    return "; ".join(
        f"{tag} {r['placements']} placements, {r['prefix_hits']} prefix hits "
        f"({r['prefix_reused_tokens']} tokens), {r['captures']} captures in the round, "
        f"launches {r['launches']}" for tag, r in per_replica.items())


# --------------------------------------------------------------------------- #
# phase 18: a typed agent with an MCP toolbox, a consumer and /metrics
# --------------------------------------------------------------------------- #

TYPED_AGENT = "trip_planner"
TYPED_ROUNDS = ("Warm-up", "Warm-up again", "Typed trips")
TYPED_RETRIES = 2  # Agent(max_output_retries=): three attempts at the typed answer
TRAVELLERS = ("Ana", "Bo", "Chen", "Dee", "Eli", "Fay", "Gus", "Hal")
TYPED_INSTRUCTIONS = (
    "You plan trips for a small agency. Call distance for each leg of the trip, "
    "book every leg for its travellers, then answer with the final_result tool: "
    "the plan as JSON matching its schema. Dates are written as YYYY-MM-DD; keep "
    "the notes short and never invent a booking reference."
)


class TripPace(enum.Enum):
    RELAXED = "relaxed"
    BRISK = "brisk"


@dataclasses.dataclass
class Leg:
    origin: str
    destination: str
    km: int
    mode: Literal["train", "flight", "bus"] = "train"


@dataclasses.dataclass
class TripPlan:
    traveller: str
    legs: list[Leg]
    pace: TripPace
    budget: Literal["low", "mid", "high"]
    nights: int | None = None
    notes: tuple[str, ...] = ()


def book(leg: Leg, travellers: tuple[str, ...]) -> dict:
    """Book one leg of a trip for its travellers.

    Args:
        leg: The leg to book.
        travellers: Who travels on it.
    """
    assert isinstance(leg, Leg) and isinstance(travellers, tuple)  # instantiated, not dicts
    return {"booked": f"{leg.origin}-{leg.destination}", "km": leg.km,
            "travellers": list(travellers)}


# phase 18's MCP server: one stdio tool, written to a temporary directory
MCP_SERVER_SOURCE = r'''"""A stdio MCP server with one tool: distance(origin, destination) -> km."""
import json
import sys

TOOL = {
    "name": "distance",
    "description": "Road distance between two cities, in km.",
    "inputSchema": {"type": "object", "properties": {"origin": {"type": "string"},
                    "destination": {"type": "string"}}, "required": ["origin", "destination"]},
}

for line in sys.stdin:
    message = json.loads(line)
    if "id" not in message:
        continue  # a notification
    method, params = message.get("method"), message.get("params") or {}
    if method == "initialize":
        result = {"protocolVersion": params.get("protocolVersion"),
                  "capabilities": {"tools": {}}, "serverInfo": {"name": "geo", "version": "0"}}
    elif method == "tools/list":
        result = {"tools": [TOOL]}
    elif method == "tools/call" and params.get("name") == "distance":
        args = params.get("arguments") or {}
        km = 100 + sum(map(ord, args["origin"] + args["destination"])) % 900
        result = {"content": [{"type": "text", "text": str(km)}]}
    else:
        print(json.dumps({"jsonrpc": "2.0", "id": message["id"],
                          "error": {"code": -32601, "message": f"no method {method}"}}),
              flush=True)
        continue
    print(json.dumps({"jsonrpc": "2.0", "id": message["id"], "result": result}), flush=True)
'''


def typed_prompts(round_: str) -> "list[str]":
    """A round's user text, one per conversation."""
    n = len(AGENT_CITIES)
    return [f"{round_} trip {i}: plan {TRAVELLERS[i]}'s trip from {city} to "
            f"{AGENT_CITIES[(i + 1) % n]} on 2026-0{i + 1}-1{i}, with {TRAVELLERS[(i + 3) % n]}."
            for i, city in enumerate(AGENT_CITIES)]


def typed_attempt(messages) -> int:
    """Which step of a typed turn ``messages`` ask for: 0 the conversation's
    first (the scripted tool calls); then 1, 2, 3, the attempts at the typed
    answer (one more a retry part since the tools' returns).  Read by role
    and part kind, so either package's messages serve."""
    if not any(m.role == "response" for m in messages):
        return 0
    retries = 0
    for message in reversed(messages):
        kinds = [p.kind for p in message.parts] if message.role == "request" else []
        if "tool_return" in kinds:
            break
        retries += "retry" in kinds
    return retries + 1


def typed_conversation(messages) -> int:
    text = next(p.content for m in messages if m.role == "request" for p in m.parts
                if p.kind == "user")
    return int(re.search(r"trip (\d+):", text).group(1))


def typed_legs(i: int) -> "tuple[str, str]":
    return AGENT_CITIES[i], AGENT_CITIES[(i + 1) % len(AGENT_CITIES)]


def typed_final(i: int, km: int, text: str) -> "tuple[dict, TripPlan | None]":
    """Attempt 3's ``final_result`` arguments, built from the engine's
    attempt-2 text, and the plan they validate to: valid for an even
    conversation, for an odd one refused (``nights: "many"``)."""
    origin, destination = typed_legs(i)
    pace, budget = ("brisk", "relaxed")[len(text) % 2], ("low", "mid", "high")[len(text) % 3]
    nights = (len(text) % 5) or None
    args = {"traveller": TRAVELLERS[i],
            "legs": [{"origin": origin, "destination": destination, "km": km, "mode": "train"}],
            "pace": pace, "budget": budget, "nights": nights if i % 2 == 0 else "many",
            "notes": [text]}
    plan = TripPlan(TRAVELLERS[i], [Leg(origin, destination, km)], TripPace(pace), budget,
                    nights, (text,)) if i % 2 == 0 else None
    return args, plan


def typed_step(P, messages):
    """The scripted steps of a typed conversation, on package ``P``'s
    ``ModelResponse`` and ``ToolCallOutput``: the first (an MCP ``distance``
    call and a ``book`` call with nested arguments) and attempt 3."""
    i = typed_conversation(messages)
    origin, destination = typed_legs(i)
    n = len(TRAVELLERS)
    if typed_attempt(messages) == 0:
        return P.ModelResponse(parts=[
            P.ToolCallOutput(tool_call_id=f"km_{i}", tool_name="toolbox.geo__distance",
                             args={"origin": origin, "destination": destination}),
            P.ToolCallOutput(tool_call_id=f"book_{i}", tool_name="book", args={
                "leg": {"origin": origin, "destination": destination, "km": str(100 + i)},
                "travellers": [TRAVELLERS[i], TRAVELLERS[(i + 3) % n]]}),
        ])
    km = next(int(str(p.content)) for m in messages if m.role == "request" for p in m.parts
              if p.kind == "tool_return" and p.tool_name.endswith("distance"))
    text = next(m for m in reversed(messages) if m.role == "response").text()
    args, _ = typed_final(i, km, text)
    return P.ModelResponse(parts=[P.ToolCallOutput(
        tool_call_id=f"plan_{i}", tool_name="final_result", args=args)])


class TypedTurnModel(MeshTurnModel):
    """Phase 18's agent model: a conversation's first step and attempt 3 at
    the typed answer are scripted (:func:`typed_step`); attempts 1 and 2 are
    the local engine's turns, recorded as :class:`MeshTurnModel` records
    them.  On random weights the engine's text is no JSON, so each attempt
    fails and the turn runner sends its retry part back."""

    def __init__(self, local: TorchLocalModelClient):
        super().__init__(local)
        models = SimpleNamespace(ModelResponse=ModelResponse, ToolCallOutput=ToolCallOutput)
        self.scripted = FunctionModelClient(lambda messages, params: typed_step(models, messages),
                                            name="trip-planner-script")

        self.steps: "list[tuple[int, int]]" = []  # (conversation, attempt) of every step

    def _scripted_first(self, messages) -> bool:
        self.steps.append((typed_conversation(messages), typed_attempt(messages)))
        return typed_attempt(messages) in (0, 3)


class TimedToolbox(MCPToolboxNode):
    """``MCPToolboxNode`` whose session times every ``tools/call`` round
    trip (the JSON-RPC request to the server's answer, ms)."""

    def __init__(self, spec: MCPServerSpec):
        super().__init__(spec)
        self.call_ms: "list[float]" = []

    async def start_session(self) -> None:
        await super().start_session()
        call_tool = self._session.call_tool

        async def timed(name, args):
            t = time.perf_counter()
            try:
                return await call_tool(name, args)
            finally:
                self.call_ms.append((time.perf_counter() - t) * 1e3)

        self._session.call_tool = timed


async def http_get(port: int, path: str) -> "tuple[str, str, float]":
    """(status line, body, ms) of one ``GET`` on the loopback."""
    t = time.perf_counter()
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.0\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.decode().partition("\r\n\r\n")
    return head.splitlines()[0], body, (time.perf_counter() - t) * 1e3


def scrape_values(text: str, names: "tuple[str, ...]") -> "dict[str, float]":
    """The values of unlabelled samples ``names`` in a Prometheus text."""
    out = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name in names:
            out[name] = float(value)
    return out


TYPED_SCRAPED = ("calfkit_engine_decode_tokens_total", "calfkit_engine_prefill_tokens_total",
                 "calfkit_engine_ttft_ms_count")


async def typed_agent_phase(dev, params, card: str = "") -> dict:
    """Phase 18: a typed agent with an MCP toolbox, a consumer and the
    ``/metrics`` endpoint on the card.  ``Worker([Agent("trip_planner",
    output_type=TripPlan), book, MCPToolboxNode, consumer])`` on an
    ``InMemoryMesh``: the agent's tools are ``mixed_tools(book,
    Toolbox("geo"))`` (``book`` takes a nested ``Leg`` and a
    ``tuple[str, ...]``; the toolbox node serves a stdio MCP server this
    phase writes to a temporary directory, :data:`MCP_SERVER_SOURCE`); its
    model is :class:`TypedTurnModel` over a ``TorchLocalModelClient`` on
    phase 15's runtime and weights (``MESH_RUNTIME``, ``llama-3-8b`` bf16,
    :class:`CharTokenizer`, 32 new tokens a step), ``stream_tokens=True``;
    the consumer taps the agent's publish topic; a ``MetricsServer(port=0)``
    serves the process registry with a readiness probe on the worker and
    the engine.  Two warm-up rounds, then the measured round of 8
    conversations through ``client.agent(..., output_type=TripPlan)
    .execute``, the client's ids seeded, launch counts reset just before
    and read just after.  Checks: an even conversation's output is the
    ``TripPlan`` attempt 3's arguments give; an odd one ends in
    ``NodeFaultError`` carrying the turn's ``mesh.validation_error``
    report after exactly 3 attempts; the consumer saw each typed result
    once, its ``DataPart`` equal to ``Adapter(TripPlan).dump(output)``;
    each conversation's token steps are attempt 1's text, the retry
    boundary, attempt 2's text and the boundary again; attempt 2 reuses
    more prefix tokens than attempt 1 (its own attempt 1's full pages);
    the ``/metrics`` scrape's engine counters moved as ``EngineStats``
    did over the round and its first-token count by the round's engine
    turns; ``/readyz`` answers 200 while serving and 503 after ``stop()``;
    the 16 engine turns and a direct ``request`` on each turn's messages
    hold phase 13's law (:func:`tie_law`); #5 and #2 launch; no leak."""
    cfg = preset("llama-3-8b")
    rt = MESH_RUNTIME
    tok = CharTokenizer()
    torch.cuda.reset_peak_memory_stats(dev)
    engine = InferenceEngine(cfg, rt, params=params, device=dev)
    local = TorchLocalModelClient(engine=engine, tokenizer=tok, max_new_tokens=CLIENT_MAX_TOKENS)
    model = TypedTurnModel(local)
    book_tool = agent_tool(book)
    seen: "list[tuple[str | None, list]]" = []

    @consumer(topics=[protocol.agent_publish_topic(TYPED_AGENT)], name="trip_audit")
    def trip_audit(ctx) -> None:
        reply = ctx.envelope.reply if ctx.envelope is not None else None
        if isinstance(reply, ReturnMessage):
            seen.append((ctx.correlation_id, [p.data for p in reply.parts
                                              if isinstance(p, DataPart)]))

    agent = Agent(
        TYPED_AGENT, model=model, instructions=TYPED_INSTRUCTIONS,
        tools=mixed_tools(book_tool, Toolbox("geo")), output_type=TripPlan,
        max_output_retries=TYPED_RETRIES,
        model_settings=ModelSettings(max_tokens=CLIENT_MAX_TOKENS), stream_tokens=True,
    )
    adapter = Adapter(TripPlan)
    tokens: "dict[str, list[str]]" = {}
    scrapes: list = []
    with tempfile.TemporaryDirectory() as tmp:
        server_path = Path(tmp) / "geo_mcp_server.py"
        server_path.write_text(MCP_SERVER_SOURCE)
        toolbox = TimedToolbox(MCPServerSpec(name="geo", command=[sys.executable,
                                                                   str(server_path)]))
        mesh = InMemoryMesh()
        worker = Worker([agent, book_tool, toolbox, trip_audit], mesh=mesh,
                        max_workers=MESH_LANES)
        metrics = MetricsServer(port=0, registry=REGISTRY, readiness=lambda: (
            worker.ready()[0] and local.ready()[0], "worker + engine"))
        await local.start()
        await metrics.start()
        try:
            with seeded_client_ids(MESH_ID_SEED):
                async with worker:
                    client = Client.connect(mesh)
                    firehose = client.events()

                    async def watch() -> None:
                        async for event in firehose:
                            if event.step.kind == "token":
                                tokens.setdefault(event.correlation_id, []).append(event.step.text)

                    watcher = asyncio.create_task(watch())
                    try:
                        for name in TYPED_ROUNDS[:-1]:
                            await _typed_round(client, typed_prompts(name))
                        ready = await http_get(metrics.port, "/readyz")
                        model.calls.clear()
                        model.steps.clear()
                        tokens.clear()
                        seen.clear()
                        toolbox.call_ms.clear()
                        engine._sync_metric_counters()  # the registry's counters up to date
                        stats_before = engine.stats.counters()
                        scrapes.append(await http_get(metrics.port, "/metrics"))
                        graphs_before = graph_numbers(engine)
                        A.reset_launch_counts()
                        with prefill_shapes() as prefills, decode_shapes() as decodes:
                            measured = await _typed_round(client, typed_prompts(TYPED_ROUNDS[-1]))
                            launches = dict(A.launch_counts)
                        measured["calls"] = list(model.calls)
                        graphs_after = graph_numbers(engine)
                        engine._sync_metric_counters()
                        stats_after = engine.stats.counters()
                        scrapes.append(await http_get(metrics.port, "/metrics"))
                        await asyncio.sleep(0.2)  # the consumer's and the firehose's last records
                    finally:
                        firehose.close()
                        watcher.cancel()
                        with contextlib.suppress(asyncio.CancelledError):
                            await watcher
                        await client.close()
            # a direct request on each engine turn's messages, an attempt's 8 at once
            direct = []
            for attempt in (1, 2):
                direct += await asyncio.gather(*[
                    local.request(c["messages"], c["settings"], c["params"])
                    for c in measured["calls"] if typed_attempt(c["messages"]) == attempt])
        finally:
            await local.stop()
            stopped = await http_get(metrics.port, "/readyz")
            await metrics.stop()
    peak = torch.cuda.max_memory_allocated(dev)
    calls = sorted(measured["calls"], key=lambda c: typed_attempt(c["messages"]))
    by_conv = {typed_conversation(c["messages"]): c["corr"] for c in calls}
    # typed results and typed faults
    for i, run in enumerate(measured["runs"]):
        steps = sorted(a for conv, a in model.steps if conv == i)
        assert steps == [0, 1, 2, 3], (i, steps)  # the tools' step, then 3 attempts
        engine_text = {typed_attempt(c["messages"]): c["response"].text()
                       for c in calls if c["corr"] == by_conv[i]}
        if i % 2 == 0:
            assert isinstance(run, InvocationResult) and isinstance(run.output, TripPlan), run
            km = run.output.legs[0].km
            assert run.output == typed_final(i, km, engine_text[2])[1], (i, run.output)
            assert [d for c, d in seen if c == run.correlation_id] == [[adapter.dump(run.output)]]
        else:
            assert isinstance(run, NodeFaultError), (i, run)
            message = str(run.report.message)
            assert "mesh.validation_error" in message and "after 3 attempts" in message, message
        # the token steps: attempt 1, the boundary, attempt 2, the boundary
        boundary = _TokenTap.RETRY_BOUNDARY
        assert "".join(tokens.get(by_conv[i], [])) == (
            engine_text[1] + boundary + engine_text[2] + boundary), (i, tokens.get(by_conv[i]))
    assert len(seen) == len(measured["runs"]) // 2, seen
    # attempt 2 reuses its own attempt 1's full pages
    admits = [(corr, b) for _, _, code, corr, _, a, b, _ in engine._journal.snapshot()
              if code == flightrec.EV_ADMIT and corr in by_conv.values()]
    reuse = {corr: [b for c, b in admits if c == corr][-2:] for corr in by_conv.values()}
    align = math.lcm(rt.page_size, rt.prefill_chunk)
    for i, corr in by_conv.items():
        first, second = reuse[corr]
        prompt1 = next(len(tok.encode(render_messages(c["messages"], c["params"])))
                       for c in calls if c["corr"] == corr and typed_attempt(c["messages"]) == 1)
        assert second > first and second >= (prompt1 // align - 1) * align, (i, reuse[corr],
                                                                             prompt1)
    # /metrics and /readyz
    (status0, text0, _), (status1, text1, scrape_ms) = scrapes
    assert status0.endswith("200 OK") and status1.endswith("200 OK")
    v0, v1 = scrape_values(text0, TYPED_SCRAPED), scrape_values(text1, TYPED_SCRAPED)
    moved = {k: v1[k] - v0[k] for k in TYPED_SCRAPED}
    assert moved["calfkit_engine_decode_tokens_total"] == (
        stats_after["decode_tokens"] - stats_before["decode_tokens"]), moved
    assert moved["calfkit_engine_prefill_tokens_total"] == (
        stats_after["prefill_tokens"] - stats_before["prefill_tokens"]), moved
    assert moved["calfkit_engine_ttft_ms_count"] == len(calls), (moved, len(calls))
    assert ready[0].endswith("200 OK") and stopped[0].endswith("503 Service Unavailable"), (
        ready, stopped)
    # the tie law on every engine turn and its direct request
    streams = tie_law(cfg, params, [
        (f"{c['corr']}#{typed_attempt(c['messages'])}",
         [tok.bos_id, *tok.encode(render_messages(c["messages"], c["params"]))],
         _stream_ids(tok, c["response"]), _stream_ids(tok, d))
        for c, d in zip(calls, direct)
    ], dev, labels=("typed", "direct"))
    assert launches["prefill_attention"] > 0 and launches["paged_decode_attention"] > 0, launches
    prefill_rows, decode_rows = _shape_rows(prefills), _shape_rows(decodes)
    assert sum(r["launches"] for r in prefill_rows) == launches["prefill_attention"]
    assert sum(r["launches"] for r in decode_rows) == launches["paged_decode_attention"]
    free_pages, cached = engine._page_alloc.free_pages, engine._prefix.size
    assert free_pages + cached == rt.pool_pages() - 1, (free_pages, cached)
    assert len(engine._free) == rt.max_batch_size and not engine._active
    ttft = {a: [(c["first"] - c["submit"]) * 1e3 for c in calls if typed_attempt(c["messages"]) == a]
            for a in (1, 2)}
    prompt_tokens = {a: [1 + len(tok.encode(render_messages(c["messages"], c["params"])))
                         for c in calls if typed_attempt(c["messages"]) == a] for a in (1, 2)}
    result = dict(
        ttft_ms={a: dict(median=statistics.median(v), max=max(v)) for a, v in ttft.items()},
        prompt_tokens={a: dict(min=min(v), max=max(v)) for a, v in prompt_tokens.items()},
        mcp_call_ms=dict(median=statistics.median(toolbox.call_ms), min=min(toolbox.call_ms),
                         max=max(toolbox.call_ms), calls=len(toolbox.call_ms)),
        # the round's decode dispatches: an attempt 2 arriving while others
        # decode waits for the dispatch in flight before each of its chunks
        decode_dispatches=stats_after["decode_dispatches"] - stats_before["decode_dispatches"],
        decode_dispatch_ms=1e3 * (stats_after["decode_time_s"] - stats_before["decode_time_s"])
        / max(1, stats_after["decode_dispatches"] - stats_before["decode_dispatches"]),
        scrape_ms=scrape_ms, reuse=reuse, wall_s=measured["wall_s"], engine_turns=len(calls),
        typed=sum(1 for r in measured["runs"] if isinstance(r, InvocationResult)),
        faults=sum(1 for r in measured["runs"] if isinstance(r, NodeFaultError)),
        launches=launches, prefill_shapes=prefill_rows, decode_shapes=decode_rows,
        streams=streams, scraped=moved, measured_captures=graphs_after["captures"]
        - graphs_before["captures"], graphs=graphs_after, max_memory_allocated=peak,
    )
    print(
        f"  typed agent llama-3-8b bf16, Worker([Agent(output_type=TripPlan), book, "
        f"MCPToolboxNode, consumer]) on an InMemoryMesh, 8 conversations (one run, no spread; "
        f"{card}): {result['typed']} typed TripPlan results and {result['faults']} "
        f"mesh.validation_error faults after 3 attempts each; the engine's TTFT (request_stream "
        f"-> first TextDelta) attempt 1 median {result['ttft_ms'][1]['median']:.1f} ms max "
        f"{result['ttft_ms'][1]['max']:.1f} ms, attempt 2 median "
        f"{result['ttft_ms'][2]['median']:.1f} ms max {result['ttft_ms'][2]['max']:.1f} ms "
        f"(prompts of {result['prompt_tokens'][1]['min']}-{result['prompt_tokens'][1]['max']} "
        f"and {result['prompt_tokens'][2]['min']}-{result['prompt_tokens'][2]['max']} tokens); "
        f"prefix reuse (attempt 1, attempt 2) by conversation "
        f"{[reuse[by_conv[i]] for i in sorted(by_conv)]} tokens; the MCP tools/call round trip "
        f"through the toolbox node median {result['mcp_call_ms']['median']:.2f} ms min "
        f"{result['mcp_call_ms']['min']:.2f} max {result['mcp_call_ms']['max']:.2f} ms over "
        f"{len(toolbox.call_ms)} calls; {result['decode_dispatches']} decode dispatches of "
        f"{result['decode_dispatch_ms']:.1f} ms on average; /metrics "
        f"scrape {scrape_ms:.2f} ms (engine counters moved {moved}); the round's wall "
        f"{measured['wall_s']:.2f} s; the {len(calls)} engine turns and their direct requests "
        f"within {TIE_SPACINGS} bf16 spacings of the f32 plain forward's top logit at every "
        f"token ({streams['tokens_below_top']} tokens below it, max gap "
        f"{streams['max_gap']:.3f} spacings), {len(calls) - len(streams['diverged'])} equal; "
        f"launches {launches}; prefill launches by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in prefill_rows]}, paged decode "
        f"by (B, wpages) {[(r['B'], r['window'], r['launches']) for r in decode_rows]}; "
        f"captures in the measured round {result['measured_captures']}; pages free "
        f"{free_pages} + cached {cached} of {rt.pool_pages() - 1}; {graph_note(graphs_after, peak)}"
    )
    return result


async def _typed_round(client, prompts) -> dict:
    """One round: every conversation's typed ``execute`` at once; per
    conversation its ``InvocationResult`` or its ``NodeFaultError``."""
    gateway = client.agent(TYPED_AGENT, output_type=TripPlan)

    async def one(text: str):
        try:
            return await gateway.execute(text, timeout=600)
        except NodeFaultError as exc:
            return exc

    started = time.perf_counter()
    runs = await asyncio.gather(*[one(text) for text in prompts])
    return dict(runs=list(runs), wall_s=time.perf_counter() - started)


# --------------------------------------------------------------------------- #
# phase 19: tensor parallelism across two processes
# --------------------------------------------------------------------------- #

# phase 15's runtime without the ragged lane, at tp = 2
TP_RUNTIME = replace(MESH_RUNTIME, ragged_waves=False, tp=2)
TP_SEED = 0  # both ranks draw the model from this seed, each its own shard
TP_WORKER_TIMEOUT_S = 600.0


def _tp_rank1(coordinator: str, cfg, rt, device: str) -> None:
    """Phase 19's rank 1 (a spawned process): join the group over gloo and
    run rank 0's dispatches on its shard of ``cfg`` drawn from the seed
    until rank 0's engine stops."""
    from calfkit_tpu_torch.inference import distributed as D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    D.initialize_multihost(coordinator, 2, 1, backend="gloo")
    try:
        D.serve_worker(cfg, rt, seed=TP_SEED, device=device)
    finally:
        D.shutdown_group()


def _rank_reset(engine) -> None:
    A.reset_launch_counts()
    if engine.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(engine.device)


def _rank_numbers(engine) -> dict:
    """One rank's launch counts, peak allocation and collective counts."""
    peak = torch.cuda.max_memory_allocated(engine.device) if engine.device.type == "cuda" else 0
    comm = engine._layout.comm
    return dict(launches=dict(A.launch_counts), peak=peak, comm=dict(comm.stats),
                kv_heads=engine._kv_heads, heads=engine.params["layers"]["wq"].shape[2])


def _rank_cases(engine, prefill_rows: "list[dict]", decode_rows: "list[dict]") -> "list[dict]":
    """#5 and #2 against their plain versions on this rank, at its own
    heads (H/tp queries over its kv heads), at the shapes phase 19
    launched most."""
    dev, bf16 = engine.device, torch.bfloat16
    if dev.type != "cuda":
        return []  # the kernels run on a card only (a rehearsal on the CPU)
    H, K = engine.params["layers"]["wq"].shape[2], engine._kv_heads
    rt = TP_RUNTIME
    p, d = prefill_rows[0], decode_rows[0]
    label = f"tp=2 rank {engine._rank}, {d['launches']} launches"
    return run_cases(dev, [
        ("prefill_attention", prefill_case,
         (bf16, p["B"], p["S"], H, K, 128, 44, 0, p["window"], p["last_kv_lens"])),
        ("paged_decode_attention", paged_decode_case,
         (bf16, d["B"], K, H // K, 128, rt.page_size, d["last_kv_lens"], d["window"], 41, 1,
          bf16, label, rt.pool_pages())),
    ])


async def _tp_round(engine, eager: bool, cases: bool) -> dict:
    """Phase 15's measured agent round on a multi-rank ``engine`` (rank 0),
    through a ``TorchLocalModelClient`` over it: every rank's launch counts
    reset just before the round and read just after (``on_ranks``), the
    round's 16 engine turns replayed as direct requests, then (``cases``)
    each rank's #5 and #2 against their plain versions at the round's most
    launched shapes; ``stop()`` and the no-leak law last."""
    tok = CharTokenizer()
    tools = [agent_tool(fn) for fn in (get_weather, search_flights, book_hotel)]
    local = TorchLocalModelClient(engine=engine, tokenizer=tok, max_new_tokens=CLIENT_MAX_TOKENS)
    model = MeshTurnModel(local)
    agent = Agent(
        MESH_AGENT, model=model, instructions=AGENT_INSTRUCTIONS, tools=tools,
        model_settings=ModelSettings(max_tokens=CLIENT_MAX_TOKENS), stream_tokens=True,
    )
    mesh = InMemoryMesh()
    first_token: "dict[str, float]" = {}
    out: dict = {}
    with graphs.eager() if eager else contextlib.nullcontext():
        await local.start()
        try:
            with seeded_client_ids(MESH_ID_SEED):
                async with Worker([agent, *tools], mesh=mesh, max_workers=MESH_LANES):
                    client = Client.connect(mesh)
                    firehose = client.events()

                    async def watch() -> None:
                        async for event in firehose:
                            if event.step.kind == "token":
                                first_token.setdefault(event.correlation_id, time.perf_counter())

                    watcher = asyncio.create_task(watch())
                    try:
                        engine.on_ranks(_rank_reset)
                        comm_before = dict(engine._layout.comm.stats)
                        channel = engine._channel
                        sent_before = (channel.sent, channel.sent_s)
                        with prefill_shapes() as prefills, decode_shapes() as decodes:
                            out["measured"] = await _mesh_round(
                                client, [engine], [model], _mesh_prompts("Trip desk"),
                                first_token)
                        out["ranks"] = engine.on_ranks(_rank_numbers)
                        out["sent"] = (channel.sent - sent_before[0],
                                       channel.sent_s - sent_before[1])
                        out["comm"] = {k: out["ranks"][0]["comm"][k] - v
                                       for k, v in comm_before.items()}
                        out["graphs"] = graph_numbers(engine)
                    finally:
                        firehose.close()
                        watcher.cancel()
                        with contextlib.suppress(asyncio.CancelledError):
                            await watcher
                        await client.close()
            out["direct"] = []
            for turn in out["measured"]["turns"]:
                out["direct"] += await asyncio.gather(*[
                    local.request(c["messages"], c["settings"], c["params"])
                    for c in turn["calls"]])
            out["prefill_rows"] = _shape_rows(prefills)
            out["decode_rows"] = _shape_rows(decodes)
            out["rank_cases"] = engine.on_ranks(
                _rank_cases, out["prefill_rows"], out["decode_rows"]) if cases else []
        finally:
            await local.stop()
    rt = engine.runtime
    out["free_pages"], out["cached"] = engine._page_alloc.free_pages, engine._prefix.size
    assert out["free_pages"] + out["cached"] == rt.pool_pages() - 1, (
        out["free_pages"], out["cached"])
    assert len(engine._free) == rt.max_batch_size and not engine._active
    return out


def _tp_checks(cfg, params, r: dict, dev) -> dict:
    """A tp = 2 round's law: the tie law on its engine turns and their
    direct requests, #5 and #2 launched on both ranks alike, each rank at
    half the heads → its numbers."""
    tok = CharTokenizer()
    calls = [c for turn in r["measured"]["turns"] for c in turn["calls"]]
    streams = tie_law(cfg, params, [
        (c["corr"], [tok.bos_id, *tok.encode(render_messages(c["messages"], c["params"]))],
         _stream_ids(tok, c["response"]), _stream_ids(tok, d))
        for c, d in zip(calls, r["direct"])
    ], dev, labels=("mesh", "direct"))
    ranks = r["ranks"]
    for rank, numbers in enumerate(ranks):
        launches = numbers["launches"]
        assert launches["prefill_attention"] > 0 and launches["paged_decode_attention"] > 0, \
            (rank, launches)
        assert numbers["kv_heads"] == cfg.n_kv_heads // 2 and numbers["heads"] == cfg.n_heads // 2
    assert ranks[0]["launches"] == ranks[1]["launches"], [n["launches"] for n in ranks]
    t1, t2 = (_mesh_turn_numbers(t, MESH_LANES) for t in r["measured"]["turns"])
    tokens = t1["output_tokens"] + t2["output_tokens"]
    comm, sent = r["comm"], r["sent"]
    collectives = comm["all_reduce"] + comm["all_gather"]
    return dict(
        turn1=t1, turn2=t2, output_tokens=tokens, tok_s=tokens / r["measured"]["wall_s"],
        wall_s=r["measured"]["wall_s"], streams=streams, engine_turns=len(calls),
        launches={rank: n["launches"] for rank, n in enumerate(ranks)},
        peak={rank: n["peak"] for rank, n in enumerate(ranks)},
        descriptors=sent[0], descriptor_ms=sent[1] * 1e3 / max(sent[0], 1),
        collectives=comm, collective_ms=comm["seconds"] * 1e3 / max(collectives, 1),
        prefill_shapes=r["prefill_rows"], decode_shapes=r["decode_rows"],
        graphs=r["graphs"], free_pages=r["free_pages"], cached=r["cached"],
        rank_cases=[[{k: c[k] for k in ("name", "shape", "max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms")} for c in cases]
                    for cases in r["rank_cases"]],
    )


def _tp_note(name: str, res: dict, card: str) -> str:
    t1, t2, comm, streams = res["turn1"], res["turn2"], res["collectives"], res["streams"]
    ranks = res["launches"]
    return (
        f"  {name} ({card}): 8 conversations x 2 turns through Client.execute, "
        f"{res['output_tokens']} tokens at {res['tok_s']:.1f} tok/s over the round's "
        f"{res['wall_s']:.2f} s; TTFT turn 1 median {t1['engine_ttft_median_ms']:.1f} ms, turn "
        f"2 {t2['engine_ttft_median_ms']:.1f} ms; {res['descriptors']} dispatch descriptors at "
        f"{res['descriptor_ms']:.3f} host ms each; {comm['all_reduce'] + comm['all_gather']} "
        f"collectives on rank 0 at {res['collective_ms']:.3f} host ms each "
        f"({comm['all_reduce']} all-reduces, {comm['all_gather']} gathers); peak allocation "
        f"rank 0 {res['peak'][0] / 1e9:.2f} GB, rank 1 {res['peak'][1] / 1e9:.2f} GB; launches "
        f"rank 0 {ranks[0]}, rank 1 {ranks[1]}; prefill by (B, Sq, Skv) "
        f"{[(r['B'], r['S'], r['window'], r['launches']) for r in res['prefill_shapes']]}, paged "
        f"decode by (B, wpages) "
        f"{[(r['B'], r['window'], r['launches']) for r in res['decode_shapes']]}; graphs "
        f"captures {res['graphs']['captures']} replays {res['graphs']['replays']} eager "
        f"{res['graphs']['eager']}; the {res['engine_turns']} engine turns and their direct "
        f"requests within {TIE_SPACINGS} bf16 spacings of the f32 plain forward's top logit "
        f"(max gap {streams['max_gap']:.3f}, {len(streams['diverged'])} parting at a tie); "
        f"pages free {res['free_pages']} + cached {res['cached']}"
    )


async def tp_nccl_drive(dev, cfg, params, card: str = "") -> dict:
    """Phase 19's round at tp = 2 over NCCL on CUDA graphs (two or more
    cards): the engine spawns rank 1 on card 1 and joins it over NCCL,
    both drawing their shard of ``cfg`` from the seed (``params`` is the
    whole model the seed draws, the tie law's witness).  The checks of
    :func:`_tp_checks`, every dispatch captured (none eager), and rank 1
    exits 0 once ``stop()`` (graphs freed first, then the group left
    within ``Workers.LEAVE_S``) returns."""
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    engine = InferenceEngine(cfg, TP_RUNTIME, seed=TP_SEED, device=dev)
    assert engine._layout.comm.backend == "nccl"
    procs = list(engine._workers.procs)
    nccl = _tp_checks(cfg, params, await _tp_round(engine, eager=False, cases=False), dev)
    nccl["seconds"] = time.perf_counter() - t
    exits = [p.exitcode for p in procs]
    print(_tp_note(f"tp=2 {cfg.name} ({cfg.n_layers} layers) bf16 over NCCL, one card a rank, "
                   "on CUDA graphs", nccl, card) + f"; rank 1 exit code {exits[0]}; "
          f"{nccl['seconds']:.1f} s for the drive")
    assert nccl["graphs"]["captures"] > 0 and nccl["graphs"]["eager"] == 0, nccl["graphs"]
    assert engine._workers is None and exits == [0], exits
    del engine
    return nccl


async def tp_phase(dev, agent_mesh: "dict | None" = None, card: str = "") -> dict:
    """Phase 19: llama-3-8b bf16 at ``RuntimeConfig(tp=2)`` in two processes
    sharing the one card over gloo (``TP_RUNTIME``: phase 15's paged
    runtime without the ragged lane).  Rank 1 is a spawned process running
    ``distributed.serve_worker``; rank 0 (this process) builds the engine
    on its shard of the seed's model and serves phase 15's agent round
    (:func:`_tp_round`) under ``graphs.eager()`` (gloo collectives cannot
    live in a CUDA graph).  Checks (:func:`_tp_checks`): every engine turn
    and a direct request on its messages under phase 13's tie law against
    the f32 plain forward of the whole model; #5 and #2 launched on BOTH
    ranks, equally; each rank's #5 and #2 against their plain versions at
    its own heads (H = 16, K = 4); no page or slot leaked after
    ``stop()``; rank 1 exits 0.  Prints decode tok/s beside phase 15's
    tp = 1 figure, the host ms a dispatch's descriptor adds, the host ms
    of one gloo collective, each rank's peak allocation and launches, and
    the phase's seconds.  With two or more cards the same round follows at
    tp = 2 over NCCL (one card a rank, the engine spawning rank 1) on CUDA
    graphs, under the same checks; with one card a line says it did not
    run."""
    import multiprocessing

    from calfkit_tpu_torch.inference import distributed as D

    started = time.perf_counter()
    cfg, rt = preset("llama-3-8b"), TP_RUNTIME
    tmp = tempfile.TemporaryDirectory(prefix="calfkit-tp-")
    coordinator = "file://" + os.path.join(tmp.name, "store")
    ctx = multiprocessing.get_context("spawn")
    worker = ctx.Process(target=_tp_rank1, args=(coordinator, cfg, rt, str(dev)),
                         name="calfkit-rank-1")
    worker.start()
    try:
        info = D.initialize_multihost(coordinator, 2, 0, backend="gloo")
        assert info.num_processes == 2 and info.process_id == 0, info
        generator = torch.Generator(device=dev)
        generator.manual_seed(TP_SEED)
        params = M.init_params(cfg, generator)  # the whole model: the tie law's witness
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        engine = InferenceEngine(cfg, rt, params=params, device=dev)
        assert engine._kv_heads == cfg.n_kv_heads // 2 and engine._layout.comm.backend == "gloo"
        r = await _tp_round(engine, eager=True, cases=True)
        worker.join(120)
        assert worker.exitcode == 0, f"rank 1 ended with {worker.exitcode}"
    finally:
        if worker.is_alive():
            worker.kill()
            worker.join(10)
        D.shutdown_group()
        tmp.cleanup()
    del engine
    result = _tp_checks(cfg, params, r, dev)
    result["seconds"] = time.perf_counter() - started
    tp1 = agent_mesh["tok_s"] if agent_mesh else None
    print(_tp_note("tp=2 llama-3-8b bf16 in two processes on one card over gloo, under "
                   "graphs.eager()", result, card)
          + f"; phase 15's tp=1 on graphs: "
          f"{'not measured' if tp1 is None else f'{tp1:.1f}'} tok/s; rank 1 joined; "
          f"{result['seconds']:.1f} s for the drive")
    for rank, cases in enumerate(result["rank_cases"]):
        for c in cases:
            print(f"    rank {rank} {c['name']} at {c['shape']}: max abs err "
                  f"{c['max_abs_err']:.2e}, {c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, bound "
                  f"{c['bound_ms']:.4f} by {c['bound_by']}, library {c['library_ms']})")
    if dev.type == "cuda" and torch.cuda.device_count() >= 2:
        result["nccl"] = await tp_nccl_drive(dev, cfg, params, card)
    else:
        result["nccl"] = "not run: the machine has one card"
        print(f"  tp=2 over NCCL on CUDA graphs: {result['nccl']}")
    del params
    result["seconds"] = time.perf_counter() - started
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every measurement to this JSON file")
    parser.add_argument("--wire-client", metavar="URL",
                        help="run phase 16's Client against URL (the phase starts this)")
    args = parser.parse_args()
    if args.wire_client:
        return asyncio.run(wire_client(args.wire_client))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    install_tallies()  # before any engine captures a graph
    t0 = time.perf_counter()

    def stage(name: str) -> None:
        print(f"{name} (at {time.perf_counter() - t0:.0f} s, "
              f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated)", flush=True)

    def release() -> None:
        # a finished phase's engine sits in reference cycles (its tasks and
        # callbacks): collect them before the cache is emptied, or its pool
        # and graph pools stay allocated into the next phase
        gc.collect()
        torch.cuda.empty_cache()

    # the brokers and the CRC library build beside the kernels; the wire
    # client, first imported in phase 16, loads the CRC built here
    def build_native() -> "tuple[dict, float]":
        t = time.perf_counter()
        return _native.build_native(), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native)
        built = kernels.build_all()
        print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
        native_built, native_s = native.result()
    _native.use_native_builds(native_built)
    print(f"built {sorted(native_built)} from native/ with {_native.compiler_versions()} in "
          f"{native_s:.1f} s (beside the kernels)")

    stage("kernel phase")
    cases, main_cases = kernel_phase(dev)
    stage("exactness phase")
    exact = asyncio.run(exactness_phase(dev))
    release()
    stage("serving phase")
    serving = asyncio.run(serving_phase(dev))
    release()
    stage("paged serving phase")
    paged = asyncio.run(paged_serving_phase(dev))
    release()
    stage("speculative serving phases")
    spec_paged = asyncio.run(paged_serving_phase(dev, speculative=True))
    release()
    spec_dense = asyncio.run(spec_serving_phase(dev))
    release()
    stage("client phase")
    client = asyncio.run(client_phase(dev, card))
    release()
    stage("quantized exactness phase")
    quant_exact = asyncio.run(quant_exactness_phase(dev))
    release()
    stage("checkpoint phase")
    ckpt = asyncio.run(checkpoint_phase(dev, card))
    release()
    stage("north-star drives")
    north = {}
    bf16_weights: dict = {}  # the last bf16 drive's weights, for phase 13
    # int4 serves one wave of 8: the script's time stays down (its weights'
    # dequant, not the rows, sets a dispatch's time); bf16 serves one too,
    # to compare int4 with at the same load
    for key, quantization, requests in (
        ("int8", "int8", NORTH_STAR_REQUESTS), ("bf16", None, NORTH_STAR_REQUESTS),
        ("int4-8", "int4", 8), ("bf16-8", None, 8),
    ):
        north[key] = asyncio.run(north_star_phase(
            dev, quantization, card, requests, keep=bf16_weights if key == "bf16-8" else None))
        release()
    stage("graph phase")
    graph = asyncio.run(graph_phase(dev, card))
    release()
    stage("paged decode and ragged kernels at their serving phases' shapes")
    for name, shapes in (("paged_decode_attention", paged["decode_shapes"]),
                         ("ragged_attention", spec_dense["verify_shapes"]),
                         ("ragged_attention_paged", spec_paged["verify_shapes"])):
        main_cases[name] = path_case(dev, name, shapes)
        cases.append(main_cases[name])
    stage("prefill and paged decode kernels at the client phase's shapes")
    cases += [path_case(dev, "prefill_attention", client["prefill_shapes"]),
              path_case(dev, "paged_decode_attention", client["decode_shapes"], "client")]
    stage("prefill and paged decode kernels at the checkpoint phase's and the int8 north "
          "star's shapes")
    cases += [
        path_case(dev, "prefill_attention", ckpt["prefill_shapes"]),
        path_case(dev, "paged_decode_attention", ckpt["decode_shapes"], "checkpoint"),
        path_case(dev, "prefill_attention", north["int8"]["prefill_shapes"]),
        path_case(dev, "paged_decode_attention", north["int8"]["decode_shapes"],
                  "north star int8", n_pages=NORTH_STAR_RUNTIME.pool_pages()),
    ]
    stage("overload phase")
    weights = bf16_weights.pop("params")
    overload, overload_cases = asyncio.run(overload_phase(dev, weights, card))
    cases += overload_cases
    release()
    stage("long-context lane phase")
    long_lane, long_cases = asyncio.run(long_lane_phase(dev, weights, card))
    cases += long_cases
    release()
    stage("agent mesh phase")
    agent_mesh = asyncio.run(agent_mesh_phase(dev, weights, card))
    release()
    stage("prefill and paged decode kernels at the agent mesh phase's shapes")
    cases += [path_case(dev, "prefill_attention", agent_mesh["prefill_shapes"]),
              path_case(dev, "paged_decode_attention", agent_mesh["decode_shapes"],
                        "agent mesh")]
    wire_mesh = {}
    for transport in WIRE_TRANSPORTS:
        stage(f"wire mesh phase over {transport}://")
        wire_mesh[transport] = asyncio.run(
            wire_mesh_phase(dev, weights, transport, agent_mesh, card))
        release()
    stage("prefill and paged decode kernels at the wire mesh phase's shapes")
    cases += [path_case(dev, "prefill_attention", wire_mesh["kafka"]["prefill_shapes"]),
              path_case(dev, "paged_decode_attention", wire_mesh["kafka"]["decode_shapes"],
                        "wire mesh over kafka://")]
    stage("fleet phase")
    fleet = asyncio.run(fleet_phase(dev, weights, agent_mesh, card))
    release()
    stage("prefill and paged decode kernels at the fleet phase's shapes")
    cases += [path_case(dev, "prefill_attention", fleet["prefill_shapes"]),
              path_case(dev, "paged_decode_attention", fleet["decode_shapes"], "fleet")]
    stage("typed agent phase")
    typed = asyncio.run(typed_agent_phase(dev, weights, card))
    del weights
    release()
    stage("prefill and paged decode kernels at the typed agent phase's shapes")
    cases += [path_case(dev, "prefill_attention", typed["prefill_shapes"]),
              path_case(dev, "paged_decode_attention", typed["decode_shapes"], "typed agent")]
    stage("tensor-parallel phase (tp=2, two processes)")
    tp = asyncio.run(tp_phase(dev, agent_mesh, card))
    release()
    cases += [c for rank in tp["rank_cases"] for c in rank]

    # each kernel's launches from the path it serves, beside its case at a
    # shape of that path (MAIN_SHAPES, path_case): the dense decode kernel
    # from the dense serving phase; the paged decode and prefill kernels
    # from the paged serving phase; the ragged kernels from the speculative
    # phases
    launch_source = {"decode_attention": serving, "paged_decode_attention": paged,
                     "prefill_attention": paged, "ragged_attention": spec_dense,
                     "ragged_attention_paged": spec_paged}
    line = {"kernels": []}
    for name, c in main_cases.items():
        source, replaces = SOURCES[name]
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launch_source[name]["launches"][name], max_abs_err=c["max_abs_err"],
            ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"], shape=c["shape"],
        )
        if name in ("paged_decode_attention", "ragged_attention_paged"):
            entry.update(sdpa_gathered_ms=c["sdpa_gathered_ms"], gather_sdpa_ms=c["gather_sdpa_ms"])
        if name in ("decode_attention", "prefill_attention"):
            # the long lane's path (phase 14's chunked drive) and the kernel
            # at the lane's shapes
            entry["long_lane"] = dict(
                launches=long_lane["launches"][name],
                cases=[{k: lc[k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms")}
                       for lc in long_cases if lc["name"] == name],
            )
        if agent_mesh["launches"].get(name):
            # the agent mesh's path (phase 15's measured round)
            entry["agent_mesh"] = dict(launches=agent_mesh["launches"][name])
        if any(w["launches"].get(name) for w in wire_mesh.values()):
            # the wire transports' path (phase 16's measured rounds)
            entry["wire_mesh"] = {t: dict(launches=w["launches"][name])
                                  for t, w in wire_mesh.items()}
        if fleet["launches"].get(name):
            # the serving fleet's path (phase 17's measured round), by replica
            entry["fleet"] = dict(launches=fleet["launches"][name], replicas={
                tag: r["launches"].get(name, 0) for tag, r in fleet["replicas"].items()})
        if typed["launches"].get(name):
            # the typed agent's path (phase 18's measured round)
            entry["typed_agent"] = dict(launches=typed["launches"][name])
        if tp["launches"][0].get(name):
            # the tp = 2 path (phase 19's round), each rank's launches and
            # the kernel at that rank's heads
            entry["tp2"] = dict(
                launches={r: n[name] for r, n in tp["launches"].items()},
                cases={r: next(c for c in cases_ if c["name"] == name)
                       for r, cases_ in enumerate(tp["rank_cases"])},
            )
        line["kernels"].append(entry)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, cases=cases, exactness=exact, serving=serving,
                           paged_serving=paged, spec_paged_serving=spec_paged,
                           spec_serving=spec_dense, client=client, quant_exactness=quant_exact,
                           checkpoint=ckpt, north_star=north, graphs=graph,
                           overload=overload, long_lane=long_lane,
                           agent_mesh=agent_mesh, wire_mesh=wire_mesh, fleet=fleet,
                           typed_agent=typed, tp=tp, kernels=line["kernels"]),
                      f, indent=1, default=str)
    print(f"all phases in {time.perf_counter() - t0:.0f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
