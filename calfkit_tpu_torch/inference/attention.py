"""Attention kernels of the serving path and their plain PyTorch versions.

Hand-written CUDA kernels (sources in ``calfkit_tpu_torch/csrc/``) take the
place of the JAX package's Pallas kernels on this path:

- :func:`decode_attention` ← ``pallas_attention.decode_attention_pallas``:
  single-query GQA decode over the dense cache window → (o unnormalized,
  m, z), folded with the fresh-token ring by :func:`merged_decode_attention`;
- :func:`paged_decode_attention` ←
  ``pallas_attention.paged_decode_attention_pallas``: the same contract,
  with K/V read page by page through block tables out of the whole pool,
  folded with the ring by :func:`merged_paged_decode_attention`;
- :func:`prefill_attention` ← ``pallas_attention.prefill_attention_pallas``:
  causal GQA flash attention → normalized output in q's dtype;
- :func:`ragged_attention` ← ``pallas_attention.ragged_attention_pallas``:
  multi-query attention under the ragged mask law over the dense window
  → (o, m, z), folded with the speculative verify chunk by
  :func:`verify_attention`;
- :func:`ragged_attention_paged` ←
  ``pallas_attention.ragged_attention_paged_pallas``: the same through block
  tables out of the whole pool, folded by :func:`verify_attention_paged`.

Each wrapper runs its kernel when the tensors lie on a CUDA device and its
plain version (``*_reference``) when they lie on the CPU; there is no
switch in between and no fallback from the kernel.  ``launch_counts``
counts kernel launches, so a run can show it went through the kernels; a
launch captured into a CUDA graph counts at each replay, not at its
capture (``graphs.CapturedDispatch``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from calfkit_tpu_torch import kernels

launch_counts: dict[str, int] = {
    "decode_attention": 0, "paged_decode_attention": 0, "prefill_attention": 0,
    "ragged_attention": 0, "ragged_attention_paged": 0,
}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_DECODE_GROUP = 8


# engines dispatch on their own worker threads: counts change under a lock,
# and a launch made while this thread captures a CUDA graph goes to that
# capture's count (``_capturing.counts``; graphs.py adds it at each replay)
_count_lock = threading.Lock()
_capturing = threading.local()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0


def add_launches(name: str, n: int) -> None:
    with _count_lock:
        launch_counts[name] += n


def _launched(name: str) -> None:
    counts = getattr(_capturing, "counts", None)
    if counts is not None:  # captured: counted at each replay
        counts[name] = counts.get(name, 0) + 1
    else:
        add_launches(name, 1)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU; raises when the tensors mix
    devices or lie on a device no kernel here serves."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"attention inputs lie on several devices: {devices}")
    kind = next(iter(devices)).type
    if kind == "cpu":
        return True
    if kind != "cuda":
        raise ValueError(f"no attention kernel for device type {kind!r}")
    return False


def _check_kv(name: str, k_cache: torch.Tensor, v_cache: torch.Tensor) -> None:
    if k_cache.dtype != v_cache.dtype or k_cache.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"{name}: K/V must share a dtype among float32/bfloat16 "
            f"(got {k_cache.dtype}, {v_cache.dtype})"
        )
    if k_cache.shape != v_cache.shape:
        raise ValueError(f"{name}: K/V shapes differ: {k_cache.shape} vs {v_cache.shape}")
    if k_cache.stride(-1) != 1 or v_cache.stride(-1) != 1:
        raise ValueError(f"{name}: K/V head_dim must be the unit-stride axis")


def _aligned16(t: torch.Tensor) -> bool:
    """Its address and every stride (of an axis longer than 1, but the last)
    a multiple of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and not any(
        stride * size % 16 for stride, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1
    )


def _check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """The kernels copy 16 bytes at a time: every address and every stride
    (of an axis longer than 1) must be a multiple of 16 bytes."""
    if not all(_aligned16(t) for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned in address and strides")


_STATUS = {-1: "shape or type not supported", -2: "a TMA tensor map could not be encoded"}


def _check_status(name: str, status: int) -> None:
    """Raise on a C entry point's non-zero status: a CUDA error code, or
    one of ``_STATUS``."""
    if status != 0:
        reason = _STATUS.get(status, "CUDA error")
        raise RuntimeError(f"{name} kernel launch failed (status {status}: {reason})")


# --------------------------------------------------------------------------- #
# the split-window kernels (decode and ragged; csrc/split_attention.cuh)
# --------------------------------------------------------------------------- #

_TILE = 64  # kv positions a tile
_MAX_SPLITS = 64  # splits of one window
_BLOCKS_PER_SM = 3  # blocks an SM over a full window (it holds two; short rows leave fewer)
_MIN_SPLIT_TILES = 4  # a block's start and its share of the fold want this much work


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(groups: int, window: int, sms: int) -> tuple[int, int]:
    """How the decode and ragged kernels cut a ``window`` of positions
    across blocks, for ``groups`` blocks a split (a query tile of a (row,
    kv head) each) on a card of ``sms`` SMs → (splits, positions a split).

    A split is a run of whole 64-position tiles, at least four (a block's
    start, its partial and its share of the fold cost about as much as a few
    tiles), sized so that a full window gives about three blocks an SM,
    with at most 64 splits.  An SM holds two blocks of the bf16 kernel at
    once, and splits past a row's length exit at once, so rows that stop
    short of the window fill about one wave (of 2, 3 and 4 blocks an SM,
    3 timed best on ``chip_smoke.kernel_plan()``'s cases)."""
    tiles = max(1, -(-window // _TILE))
    want = max(1, -(-_BLOCKS_PER_SM * sms // max(groups, 1)))
    per = min(tiles, max(_MIN_SPLIT_TILES, -(-tiles // want), -(-tiles // _MAX_SPLITS)))
    return -(-tiles // per), per * _TILE


def _block_rows(SG: int, kv_dtype: torch.dtype) -> int:
    """The query rows a block of the split or walk kernels takes for S*G
    rows a (row, kv head): one tile of 16 (bf16 caches) or 8 (f32) where
    S*G fits it, else tiles of 32; the kernels take the rows they are given
    and refuse any other count."""
    rows = 16 if kv_dtype == torch.bfloat16 else 8
    return rows if SG <= rows else 32


def _block_plan(
    q: torch.Tensor, kv_dtype: torch.dtype, window: int
) -> tuple[int, int, int]:
    """→ (query rows a block, splits, positions a split) for a launch of
    the decode ([B, K, G, hd] q) or ragged ([B, K, S, G, hd] q) split
    kernel on q's card over ``window`` positions."""
    B, K = q.shape[:2]
    SG = math.prod(q.shape[2:-1])
    block_rows = _block_rows(SG, kv_dtype)
    groups = B * K * -(-SG // block_rows)
    return (block_rows, *split_plan(groups, window, _sm_count(q.device.index)))


def kernel_split_plan(
    q: torch.Tensor, kv_dtype: torch.dtype, window: int
) -> tuple[int, int]:
    """:func:`split_plan` as a launch of the decode or ragged kernel on q
    over ``window`` positions takes it → (splits, positions a split)."""
    return _block_plan(q, kv_dtype, window)[1:]


# --------------------------------------------------------------------------- #
# the paged walk (bf16 pools; csrc/paged_attention.cuh)
# --------------------------------------------------------------------------- #

_MIN_CHUNK_TILES = 4  # the least tiles a chunk of the walk, where there are enough


def walk_unit_tiles(
    starts: "list[int]", lens: "list[int]", K: int, S: int, G: int, block_rows: int,
    window: int, tile: int = _TILE,
) -> "list[int]":
    """The tiles of each unit of the paged walk (a row, kv head and query
    tile of ``block_rows`` rows), in its order u = (b * K + k) * qtiles +
    qt: ceil(stop / tile) with stop = min(kv_len, start + j_last + 1), the
    positions the tile's last query sees (kv_len clamped to the window),
    and at least one, so that a unit that sees nothing still has a writer."""
    SG = S * G
    qtiles = -(-SG // block_rows)
    out = []
    for start, n in zip(starts, lens):
        kv_len = max(0, min(n, window))
        per_head = []
        for qt in range(qtiles):
            j_last = (min(block_rows, SG - qt * block_rows) + qt * block_rows - 1) // G
            stop = max(0, min(kv_len, start + j_last + 1))
            per_head.append(max(1, -(-stop // tile)))
        out += per_head * K
    return out


def walk_plan(
    unit_tiles: "list[int]", blocks: int, min_tiles: int = _MIN_CHUNK_TILES
) -> "list[list[tuple[int, int, int, int, int]]]":
    """The plan every block of the paged walk computes on the card
    (``paged_walk_attn_kernel``, ``csrc/paged_attention.cuh``): the T tiles
    of all units, in unit order, cut into C = min(blocks, max(1, T //
    min_tiles)) chunks, chunk c the tiles [c T // C, (c + 1) T // C), one a
    block → for each chunk its segments, each (unit, first tile, end tile
    within the unit, partial id u + c, segments of the unit).  A unit of
    one segment is written by that block; the segments of any other write
    their partials at their ids and the last of them folds them in order."""
    T = sum(unit_tiles)
    C = min(blocks, max(1, T // min_tiles))
    starts = [0]
    for n in unit_tiles:
        starts.append(starts[-1] + n)

    def chunk_of(t: int) -> int:
        return ((t + 1) * C - 1) // T

    plan = []
    u = 0
    for c in range(C):
        lo, hi = c * T // C, (c + 1) * T // C
        segments = []
        while starts[u + 1] <= lo:
            u += 1
        pos = lo
        while pos < hi:
            end = min(hi, starts[u + 1])
            n_seg = chunk_of(starts[u + 1] - 1) - chunk_of(starts[u]) + 1
            segments.append((u, pos - starts[u], end - starts[u], u + c, n_seg))
            pos = end
            if end == starts[u + 1]:
                u += 1
        plan.append(segments)
    return plan


def walk_scratch(units: int, blocks: int) -> int:
    """Partials the walk may write: its ids u + c lie below units + blocks,
    a bound that needs no lengths."""
    return units + blocks


@functools.lru_cache(maxsize=None)
def _walk_blocks(name: str, index: int, q_code: int, hd: int, block_rows: int) -> int:
    """The blocks of the paged walk kernel ``name`` that card ``index`` holds
    at once (blocks an SM, by the kernel's registers and shared memory, x
    SMs): its persistent grid."""
    with torch.cuda.device(index):
        blocks = kernels.function(f"{name}_blocks")(q_code, hd, block_rows)
    if blocks < 1:
        _check_status(name, blocks or -1)
    return blocks


# the tensor maps of bf16 pools, by (card, address, shape, strides, dtype):
# the pool never moves, so a map stays right for every later launch (and
# for a launch captured into a CUDA graph); a map depends on nothing but its
# key, so a pool freed and re-allocated at the same address with the same
# geometry gets the same bytes, and one with another geometry another key
_pool_maps: dict[tuple, ctypes.Array] = {}
_MAX_POOL_MAPS = 64


def _pool_map(name: str, pool: torch.Tensor) -> int:
    """→ the host address of ``pool``'s tensor map (128 bytes), encoded at
    first use."""
    key = (pool.device.index, pool.data_ptr(), tuple(pool.shape), pool.stride(), pool.dtype)
    buf = _pool_maps.get(key)
    if buf is None:
        if len(_pool_maps) >= _MAX_POOL_MAPS:
            _pool_maps.clear()
        buf = ctypes.create_string_buffer(128)
        L, N, K, page, hd = pool.shape
        st = pool.stride()
        _check_status(name, kernels.function("pool_tensor_map")(
            ctypes.addressof(buf), pool.data_ptr(), L, N, K, page, hd, st[0], st[1], st[2], st[3],
        ))
        _pool_maps[key] = buf
    return ctypes.addressof(buf)


# per (device, stream): the split and walk kernels' tickets, zero between
# launches (the last block of each query tile resets its own); launches on
# one stream are ordered, so they share one buffer.  A CUDA graph bakes in
# the buffer its capture saw (captures run on the engine's capture stream,
# after an eager run there has sized the buffer): a buffer outgrown by a
# larger launch is kept in ``_outgrown``, never freed under a graph
_tickets: dict[tuple[int, int], torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    buf = _tickets.get((device.index, stream))
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "attention tickets would be allocated inside a CUDA graph capture: "
                "run the captured body eagerly on the capture stream first"
            )
        if buf is not None:
            _outgrown.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _tickets[(device.index, stream)] = buf
    return buf


def _launch_stats(
    name: str, fn, q: torch.Tensor, kv_dtype: torch.dtype, window: int, source: tuple,
    pools: "tuple[torch.Tensor, torch.Tensor, int] | None" = None,
) -> tuple:
    """The launch of the split-window and walk kernels (decode and ragged),
    which return (o, m, z) statistics: q ([B, K, G, hd] or [B, K, S, G,
    hd]) is read in its own dtype through its strides (copied first only
    where the walk's 16-byte loads cannot read it in place); three fresh f32
    outputs and, where the window may take more than one block, f32
    partials for the fold → (o shaped like q, m and z shaped like q[...,
    0]).  ``source`` is the entry point's own arguments after the shared
    ones; ``pools`` (pool_k, pool_v, layer) marks a paged form, whose bf16
    pools take the walk and whose walk arguments are appended."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: q dtype {q.dtype} not supported")
    if q.stride(-1) != 1:
        q = q.contiguous()
    walk = pools is not None and kv_dtype == torch.bfloat16
    if walk and not _aligned16(q):  # the walk reads q 16 bytes at a time: a fresh copy
        q = q.clone(memory_format=torch.contiguous_format)
    q5 = q if q.dim() == 5 else q[:, :, None]
    B, K, S, G, hd = q5.shape
    rows = B * K * S * G
    extra: tuple = ()
    if walk:
        block_rows = _block_rows(S * G, kv_dtype)
        units = B * K * -(-S * G // block_rows)
        # the persistent grid, no larger than the window could give chunks
        blocks = min(
            _walk_blocks(name, q.device.index, _DTYPE_CODES[q.dtype], hd, block_rows),
            max(1, units * -(-window // _TILE) // _MIN_CHUNK_TILES),
        )
        part_rows, n_splits, split_pos = walk_scratch(units, blocks) * block_rows, 0, 0
        extra = (_pool_map(name, pools[0]), _pool_map(name, pools[1]), blocks,
                 _MIN_CHUNK_TILES, pools[2])
    else:
        block_rows, n_splits, split_pos = _block_plan(q, kv_dtype, window)
        units = B * K * -(-S * G // block_rows)
        part_rows = n_splits * rows if n_splits > 1 else 0
        if pools is not None:  # an f32 pool: the split grid, no maps
            extra = (None, None, 0, 0, pools[2])
    # one allocation for o, m and z, one for the partials [part_rows, hd]
    # and their m and z [part_rows]: the serving path is host-bound
    out = torch.empty(rows * (hd + 2), dtype=torch.float32, device=q.device)
    o = out[:rows * hd].view(q.shape)
    m = out[rows * hd:rows * (hd + 1)].view(q.shape[:-1])
    z = out[rows * (hd + 1):].view(q.shape[:-1])
    with torch.cuda.device(q.device):  # the launching thread's current device
        stream = torch.cuda.current_stream(q.device).cuda_stream
        scratch = (None, None, None, None)
        if part_rows:
            part = torch.empty(part_rows * (hd + 2), dtype=torch.float32, device=q.device)
            po = part.data_ptr()
            pm = po + 4 * part_rows * hd
            tickets = _ticket_buffer(q.device, stream, units)
            scratch = (po, pm, pm + 4 * part_rows, tickets.data_ptr())
        qs = q5.stride()
        status = fn(
            _DTYPE_CODES[kv_dtype], _DTYPE_CODES[q.dtype], hd, block_rows, q5.data_ptr(),
            qs[0], qs[1], qs[2], qs[3], o.data_ptr(), m.data_ptr(), z.data_ptr(), *scratch,
            n_splits, split_pos, 1.0 / math.sqrt(hd), stream, *source, *extra,
        )
    _check_status(name, status)
    _launched(name)
    return o, m, z


def _check_pool_page(name: str, pool: torch.Tensor) -> None:
    """A bf16 pool is read by TMA boxes of gcd(page, 64) positions, each
    starting on a 1 KB boundary of the swizzled tile: page a multiple of 8."""
    page = pool.shape[3]
    if pool.dtype == torch.bfloat16 and page % 8:
        raise ValueError(f"{name}: a bf16 pool's page size must be a multiple of 8 (got {page})")


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


def _grouped(q: torch.Tensor, K: int) -> torch.Tensor:
    """[B, 1, H, hd] decode queries → [B, K, G, hd] by kv head."""
    B, _, H, hd = q.shape
    return q.reshape(B, K, H // K, hd)


def _merge_with_ring(
    q: torch.Tensor,  # [B, 1, H, hd]
    qg: torch.Tensor,  # q as [B, K, G, hd]
    source: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # (o, m, z) of the main cache
    ring_k: torch.Tensor,  # [T, B, K, hd]
    ring_v: torch.Tensor,
    t: int,
) -> torch.Tensor:
    """Fold the (tiny) fresh-token ring into a main-cache source with the
    shared logsumexp merge → [B, 1, H, hd] in q's dtype."""
    from calfkit_tpu_torch.inference.model import logsumexp_merge, ring_attention_source

    o1, m1, z1 = source
    out = logsumexp_merge(
        (o1, m1[..., None], z1[..., None]), ring_attention_source(qg, ring_k, ring_v, t)
    )
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,  # [B, K, G, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd]
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the decode kernel, in f32 like the kernel:
    → (o [B,K,G,hd] unnormalized, m [B,K,G], z [B,K,G])."""
    from calfkit_tpu_torch.inference.model import masked_attention_source

    W = k_cache.shape[2]
    valid = torch.arange(W, device=q.device)[None, :] < base_lens[:, None]
    o, m, z = masked_attention_source(
        q.float(), k_cache.float(), v_cache.float(), valid
    )
    return o, m[..., 0], z[..., 0]


def decode_attention(
    q: torch.Tensor,  # [B, K, G, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd], any strides with a unit last axis
    v_cache: torch.Tensor,
    base_lens: torch.Tensor,  # [B] valid kv per row
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (o [B,K,G,hd] f32 unnormalized, m [B,K,G] f32, z [B,K,G] f32).

    Masks kv positions >= base_lens[b] to -1e30 and floors m at -1e29, as
    the Pallas kernel does.  The cache window is read through its strides
    (a ``[:, :, :W]`` view of the engine's cache is never copied)."""
    if _on_cpu(q, k_cache, v_cache, base_lens):
        return decode_attention_reference(q, k_cache, v_cache, base_lens)
    B, K, G, hd = q.shape
    W = k_cache.shape[2]
    _check_kv("decode_attention", k_cache, v_cache)
    if k_cache.shape != (B, K, W, hd) or base_lens.shape != (B,):
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"lens {tuple(base_lens.shape)} do not agree"
        )
    if hd not in _HEAD_DIMS or not 1 <= G <= _MAX_DECODE_GROUP:
        raise ValueError(f"decode_attention: hd={hd}, G={G} not supported")
    _check_aligned16("decode_attention", k_cache, v_cache)
    lens = base_lens.to(torch.int32).contiguous()
    ks, vs = k_cache.stride(), v_cache.stride()
    return _launch_stats(
        "decode_attention", kernels.function("decode_attention"), q, k_cache.dtype, W,
        (k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(), B, K, G, W,
         ks[0], ks[1], ks[2], vs[0], vs[1], vs[2]),
    )


def merged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd] main pages (stale within dispatch)
    v_cache: torch.Tensor,
    ring_k: torch.Tensor,  # [T, B, K, hd] this layer's ring
    ring_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
    t: int,  # current ring step (slots 0..t valid)
) -> torch.Tensor:
    """Softmax over (main cache ⊕ ring): the main-cache source from
    :func:`decode_attention`, the (tiny) ring folded in with the shared
    logsumexp merge → [B, 1, H, hd] in q's dtype."""
    qg = _grouped(q, k_cache.shape[1])
    return _merge_with_ring(
        q, qg, decode_attention(qg, k_cache, v_cache, base_lens), ring_k, ring_v, t
    )


# --------------------------------------------------------------------------- #
# paged decode
# --------------------------------------------------------------------------- #


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B, K, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd] the whole pool
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax] block tables
    base_lens: torch.Tensor,  # [B]
    *,
    wpages: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the paged decode kernel: gather each row's
    window of ``wpages`` pages, then the plain decode attention in f32
    → (o [B,K,G,hd] unnormalized, m [B,K,G], z [B,K,G])."""
    from calfkit_tpu_torch.inference.model import gather_window_paged

    return decode_attention_reference(
        q,
        gather_window_paged(pool_k[layer], tables, wpages),
        gather_window_paged(pool_v[layer], tables, wpages),
        base_lens,
    )


def paged_decode_attention(
    q: torch.Tensor,  # [B, K, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd] the whole pool (never sliced)
    pool_v: torch.Tensor,
    layer: int,  # which layer's pages to read
    tables: torch.Tensor,  # [B, Pmax] int32 block tables
    base_lens: torch.Tensor,  # [B] valid kv per row
    *,
    wpages: int,  # pages per attention window
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged decode attention, the contract of :func:`decode_attention` over
    the window of ``wpages`` pages that ``tables[b]`` names in layer
    ``layer`` of the pool → (o f32 unnormalized, m, z).

    On CUDA the kernel reads each page in place through the block table: a
    bf16 pool by TMA through one tensor map of the whole pool (its page size
    a multiple of 8), the layer and the page as coordinates; no window is
    gathered."""
    if _on_cpu(q, pool_k, pool_v, tables, base_lens):
        return paged_decode_attention_reference(
            q, pool_k, pool_v, layer, tables, base_lens, wpages=wpages
        )
    B, K, G, hd = q.shape
    _check_kv("paged_decode_attention", pool_k, pool_v)
    L, N, _, page = pool_k.shape[:4]
    if (
        pool_k.shape != (L, N, K, page, hd) or tables.dim() != 2
        or tables.shape[0] != B or base_lens.shape != (B,)
    ):
        raise ValueError(
            f"paged_decode_attention: q {tuple(q.shape)}, pool {tuple(pool_k.shape)}, "
            f"tables {tuple(tables.shape)}, lens {tuple(base_lens.shape)} do not agree"
        )
    if not 0 <= layer < L or not 1 <= wpages <= tables.shape[1]:
        raise ValueError(
            f"paged_decode_attention: layer {layer} of {L}, wpages {wpages} of "
            f"{tables.shape[1]} table entries"
        )
    if hd not in _HEAD_DIMS or not 1 <= G <= _MAX_DECODE_GROUP:
        raise ValueError(f"paged_decode_attention: hd={hd}, G={G} not supported")
    k_layer, v_layer = pool_k[layer], pool_v[layer]  # views: nothing is copied
    _check_aligned16("paged_decode_attention", k_layer, v_layer)
    _check_pool_page("paged_decode_attention", pool_k)
    tab = tables.to(torch.int32).contiguous()
    lens = base_lens.to(torch.int32).contiguous()
    ks, vs = k_layer.stride(), v_layer.stride()
    return _launch_stats(
        "paged_decode_attention", kernels.function("paged_decode_attention"), q, pool_k.dtype,
        wpages * page,
        (k_layer.data_ptr(), v_layer.data_ptr(), tab.data_ptr(), lens.data_ptr(),
         B, K, G, wpages, page, tab.stride(0), ks[0], ks[1], ks[2], vs[0], vs[1], vs[2]),
        pools=(pool_k, pool_v, layer),
    )


def merged_paged_decode_attention(
    q: torch.Tensor,  # [B, 1, H, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd]
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax]
    ring_k: torch.Tensor,  # [T, B, K, hd] this layer's ring
    ring_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
    t: int,  # current ring step (slots 0..t valid)
    *,
    wpages: int,
) -> torch.Tensor:
    """The paged counterpart of :func:`merged_decode_attention`: the
    main-cache source from :func:`paged_decode_attention`, the ring folded in
    with the shared logsumexp merge → [B, 1, H, hd] in q's dtype."""
    qg = _grouped(q, pool_k.shape[2])
    source = paged_decode_attention(qg, pool_k, pool_v, layer, tables, base_lens, wpages=wpages)
    return _merge_with_ring(q, qg, source, ring_k, ring_v, t)


# --------------------------------------------------------------------------- #
# prefill
# --------------------------------------------------------------------------- #


def prefill_attention_reference(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k_cache: torch.Tensor,  # [B, K, Skv, hd]
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [B, Sq]
    seq_lens: torch.Tensor,  # [B]
) -> torch.Tensor:
    """The plain version of the prefill kernel: the plain attention in f32,
    cast to q's dtype.  A query that sees no position (seq_lens[b] = 0, or
    q_pos < 0) gives 0, as the kernels and the Pallas kernel do (the running
    max floored at -1e29 makes every p 0), where a softmax over nothing but
    -1e30 scores would give the mean of v."""
    from calfkit_tpu_torch.inference.model import attention_xla

    out = attention_xla(q.float(), k_cache.float(), v_cache.float(), q_pos, seq_lens)
    blind = torch.minimum(q_pos + 1, seq_lens[:, None]) <= 0  # [B, Sq]
    return out.masked_fill(blind[:, :, None, None], 0.0).to(q.dtype)


def prefill_attention(
    q: torch.Tensor,  # [B, Sq, H, hd]
    k_cache: torch.Tensor,  # [B, K, Skv, hd], any strides with a unit last axis
    v_cache: torch.Tensor,
    q_pos: torch.Tensor,  # [B, Sq] absolute positions
    seq_lens: torch.Tensor,  # [B] valid kv per row
) -> torch.Tensor:
    """Causal GQA flash prefill → [B, Sq, H, hd] normalized, in q's dtype.
    Query (b, s) attends kv positions w <= q_pos[b, s] with w < seq_lens[b].
    Any Sq and Skv; no block divisibility is required."""
    if _on_cpu(q, k_cache, v_cache, q_pos, seq_lens):
        return prefill_attention_reference(q, k_cache, v_cache, q_pos, seq_lens)
    B, Sq, H, hd = q.shape
    K, Skv = k_cache.shape[1], k_cache.shape[2]
    _check_kv("prefill_attention", k_cache, v_cache)
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"prefill_attention: q dtype {q.dtype} not supported")
    if (
        k_cache.shape != (B, K, Skv, hd) or q_pos.shape != (B, Sq)
        or seq_lens.shape != (B,) or H % K
    ):
        raise ValueError(
            f"prefill_attention: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}, "
            f"q_pos {tuple(q_pos.shape)}, lens {tuple(seq_lens.shape)} do not agree"
        )
    # a block holds 64 query rows (the M of the bf16 kernel's warpgroup
    # products): 64 / G positions x the G heads of one kv head
    if hd not in _HEAD_DIMS or 64 % (H // K):
        raise ValueError(f"prefill_attention: hd={hd}, G={H // K} not supported")
    if q.stride(-1) != 1:
        raise ValueError("prefill_attention: q's head_dim must be the unit-stride axis")
    if q.dtype == k_cache.dtype == torch.bfloat16:  # the tensor-core kernel
        _check_aligned16("prefill_attention", q, k_cache, v_cache)
    fn = kernels.function("prefill_attention")
    pos = q_pos.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    qs, ks, vs = q.stride(), k_cache.stride(), v_cache.stride()
    with torch.cuda.device(q.device):  # the launching thread's current device
        status = fn(
            _DTYPE_CODES[q.dtype], _DTYPE_CODES[k_cache.dtype], hd,
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            pos.data_ptr(), lens.data_ptr(), out.data_ptr(),
            B, Sq, H, K, Skv,
            qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], pos.stride(0),
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_status("prefill_attention", status)
    _launched("prefill_attention")
    return out


# --------------------------------------------------------------------------- #
# ragged multi-query attention (the speculative verify's main-cache source)
# --------------------------------------------------------------------------- #


def ragged_attention_reference(
    q: torch.Tensor,  # [B, K, S, G, hd]
    k_cache: torch.Tensor,  # [B, K, W, hd]
    v_cache: torch.Tensor,
    q_starts: torch.Tensor,  # [B]
    kv_lens: torch.Tensor,  # [B]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the ragged kernel: the ragged source in f32,
    with f32 probabilities as the kernel keeps them → (o [B,K,S,G,hd]
    unnormalized, m [B,K,S,G], z [B,K,S,G])."""
    from calfkit_tpu_torch.inference.model import ragged_attention_source

    o, m, z = ragged_attention_source(
        q.float().transpose(1, 2), k_cache.float(), v_cache.float(), q_starts, kv_lens
    )  # the merge layout [B, K, G, S, ·] → the kernel's [B, K, S, G, ·]
    return o.transpose(2, 3), m[..., 0].transpose(2, 3), z[..., 0].transpose(2, 3)


def _check_ragged_q(name: str, q: torch.Tensor, B: int, *rows: torch.Tensor) -> None:
    if q.dim() != 5 or q.shape[0] != B or any(r.shape != (B,) for r in rows):
        raise ValueError(
            f"{name}: q {tuple(q.shape)} must be [B, K, S, G, hd] with B = {B} and "
            f"starts/lens {[tuple(r.shape) for r in rows]} of shape [B]"
        )
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name}: hd={q.shape[-1]} not supported")


def ragged_attention(
    q: torch.Tensor,  # [B, K, S, G, hd] kv-head-major ragged queries
    k_cache: torch.Tensor,  # [B, K, W, hd], any strides with a unit last axis
    v_cache: torch.Tensor,
    q_starts: torch.Tensor,  # [B] absolute position of each row's query 0
    kv_lens: torch.Tensor,  # [B] valid kv length each row may attend
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """→ (o [B,K,S,G,hd] f32 unnormalized, m [B,K,S,G] f32, z [B,K,S,G] f32).

    Query j of row b attends kv positions < min(kv_lens[b], q_starts[b] + j
    + 1), masked to -1e30 otherwise, m floored at -1e29, as the Pallas
    kernel does.  Any S and G; the window is read through its strides."""
    if _on_cpu(q, k_cache, v_cache, q_starts, kv_lens):
        return ragged_attention_reference(q, k_cache, v_cache, q_starts, kv_lens)
    name = "ragged_attention"
    _check_kv(name, k_cache, v_cache)
    _check_ragged_q(name, q, k_cache.shape[0], q_starts, kv_lens)
    B, K, S, G, hd = q.shape
    W = k_cache.shape[2]
    if k_cache.shape != (B, K, W, hd):
        raise ValueError(f"{name}: q {tuple(q.shape)} and cache {tuple(k_cache.shape)} differ")
    _check_aligned16(name, k_cache, v_cache)
    starts = q_starts.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    ks, vs = k_cache.stride(), v_cache.stride()
    return _launch_stats(
        name, kernels.function(name), q, k_cache.dtype, W,
        (k_cache.data_ptr(), v_cache.data_ptr(), starts.data_ptr(), lens.data_ptr(),
         B, K, S, G, W, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2]),
    )


def ragged_attention_paged_reference(
    q: torch.Tensor,  # [B, K, S, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd]
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax]
    q_starts: torch.Tensor,  # [B]
    kv_lens: torch.Tensor,  # [B]
    *,
    wpages: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the paged ragged kernel: gather each row's
    window of ``wpages`` pages, then :func:`ragged_attention_reference`."""
    from calfkit_tpu_torch.inference.model import gather_window_paged

    return ragged_attention_reference(
        q,
        gather_window_paged(pool_k[layer], tables, wpages),
        gather_window_paged(pool_v[layer], tables, wpages),
        q_starts, kv_lens,
    )


def ragged_attention_paged(
    q: torch.Tensor,  # [B, K, S, G, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd] the whole pool (never sliced)
    pool_v: torch.Tensor,
    layer: int,  # which layer's pages to read
    tables: torch.Tensor,  # [B, Pmax] int32 block tables
    q_starts: torch.Tensor,  # [B]
    kv_lens: torch.Tensor,  # [B]
    *,
    wpages: int,  # pages per attention window
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Paged ragged attention, the contract of :func:`ragged_attention` over
    the window of ``wpages`` pages that ``tables[b]`` names in layer
    ``layer`` of the pool → (o, m, z).  On CUDA the kernel reads each page
    in place through the block table, as :func:`paged_decode_attention`'s
    does; no window is gathered."""
    if _on_cpu(q, pool_k, pool_v, tables, q_starts, kv_lens):
        return ragged_attention_paged_reference(
            q, pool_k, pool_v, layer, tables, q_starts, kv_lens, wpages=wpages
        )
    name = "ragged_attention_paged"
    _check_kv(name, pool_k, pool_v)
    B = tables.shape[0] if tables.dim() == 2 else -1
    _check_ragged_q(name, q, B, q_starts, kv_lens)
    _, K, S, G, hd = q.shape
    L, N, _, page = pool_k.shape[:4]
    if pool_k.shape != (L, N, K, page, hd):
        raise ValueError(f"{name}: q {tuple(q.shape)} and pool {tuple(pool_k.shape)} differ")
    if not 0 <= layer < L or not 1 <= wpages <= tables.shape[1]:
        raise ValueError(
            f"{name}: layer {layer} of {L}, wpages {wpages} of {tables.shape[1]} table entries"
        )
    k_layer, v_layer = pool_k[layer], pool_v[layer]  # views: nothing is copied
    _check_aligned16(name, k_layer, v_layer)
    _check_pool_page(name, pool_k)
    tab = tables.to(torch.int32).contiguous()
    starts = q_starts.to(torch.int32).contiguous()
    lens = kv_lens.to(torch.int32).contiguous()
    ks, vs = k_layer.stride(), v_layer.stride()
    return _launch_stats(
        name, kernels.function(name), q, pool_k.dtype, wpages * page,
        (k_layer.data_ptr(), v_layer.data_ptr(), tab.data_ptr(), starts.data_ptr(),
         lens.data_ptr(), B, K, S, G, wpages, page, tab.stride(0),
         ks[0], ks[1], ks[2], vs[0], vs[1], vs[2]),
        pools=(pool_k, pool_v, layer),
    )


def _merge_with_chunk(
    q: torch.Tensor,  # [B, S, H, hd]
    qg: torch.Tensor,  # q as [B, S, K, G, hd]
    source: tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # ragged (o, m, z), kernel layout
    chunk_k: torch.Tensor,  # [S, B, K, hd]
    chunk_v: torch.Tensor,
) -> torch.Tensor:
    """Fold the verify chunk's causal self-attention into a main-cache
    ragged source with the shared logsumexp merge → [B, S, H, hd] in q's
    dtype."""
    from calfkit_tpu_torch.inference.model import logsumexp_merge, verify_chunk_source

    o1, m1, z1 = source  # [B, K, S, G, ·] → merge layout [B, K, G, S, ·]
    out = logsumexp_merge(
        (o1.transpose(2, 3), m1.transpose(2, 3)[..., None], z1.transpose(2, 3)[..., None]),
        verify_chunk_source(qg, chunk_k, chunk_v),
    )  # [B, K, G, S, hd]
    return out.permute(0, 3, 1, 2, 4).reshape(q.shape).to(q.dtype)


def verify_attention(
    q: torch.Tensor,  # [B, S, H, hd] the verify chunk's queries
    k_cache: torch.Tensor,  # [B, K, W, hd] main-cache window (read-only)
    v_cache: torch.Tensor,
    chunk_k: torch.Tensor,  # [S, B, K, hd] this layer's chunk K (ring layout)
    chunk_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
) -> torch.Tensor:
    """Multi-query verify attention: ONE :func:`ragged_attention` call
    scores all S queries against the window (verify rows: start = kv_len =
    base_lens), and the chunk's causal self-attention folds in with the
    shared logsumexp merge → [B, S, H, hd] in q's dtype."""
    B, S, H, hd = q.shape
    K = k_cache.shape[1]
    qg = q.reshape(B, S, K, H // K, hd)
    source = ragged_attention(qg.transpose(1, 2), k_cache, v_cache, base_lens, base_lens)
    return _merge_with_chunk(q, qg, source, chunk_k, chunk_v)


def verify_attention_paged(
    q: torch.Tensor,  # [B, S, H, hd]
    pool_k: torch.Tensor,  # [L, N, K, page, hd]
    pool_v: torch.Tensor,
    layer: int,
    tables: torch.Tensor,  # [B, Pmax]
    chunk_k: torch.Tensor,  # [S, B, K, hd]
    chunk_v: torch.Tensor,
    base_lens: torch.Tensor,  # [B]
    *,
    wpages: int,
) -> torch.Tensor:
    """The paged counterpart of :func:`verify_attention`: one
    :func:`ragged_attention_paged` call reads each page once for all S
    queries; the chunk folds in as the second source."""
    B, S, H, hd = q.shape
    K = pool_k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    source = ragged_attention_paged(
        qg.transpose(1, 2), pool_k, pool_v, layer, tables, base_lens, base_lens, wpages=wpages
    )
    return _merge_with_chunk(q, qg, source, chunk_k, chunk_v)
