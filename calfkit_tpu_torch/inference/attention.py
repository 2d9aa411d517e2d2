"""Attention kernels of the serving path and their plain PyTorch versions.

Two hand-written CUDA kernels (sources in ``calfkit_tpu_torch/csrc/``)
take the place of the JAX package's Pallas kernels on this path:

- :func:`decode_attention` ← ``pallas_attention.decode_attention_pallas``:
  single-query GQA decode over the dense cache window → (o unnormalized,
  m, z), folded with the fresh-token ring by :func:`merged_decode_attention`;
- :func:`prefill_attention` ← ``pallas_attention.prefill_attention_pallas``:
  causal GQA flash attention → normalized output in q's dtype.

Each wrapper runs its kernel when the tensors lie on a CUDA device and its
plain version (``*_reference``) when they lie on the CPU; there is no
switch in between and no fallback from the kernel.  ``launch_counts``
counts kernel launches, so a run can show it went through the kernels.
"""

from __future__ import annotations

import math

import torch

from calfkit_tpu_torch import kernels

launch_counts: dict[str, int] = {"decode_attention": 0, "prefill_attention": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_DECODE_GROUP = 8


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


def _check_aligned16(name: str, *tensors: torch.Tensor) -> None:
    """The kernels copy 16 bytes at a time: every address and every stride
    (of an axis longer than 1) must be a multiple of 16 bytes."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(
            stride * size % 16 for stride, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1
        ):
            raise ValueError(f"{name}: tensors must be 16-byte aligned in address and strides")


def _check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed (status {status})")


# --------------------------------------------------------------------------- #
# decode
# --------------------------------------------------------------------------- #


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
    fn = kernels.function("decode_attention")
    qf = q.to(torch.float32).contiguous()
    lens = base_lens.to(torch.int32).contiguous()
    o = torch.empty((B, K, G, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((B, K, G), dtype=torch.float32, device=q.device)
    z = torch.empty((B, K, G), dtype=torch.float32, device=q.device)
    ks, vs = k_cache.stride(), v_cache.stride()
    with torch.cuda.device(q.device):  # the launching thread's current device
        status = fn(
            _DTYPE_CODES[k_cache.dtype], hd,
            qf.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
            o.data_ptr(), m.data_ptr(), z.data_ptr(),
            B, K, G, W, ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
            1.0 / math.sqrt(hd), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check_status("decode_attention", status)
    launch_counts["decode_attention"] += 1
    return o, m, z


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
    from calfkit_tpu_torch.inference.model import logsumexp_merge, ring_attention_source

    B, _, H, hd = q.shape
    K = k_cache.shape[1]
    qg = q.reshape(B, K, H // K, hd)
    o1, m1, z1 = decode_attention(qg, k_cache, v_cache, base_lens)
    o2, m2, z2 = ring_attention_source(qg, ring_k, ring_v, t)
    out = logsumexp_merge((o1, m1[..., None], z1[..., None]), (o2, m2, z2))
    return out.reshape(B, 1, H, hd).to(q.dtype)


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
    cast to q's dtype."""
    from calfkit_tpu_torch.inference.model import attention_xla

    out = attention_xla(q.float(), k_cache.float(), v_cache.float(), q_pos, seq_lens)
    return out.to(q.dtype)


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
    launch_counts["prefill_attention"] += 1
    return out
