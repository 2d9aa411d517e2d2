"""The work that the traffic needs, counted from the configuration and the
requests alone, whatever kernels the program runs for it: the yardstick of
the rooflines and of ``mfu``.

Peaks are NVIDIA's published dense rates of one H100 SXM (the ones
``chip_smoke.py`` uses): 989 TFLOP/s in bf16 and fp16 on the tensor cores,
3.35 TB/s of HBM.  A position of a prompt "needs" computing unless a
whole page of it, with its whole prefix, was in an earlier prompt of the
run (:class:`PrefixModel`; the last position always computes, as its
logits give the first token).
"""

from __future__ import annotations

import hashlib

import numpy as np

PEAKS = {  # device name substring → peaks
    "H100": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> "dict | None":
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def layer_params(a: dict) -> int:
    """The matmul parameters of one layer (q, k, v, o, gate, up, down)."""
    D, H, K, hd, F = a["d_model"], a["n_heads"], a["n_kv_heads"], a["head_dim"], a["d_ff"]
    return D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * F


def head_params(a: dict) -> int:
    return a["d_model"] * a["vocab"]


def attention_flops(a: dict, start: int, end: int) -> int:
    """Causal attention of the queries at positions [start, end), each over
    its position + 1 keys: 4 hd operations a (query, head, key) (q.k and
    p.v), in every layer."""
    keys = (end * (end + 1) - start * (start + 1)) // 2
    return 4 * a["n_layers"] * a["n_heads"] * a["head_dim"] * keys


def prefill_flops(a: dict, start: int, end: int) -> int:
    """A prompt's positions [start, end) through every layer, its attention,
    and the LM head at its last position."""
    return (
        2 * a["n_layers"] * layer_params(a) * (end - start)
        + attention_flops(a, start, end) + 2 * head_params(a)
    )


def decode_flops(a: dict, keys: int) -> int:
    """One generated token whose query attends ``keys`` positions."""
    return (
        2 * (a["n_layers"] * layer_params(a) + head_params(a))
        + 4 * a["n_layers"] * a["n_heads"] * a["head_dim"] * keys
    )


def decode_attention_bytes(a: dict, keys: int, kv_bytes: int = 2, act_bytes: int = 2) -> int:
    """The least bytes one decode token's attention moves in every layer:
    K and V of its ``keys`` positions, read once, its query read and its
    output written."""
    L, H, K, hd = a["n_layers"], a["n_heads"], a["n_kv_heads"], a["head_dim"]
    return L * (2 * K * hd * kv_bytes * keys + 2 * H * hd * act_bytes)


class PrefixModel:
    """Which leading positions of a prompt an earlier prompt holds, in whole
    pages of ``page`` tokens with their whole prefix."""

    def __init__(self, page: int):
        self.page = page
        self.chains: set[bytes] = set()

    def _chain(self, prompt: "list[int]"):
        h = hashlib.blake2b(digest_size=16)
        ids = np.asarray(prompt, np.int32)
        for i in range(len(prompt) // self.page):
            h.update(ids[i * self.page:(i + 1) * self.page].tobytes())
            yield h.digest()

    def cached(self, prompt: "list[int]") -> int:
        """Positions of ``prompt`` an earlier prompt holds (at most all but
        the last)."""
        n = 0
        for key in self._chain(prompt):
            if key not in self.chains:
                break
            n += self.page
        return min(n, len(prompt) - 1)

    def add(self, prompt: "list[int]") -> None:
        self.chains.update(self._chain(prompt))


def cached_prefixes(records: list, page: int) -> dict:
    """{id(record): positions an earlier prompt held}, where a prompt is
    held once its first token came back (its prefill landed) before the
    request was submitted."""
    model = PrefixModel(page)
    landed = sorted((r for r in records if r.times), key=lambda r: r.times[0])
    out, j = {}, 0
    for r in sorted(records, key=lambda r: r.submit):
        while j < len(landed) and landed[j].times[0] <= r.submit:
            model.add(landed[j].prompt)
            j += 1
        out[id(r)] = model.cached(r.prompt)
    return out
