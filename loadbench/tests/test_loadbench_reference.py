"""The plain reference against a decoder written out by hand in float64,
loop by loop, on a tiny model."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from loadbench import weights
from loadbench.reference.decoder import Decoder, int8_rule, widest_gap

ARCH = dict(vocab=11, d_model=8, n_layers=2, n_heads=4, n_kv_heads=2, head_dim=2, d_ff=12,
            rope_theta=10000.0, norm_eps=1e-5, tied=False, dtype="float32")


def _by_hand(p, tokens):
    a = ARCH
    L, D, H, K, hd = a["n_layers"], a["d_model"], a["n_heads"], a["n_kv_heads"], a["head_dim"]
    n = {k: v.double().numpy() for k, v in p["layers"].items()}
    S = len(tokens)

    def norm(x, w):
        return x / math.sqrt((x * x).mean() + a["norm_eps"]) * w

    def rope(vec, pos):
        out = np.empty_like(vec)
        half = hd // 2
        for i in range(half):
            ang = pos * a["rope_theta"] ** (-2 * i / hd)
            c, s = math.cos(ang), math.sin(ang)
            out[i] = vec[i] * c - vec[i + half] * s
            out[i + half] = vec[i + half] * c + vec[i] * s
        return out

    x = [p["embed"].double().numpy()[t].copy() for t in tokens]
    for layer in range(L):
        qs, ks, vs = [], [], []
        for s in range(S):
            h = norm(x[s], n["attn_norm"][layer])
            qs.append([rope(np.einsum("d,dh->h", h, n["wq"][layer][:, j]), s) for j in range(H)])
            ks.append([rope(np.einsum("d,dh->h", h, n["wk"][layer][:, j]), s) for j in range(K)])
            vs.append([np.einsum("d,dh->h", h, n["wv"][layer][:, j]) for j in range(K)])
        for s in range(S):
            attn = []
            for j in range(H):
                kv = j // (H // K)
                scores = [qs[s][j] @ ks[t][kv] / math.sqrt(hd) for t in range(s + 1)]
                w = np.exp(np.array(scores) - max(scores))
                w /= w.sum()
                attn.append(sum(w[t] * vs[t][kv] for t in range(s + 1)))
            x[s] = x[s] + np.einsum("jh,jhd->d", np.array(attn), n["wo"][layer])
        for s in range(S):
            h = norm(x[s], n["mlp_norm"][layer])
            g = h @ n["w_gate"][layer]
            u = h @ n["w_up"][layer]
            x[s] = x[s] + (g / (1 + np.exp(-g)) * u) @ n["w_down"][layer]
    fn = p["final_norm"].double().numpy()
    head = p["lm_head"].double().numpy()
    return np.array([norm(v, fn) @ head for v in x])


def test_the_reference_is_the_decoder_written_out_by_hand():
    p = weights.make(ARCH, 7, "cpu")
    tokens = [3, 1, 4, 1, 5, 9]
    got = Decoder(ARCH, p, "float32").logits(tokens).double().numpy()
    want = _by_hand(p, tokens)
    assert np.allclose(got, want, rtol=1e-4, atol=1e-4)
    tail = Decoder(ARCH, p, "float32").logits(tokens, first=4).double().numpy()
    assert np.allclose(tail, want[4:], rtol=1e-4, atol=1e-4)


def test_the_int8_rule_by_hand():
    w = torch.tensor([[1.0, -2.0], [0.5, 4.0], [-0.25, 1.0]])
    got = int8_rule(w, (0,))
    scale = torch.tensor([1.0 / 127, 4.0 / 127])
    q = torch.tensor([[127.0, -64.0], [64.0, 127.0], [-32.0, 32.0]])  # round half to even
    assert torch.allclose(got, q * scale)


def test_int8_reference_weights_change_the_logits_a_little():
    p = weights.make(dict(ARCH, dtype="bfloat16"), 7, "cpu")
    arch = dict(ARCH, dtype="bfloat16")
    full = Decoder(arch, p, "bfloat16").logits([1, 2, 3])
    quant = Decoder(arch, p, "int8").logits([1, 2, 3])
    diff = (full - quant).abs().max().item()
    assert 0 < diff < 0.1 * full.abs().max().item()


def test_widest_gap():
    logits = torch.tensor([[0.0, 2.0, 1.5], [3.0, 1.0, 0.0]])
    assert widest_gap(logits, [1, 0]) == 0.0
    assert widest_gap(logits, [2, 0]) == pytest.approx(0.5)
    assert widest_gap(logits, [1, 2]) == pytest.approx(3.0)


def test_weights_are_made_from_the_seed():
    a = weights.make(dict(ARCH, dtype="bfloat16"), 2**40 + 3, "cpu")
    b = weights.make(dict(ARCH, dtype="bfloat16"), 2**40 + 3, "cpu")
    c = weights.make(dict(ARCH, dtype="bfloat16"), 2**40 + 4, "cpu")
    assert torch.equal(a["layers"]["w_up"], b["layers"]["w_up"])
    assert not torch.equal(a["layers"]["w_up"], c["layers"]["w_up"])
    assert a["layers"]["wq"].dtype == torch.bfloat16
