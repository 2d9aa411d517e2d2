"""Model/runtime configuration for the PyTorch inference backend.

A field-for-field copy of the JAX package's configuration, so the same
knobs mean the same thing in both packages.  The PyTorch engine serves a
subset of them so far and raises ``ValueError`` for the rest (see
:mod:`calfkit_tpu_torch.inference.engine`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    """A Llama-family decoder architecture description."""

    name: str = "debug"
    vocab_size: int = 32000
    d_model: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    d_ff: int = 5632
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    max_seq_len: int = 2048
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def param_count(self) -> int:
        """Approximate parameter count (for memory planning)."""
        embed = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        per_layer = (
            # attention: q, k, v, o
            self.d_model * self.n_heads * self.head_dim
            + 2 * self.d_model * self.n_kv_heads * self.head_dim
            + self.n_heads * self.head_dim * self.d_model
            # mlp: gate, up, down
            + 3 * self.d_model * self.d_ff
            # norms
            + 2 * self.d_model
        )
        return embed + self.n_layers * per_layer + self.d_model


@dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs (off unless ``RuntimeConfig.speculative``
    is set).

    Decode is memory-bandwidth-bound: a normal decode step reads every
    weight to emit ONE token per request.  Speculation drafts ``k``
    candidate tokens cheaply, then a single **verify** dispatch scores all
    k+1 positions against the KV cache — the full weight-read is amortized
    over every accepted token.  Greedy output is token-exact vs
    non-speculative greedy; sampled output keeps the target-model
    distribution via rejection sampling (``sampler.spec_accept_slots``).

    Two drafters behind one seam (:mod:`calfkit_tpu_torch.inference.spec`):

    - ``draft is None`` → **n-gram prompt lookup**: propose the
      continuation of the most recent earlier occurrence of the sequence
      tail within prompt + generated history.  No extra weights, no extra
      device work — the agent-serving workload (tool-call JSON, repeated
      instructions, quoted context) is exactly where it hits.
    - ``draft`` set → a second, smaller **draft model** proposes greedily
      from its own KV cache on the engine's device (pass ``draft_params``
      to the engine for real weights; it may share the target's tensors).
    """

    k: int = 4  # drafted tokens per verify wave (verify scores k+1)
    # n-gram lookup: longest/shortest tail length to match (longer tails
    # first: more context, fewer false continuations)
    ngram_max: int = 3
    ngram_min: int = 1
    # the draft-model seam: a second, smaller architecture.  None → n-gram.
    draft: "ModelConfig | None" = None


@dataclass(frozen=True)
class RuntimeConfig:
    """Serving-engine knobs, field for field as in the JAX package.

    The PyTorch engine serves the dense and paged layouts, single-shot or
    chunked prefill (with ragged unified waves and the prefix cache),
    (overlapped or lockstep) decode and speculative decoding; fields that
    select a part not ported yet raise ``ValueError`` at engine
    construction."""

    max_batch_size: int = 32
    max_seq_len: int = 2048
    # "dense" = [L, B, K, max_seq, hd] per-slot rows; "paged" = block-table
    # pool [L, N, K, page, hd]
    kv_layout: str = "dense"
    page_size: int = 64  # tokens per KV page (paged layout)
    max_pages_per_seq: int = 0  # 0 → derived from max_seq_len
    # total pages in the paged pool (incl. the reserved trash page);
    # 0 → max_batch_size × pages_per_seq + 1 (no oversubscription)
    num_kv_pages: int = 0
    tp: int = 1  # tensor-parallel degree
    dp: int = 1  # data/batch-parallel replicas of the serving engine
    decode_steps_per_dispatch: int = 8  # tokens generated per scheduler tick
    prefill_chunk: int = 512  # prompts pad/bucket to multiples of this
    # admission-wave width cap (requests per prefill dispatch); waves stay
    # power-of-two sized
    max_prefill_wave: int = 8
    # advance an admission one prefill_chunk per scheduler pass instead of
    # the whole bucket at once
    chunked_prefill: bool = False
    # "auto": the hand-written kernels on CUDA tensors, their plain
    # versions on CPU tensors (the only value the PyTorch engine takes)
    attention_impl: str = "auto"
    # long-context lane for prompts of len >= max_seq_len (sequence-parallel)
    long_context: bool = False
    long_new_cap: int = 512  # max new tokens a long request may generate
    long_max_prompt: int = 0  # prompt-length ceiling; 0 → 8 x max_seq_len
    # clamp a long request's max_new_tokens to long_new_cap instead of
    # faulting
    long_clamp_new_tokens: bool = False
    # decode attention window buckets: the decode scan reads only the
    # smallest bucket covering every live row (capped at max_seq_len)
    window_buckets: tuple[int, ...] = (256, 1024, 4096, 16384)
    compilation_cache_dir: str | None = "~/.cache/calfkit_tpu_xla"
    # automatic prefix caching (needs kv_layout="paged" and chunked_prefill)
    prefix_cache: bool = False
    # speculative decoding: None = off
    speculative: "SpecConfig | None" = None
    # overlapped execution: launch decode dispatch N+1 before syncing
    # dispatch N's token block; stop and bound detection run on the device
    # as a per-row done mask, and a row that retires mid-block rides one
    # extra in-flight dispatch (its pad tokens are discarded, its slot frees
    # when that dispatch lands).  False = the lockstep path (sync, then fan
    # out), with identical token streams.
    overlap_dispatch: bool = True
    # ragged unified prefill+decode waves (effective only with
    # chunked_prefill=True and overlap_dispatch=True)
    ragged_waves: bool = True
    ragged_token_budget: int = 0  # tokens per ragged dispatch; 0 = auto
    # entries in the per-slot stop-token table that device-side retirement
    # scans; a request with more stop tokens is rejected when overlap is on
    # (the lockstep host path scans arbitrary-size sets)
    max_stop_tokens: int = 8
    # bound on queued requests per lane; 0 = unbounded
    max_pending: int = 0
    # undrained token blocks per request before a stall-cancel; 0 = unbounded
    max_out_blocks: int = 0
    # seconds without a dispatch landing (work pending) before the engine
    # declares itself wedged; 0 = off
    watchdog_stall_s: float = 0.0
    flightrec_events: int = 4096  # flight-recorder ring capacity (events)
    capacity_samples: int = 0  # occupancy-timeline ring capacity; 0 = off
    # weight-only quantization: "int8" | "int4" | None (native dtype)
    quantization: str | None = None

    def pages_per_seq(self) -> int:
        if self.max_pages_per_seq:
            return self.max_pages_per_seq
        return -(-self.max_seq_len // self.page_size)

    def pool_pages(self) -> int:
        """Total pages in the paged pool (page 0 is the trash page)."""
        if self.num_kv_pages:
            return self.num_kv_pages
        return self.max_batch_size * self.pages_per_seq() + 1


# --------------------------------------------------------------------------- #
# presets
# --------------------------------------------------------------------------- #

PRESETS: dict[str, ModelConfig] = {
    # tiny config for unit tests / CI — compiles in seconds on CPU
    "debug": ModelConfig(
        name="debug",
        vocab_size=512,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        max_seq_len=256,
    ),
    # BASELINE config 2: TinyLlama-1.1B (HF: TinyLlama/TinyLlama-1.1B-Chat)
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b",
        vocab_size=32000,
        d_model=2048,
        n_layers=22,
        n_heads=32,
        n_kv_heads=4,
        d_ff=5632,
        rope_theta=10000.0,
        max_seq_len=2048,
    ),
    # BASELINE config 5 / north star: Llama-3-8B (HF: meta-llama/Meta-Llama-3-8B)
    "llama-3-8b": ModelConfig(
        name="llama-3-8b",
        vocab_size=128256,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        rope_theta=500000.0,
        max_seq_len=8192,
    ),
}


def preset(name: str, **overrides: object) -> ModelConfig:
    cfg = PRESETS[name]
    return replace(cfg, **overrides) if overrides else cfg
