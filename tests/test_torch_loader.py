"""The PyTorch port's checkpoint path against ``calfkit_tpu``'s: the
safetensors reader, ``config_from_hf``, ``load_params`` (plain, int8 and
int4, quantized on the host), ``HFTokenizer`` and the model client's
``checkpoint=`` / ``draft_checkpoint=``.

The test writes its own debug-sized HF checkpoints (HF Llama naming, the
transposed ``[out, in]`` projection layout): F32 in one file, BF16 in one
file, and BF16 in two shards behind ``model.safetensors.index.json``, each
with a ``config.json``; the BF16 one also holds a small word-level
tokenizer.  Loaded leaves must be IDENTICAL to the JAX loader's (bf16
compared by bits), and the greedy event streams of the two model clients
built from the same directory must be equal.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from safetensors import safe_open  # noqa: E402
from safetensors.numpy import save_file as save_numpy  # noqa: E402
from safetensors.torch import save_file as save_torch  # noqa: E402

from calfkit_tpu.engine.model_client import ModelSettings as JaxSettings  # noqa: E402
from calfkit_tpu.inference import loader as JL  # noqa: E402
from calfkit_tpu.inference import model as JM  # noqa: E402
from calfkit_tpu.inference.client import JaxLocalModelClient  # noqa: E402
from calfkit_tpu.inference.config import RuntimeConfig as JaxRuntime  # noqa: E402
from calfkit_tpu.inference.quant import quantize_shardings  # noqa: E402
from calfkit_tpu.inference.sharding import make_mesh, param_shardings  # noqa: E402
from calfkit_tpu.inference.tokenizer import HFTokenizer as JaxHFTokenizer  # noqa: E402
from calfkit_tpu.models import messages as JMsg  # noqa: E402
from calfkit_tpu_torch.engine.model_client import ModelSettings  # noqa: E402
from calfkit_tpu_torch.exceptions import InferenceError  # noqa: E402
from calfkit_tpu_torch.inference import TorchLocalModelClient  # noqa: E402
from calfkit_tpu_torch.inference import loader as TL  # noqa: E402
from calfkit_tpu_torch.inference._safetensors import SafetensorsFile  # noqa: E402
from calfkit_tpu_torch.inference.config import RuntimeConfig, SpecConfig  # noqa: E402
from calfkit_tpu_torch.inference.tokenizer import HFTokenizer  # noqa: E402
from calfkit_tpu_torch.models import user_message  # noqa: E402
from tests._torch_port import JAX_CFG, TORCH_CFG, to_mesh  # noqa: E402

KINDS = ["f32", "bf16", "sharded"]
WORDS = ["the", "agent", "calls", "a", "tool", "weather", "in", "Lisbon", "is", "sunny"]


def _hf_tensors(params) -> "dict[str, np.ndarray]":
    """The debug params (f32 numpy) under HF names, projections [out, in]."""
    D, H, K, hd = JAX_CFG.d_model, JAX_CFG.n_heads, JAX_CFG.n_kv_heads, JAX_CFG.head_dim
    c = np.ascontiguousarray  # a transposed view would store untransposed bytes
    layers = params["layers"]
    tensors = {
        "model.embed_tokens.weight": params["embed"],
        "model.norm.weight": params["final_norm"],
        "lm_head.weight": c(params["lm_head"].T),
    }
    for i in range(JAX_CFG.n_layers):
        pre = f"model.layers.{i}."
        tensors[pre + "self_attn.q_proj.weight"] = c(layers["wq"][i].reshape(D, H * hd).T)
        tensors[pre + "self_attn.k_proj.weight"] = c(layers["wk"][i].reshape(D, K * hd).T)
        tensors[pre + "self_attn.v_proj.weight"] = c(layers["wv"][i].reshape(D, K * hd).T)
        tensors[pre + "self_attn.o_proj.weight"] = c(layers["wo"][i].reshape(H * hd, D).T)
        tensors[pre + "mlp.gate_proj.weight"] = c(layers["w_gate"][i].T)
        tensors[pre + "mlp.up_proj.weight"] = c(layers["w_up"][i].T)
        tensors[pre + "mlp.down_proj.weight"] = c(layers["w_down"][i].T)
        # norms away from 1 so a swapped norm shows
        tensors[pre + "input_layernorm.weight"] = layers["attn_norm"][i] + 0.01 * (i + 1)
        tensors[pre + "post_attention_layernorm.weight"] = layers["mlp_norm"][i] - 0.02 * (i + 1)
    return tensors


def _write_config(path, **extra):
    (path / "config.json").write_text(json.dumps({
        "_name_or_path": "debug-llama",
        "vocab_size": JAX_CFG.vocab_size,
        "hidden_size": JAX_CFG.d_model,
        "num_hidden_layers": JAX_CFG.n_layers,
        "num_attention_heads": JAX_CFG.n_heads,
        "num_key_value_heads": JAX_CFG.n_kv_heads,
        "intermediate_size": JAX_CFG.d_ff,
        "rope_theta": 20000.0,
        "rms_norm_eps": 1e-6,
        "max_position_embeddings": 512,
        "tie_word_embeddings": False,
        **extra,
    }))


def _write_tokenizer(path):
    """A word-level tokenizer over the model's 512 ids: 4 specials, the
    words of :data:`WORDS`, then filler words ``w<i>``."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    names = ["<pad>", "<s>", "</s>", "<unk>", *WORDS]
    names += [f"w{i}" for i in range(JAX_CFG.vocab_size - len(names))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(names)}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>", pad_token="<pad>",
        unk_token="<unk>",
    )
    fast.save_pretrained(str(path))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{kind: directory} and the f32 params they were written from."""
    params = jax.tree.map(np.asarray, JM.init_params(JAX_CFG, jax.random.key(7), jnp.float32))
    tensors = _hf_tensors(params)
    bf16 = {name: torch.tensor(a).to(torch.bfloat16) for name, a in tensors.items()}
    dirs = {kind: tmp_path_factory.mktemp(f"hf-{kind}") for kind in KINDS}
    save_numpy(tensors, str(dirs["f32"] / "model.safetensors"))
    save_torch(bf16, str(dirs["bf16"] / "model.safetensors"))
    names = sorted(bf16)
    shards = {"model-00001-of-00002.safetensors": names[: len(names) // 2],
              "model-00002-of-00002.safetensors": names[len(names) // 2:]}
    for shard, members in shards.items():
        save_torch({name: bf16[name] for name in members}, str(dirs["sharded"] / shard))
    (dirs["sharded"] / "model.safetensors.index.json").write_text(json.dumps({
        "metadata": {"total_size": 0},
        "weight_map": {name: shard for shard, members in shards.items() for name in members},
    }))
    for path in dirs.values():
        _write_config(path)
    _write_tokenizer(dirs["bf16"])
    return dirs, params


def _bits(x) -> np.ndarray:
    """An array or tensor as comparable numpy: bf16 by its 16-bit words."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def _assert_same_tree(ref, port):
    if isinstance(ref, dict):
        assert set(ref) == set(port)
        for key in ref:
            _assert_same_tree(ref[key], port[key])
        return
    a, b = _bits(ref), _bits(port)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b)


# --------------------------------------------------------------------------- #
# the reader, the config, the loader
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("kind", KINDS)
def test_reader_matches_safe_open(checkpoints, kind):
    dirs, _ = checkpoints
    files = sorted(dirs[kind].glob("*.safetensors"))
    assert len(files) == (2 if kind == "sharded" else 1)
    for path in files:
        port = SafetensorsFile(path)
        with safe_open(str(path), framework="pt") as ref:
            assert sorted(port.keys()) == sorted(ref.keys())
            for name in ref.keys():
                _assert_same_tree(ref.get_tensor(name), port.get_tensor(name))


def test_reader_reads_f16_and_metadata(tmp_path):
    path = tmp_path / "f16.safetensors"
    rng = np.random.default_rng(0)
    save_numpy({"h": rng.standard_normal((3, 5)).astype(np.float16),
                "s": np.float16([1.5])}, str(path), metadata={"format": "pt"})
    port = SafetensorsFile(path)
    assert sorted(port.keys()) == ["h", "s"]
    with safe_open(str(path), framework="pt") as ref:
        for name in ("h", "s"):
            _assert_same_tree(ref.get_tensor(name), port.get_tensor(name))
    assert port.get_tensor("h").dtype == torch.float16


def test_reader_refuses_an_unknown_dtype_and_a_short_tensor(tmp_path):
    header = {"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]},
              "b": {"dtype": "F32", "shape": [2], "data_offsets": [2, 6]}}
    raw = json.dumps(header).encode()
    path = tmp_path / "odd.safetensors"
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + bytes(6))
    f = SafetensorsFile(path)
    with pytest.raises(ValueError, match="unsupported dtype 'F8_E4M3'"):
        f.get_tensor("a")
    with pytest.raises(ValueError, match="spans 4 bytes"):
        f.get_tensor("b")


def test_config_from_hf_matches_reference(checkpoints):
    dirs, _ = checkpoints
    ref, port = JL.config_from_hf(dirs["f32"]), TL.config_from_hf(dirs["f32"])
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.name == "debug-llama" and port.rope_theta == 20000.0
    # the defaults, with every optional key absent
    raw = json.loads((dirs["f32"] / "config.json").read_text())
    minimal = {k: raw[k] for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                   "num_attention_heads", "intermediate_size")}
    (dirs["f32"] / "config.json").write_text(json.dumps(minimal))
    try:
        ref, port = JL.config_from_hf(dirs["f32"]), TL.config_from_hf(dirs["f32"])
    finally:
        (dirs["f32"] / "config.json").write_text(json.dumps(raw))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.name == str(dirs["f32"]) and port.n_kv_heads == JAX_CFG.n_heads


def _reference_load(path, quantize):
    config = JL.config_from_hf(path)
    shardings = param_shardings(config, make_mesh(tp=1, dp=1))
    if quantize is not None:
        shardings = quantize_shardings(shardings, bits=8 if quantize == "int8" else 4)
    return JL.load_params(path, config, shardings, quantize=quantize)


@pytest.mark.parametrize("quantize", [None, "int8", "int4"])
@pytest.mark.parametrize("kind", KINDS)
def test_load_params_matches_reference(checkpoints, kind, quantize):
    dirs, _ = checkpoints
    ref = _reference_load(dirs[kind], quantize)
    port = TL.load_params(
        dirs[kind], TL.config_from_hf(dirs[kind]), device="cpu", quantize=quantize
    )
    _assert_same_tree(ref, port)
    assert port["embed"].dtype == torch.bfloat16  # the config's dtype
    assert all(w.is_contiguous() for w in jax.tree.leaves(port))


def test_load_params_transposes_hf_layout(checkpoints):
    """The f32 checkpoint loads in f32 back into the params it was written
    from (norms offset as written)."""
    dirs, params = checkpoints
    config = dataclasses.replace(TL.config_from_hf(dirs["f32"]), dtype="float32")
    port = TL.load_params(dirs["f32"], config, device="cpu")
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        assert np.array_equal(port["layers"][name].numpy(), params["layers"][name]), name
    assert np.array_equal(port["lm_head"].numpy(), params["lm_head"])
    assert np.array_equal(port["embed"].numpy(), params["embed"])
    offsets = 0.01 * np.arange(1, JAX_CFG.n_layers + 1, dtype=np.float32)[:, None]
    np.testing.assert_array_equal(port["layers"]["attn_norm"].numpy(),
                                  params["layers"]["attn_norm"] + offsets)


def test_load_params_refusals(checkpoints, tmp_path):
    dirs, _ = checkpoints
    config = TL.config_from_hf(dirs["f32"])
    with pytest.raises(ValueError, match="unsupported quantization 'fp8'"):
        TL.load_params(dirs["f32"], config, device="cpu", quantize="fp8")
    with pytest.raises(FileNotFoundError, match="no safetensors"):
        TL.load_params(tmp_path, config, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(InferenceError, match="no CUDA device"):
            TL.load_params(dirs["f32"], config)


# --------------------------------------------------------------------------- #
# the tokenizer and the model client
# --------------------------------------------------------------------------- #


def test_hf_tokenizer_matches_reference(checkpoints):
    dirs, _ = checkpoints
    ref, port = JaxHFTokenizer(str(dirs["bf16"])), HFTokenizer(str(dirs["bf16"]))
    assert (port.bos_id, port.eos_id, port.pad_id) == (ref.bos_id, ref.eos_id, ref.pad_id) \
        == (1, 2, 0)
    assert port.vocab_size == ref.vocab_size == JAX_CFG.vocab_size
    text = "the agent calls a tool : weather in Lisbon is sunny"
    ids = port.encode(text)
    assert ids == ref.encode(text) and 3 in ids  # ":" is unknown
    assert ids[:3] == [4, 5, 6]
    with_specials = [1, *ids, 2, 0]
    assert port.decode(with_specials) == ref.decode(with_specials)
    assert port.decode(list(range(500, 512))) == ref.decode(list(range(500, 512)))


RT = dict(max_batch_size=2, max_seq_len=128, prefill_chunk=16, decode_steps_per_dispatch=4,
          kv_layout="paged", page_size=8, chunked_prefill=True, prefix_cache=True)
PROMPTS = ["the agent calls a tool", "weather in Lisbon is sunny"]


async def _client_events(client, make_message, settings):
    try:
        return [
            [e async for e in client.request_stream([make_message(p)], settings)]
            for p in PROMPTS
        ]
    finally:
        await client.stop()


@pytest.mark.parametrize("quantization", [None, "int8"])
async def test_client_from_checkpoint_matches_reference(checkpoints, quantization):
    dirs, _ = checkpoints
    path = str(dirs["bf16"])
    ref_client = JaxLocalModelClient(
        checkpoint=path,
        runtime=JaxRuntime(**RT, attention_impl="pallas_interpret", quantization=quantization),
    )
    ref = await _client_events(ref_client, JMsg.user_message, JaxSettings(max_tokens=12))
    client = TorchLocalModelClient(
        checkpoint=path, runtime=RuntimeConfig(**RT, quantization=quantization), device="cpu"
    )
    assert client.model_name == path
    port = await _client_events(client, user_message, ModelSettings(max_tokens=12))
    assert [[to_mesh(e) for e in events] for events in port] == ref
    assert client.model_name == ref_client.model_name == "debug-llama"
    assert isinstance(client._tokenizer, HFTokenizer)
    engine = client._engine
    assert engine.config == TL.config_from_hf(path) and engine.device.type == "cpu"
    loaded = TL.load_params(path, engine.config, device="cpu", quantize=quantization)
    _assert_same_tree(loaded, engine.params)
    assert all(len(events) > 1 for events in port)  # text streamed before the response


async def test_draft_checkpoint_loads_the_draft(checkpoints):
    dirs, _ = checkpoints
    draft_cfg = TL.config_from_hf(dirs["sharded"])
    runtime = RuntimeConfig(**RT, speculative=SpecConfig(k=2, draft=draft_cfg))
    client = TorchLocalModelClient(
        checkpoint=str(dirs["bf16"]), draft_checkpoint=str(dirs["sharded"]), runtime=runtime,
        device="cpu",
    )
    events = await _client_events(client, user_message, ModelSettings(max_tokens=6))
    assert all(e[-1].response.usage.output_tokens == 6 for e in events)
    drafter = client._engine._drafter
    _assert_same_tree(
        TL.load_params(dirs["sharded"], draft_cfg, device="cpu"), drafter.params
    )
    assert client._engine.stats.spec_proposed > 0


async def test_draft_checkpoint_without_a_draft_config_raises(checkpoints):
    dirs, _ = checkpoints
    for runtime in (RuntimeConfig(**RT), RuntimeConfig(**RT, speculative=SpecConfig(k=2))):
        client = TorchLocalModelClient(
            checkpoint=str(dirs["bf16"]), draft_checkpoint=str(dirs["sharded"]),
            runtime=runtime, device="cpu",
        )
        with pytest.raises(InferenceError, match="speculative.draft is unset"):
            await client.start()
    ref = JaxLocalModelClient(checkpoint=str(dirs["bf16"]),
                              draft_checkpoint=str(dirs["sharded"]))
    with pytest.raises(Exception, match="speculative.draft is unset"):
        await ref.start()


async def test_client_given_a_tokenizer_keeps_it(checkpoints):
    dirs, _ = checkpoints
    tok = object()
    client = TorchLocalModelClient(checkpoint=str(dirs["f32"]), tokenizer=tok, device="cpu")
    await client.start()
    try:
        assert client._tokenizer is tok
        assert client._engine.config.name == "debug-llama"
    finally:
        await client.stop()
