"""Shared helpers of the PyTorch port's parity tests: the JAX package is the
oracle, and both packages get the same inputs as numpy arrays; the model
client's messages cross between the two packages by field."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch
from pydantic import BaseModel

import calfkit_tpu.engine.model_client as mesh_model_client
import calfkit_tpu.models.capability as mesh_capability
import calfkit_tpu.models.messages as mesh_messages
import calfkit_tpu.models.payload as mesh_payload
import calfkit_tpu_torch.engine.model_client as port_model_client
import calfkit_tpu_torch.models.capability as port_capability
import calfkit_tpu_torch.models.messages as port_messages
import calfkit_tpu_torch.models.payload as port_payload
from calfkit_tpu.inference import model as JM
from calfkit_tpu.inference import quant as JQ
from calfkit_tpu.inference.config import preset as jax_preset
from calfkit_tpu_torch.inference.config import preset as torch_preset
from calfkit_tpu_torch.inference.weights import params_from_numpy

JAX_CFG = jax_preset("debug")
TORCH_CFG = torch_preset("debug")

# the suite runs in several worker processes on few cores: one thread per
# worker for these tiny tensors keeps torch from crowding out the others
torch.set_num_threads(1)


def jax_params(seed: int = 0):
    """The reference tests' debug-preset params: f32, from a JAX key."""
    return JM.init_params(JAX_CFG, jax.random.key(seed), dtype=jnp.float32)


def torch_params(params) -> dict:
    """The same weights as the port's tensors on the CPU."""
    tree = jax.tree.map(np.asarray, params)
    return params_from_numpy(tree, device="cpu")


def quantized_params(bits: int, seed: int = 0):
    """The reference tests' debug-preset params quantized by the JAX
    package (``bits`` 8 or 4), and the same quantized tree as the port's
    CPU tensors (int8 or uint8 payloads, f32 scales)."""
    params = JQ.quantize_params(jax_params(seed), bits=bits)
    return params, torch_params(params)


def t(array, dtype=None) -> torch.Tensor:
    """numpy → CPU tensor."""
    out = torch.from_numpy(np.ascontiguousarray(array).copy())
    return out if dtype is None else out.to(dtype)


def j(array, dtype=None):
    """numpy → JAX array."""
    return jnp.asarray(array) if dtype is None else jnp.asarray(array, dtype)


def n(x) -> np.ndarray:
    """tensor or JAX array → f32-or-int numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if np.issubdtype(x.dtype, np.floating) or x.dtype.name == "bfloat16" else x


# --------------------------------------------------------------------------- #
# the model-client seam: the mesh's pydantic types <-> the port's dataclasses
# --------------------------------------------------------------------------- #


def _types(*modules) -> dict:
    """Every class defined in ``modules``, by name."""
    return {
        name: obj for module in modules for name, obj in vars(module).items()
        if isinstance(obj, type) and obj.__module__ == module.__name__
    }


_PORT_TYPES = _types(port_payload, port_capability, port_messages, port_model_client)
_MESH_TYPES = _types(mesh_payload, mesh_capability, mesh_messages, mesh_model_client)


def to_port(obj):
    """A mesh (pydantic) message, part, setting or parameter object, or a
    list or dict of them → the port's dataclass of the same name, field by
    field."""
    if isinstance(obj, BaseModel):
        cls = _PORT_TYPES[type(obj).__name__]
        return cls(**{name: to_port(getattr(obj, name)) for name in type(obj).model_fields})
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def to_mesh(obj):
    """The inverse of :func:`to_port`: a port dataclass (a message, part or
    stream event) → the mesh's type of the same name."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _MESH_TYPES[type(obj).__name__]
        return cls(**{f.name: to_mesh(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    if isinstance(obj, list):
        return [to_mesh(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_mesh(v) for k, v in obj.items()}
    return obj


class MeshModelClient(mesh_model_client.ModelClient):
    """The port's ``TorchLocalModelClient`` as the mesh's ``ModelClient``:
    an ``Agent`` checks ``isinstance`` against the mesh's own types, which
    the port may not import, so this test-only adapter converts the
    messages, settings and parameters in and the stream events out."""

    def __init__(self, client):
        self.client = client

    @property
    def model_name(self) -> str:
        return self.client.model_name

    async def request(self, messages, settings=None, params=None):
        async for event in self.request_stream(messages, settings, params):
            if isinstance(event, mesh_model_client.ResponseDone):
                return event.response
        raise RuntimeError("stream ended without a terminal response")

    async def request_stream(self, messages, settings=None, params=None):
        stream = self.client.request_stream(
            to_port(messages), to_port(settings), to_port(params)
        )
        try:
            async for event in stream:
                yield to_mesh(event)
        finally:
            await stream.aclose()
