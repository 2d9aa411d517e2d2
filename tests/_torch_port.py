"""Shared helpers of the PyTorch port's parity tests: the JAX package is the
oracle, and both packages get the same inputs as numpy arrays."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from calfkit_tpu.inference import model as JM
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
