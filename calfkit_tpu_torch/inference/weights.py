"""Weight conversion into the PyTorch package's parameter layout.

:func:`params_from_numpy` takes a parameter tree of numpy arrays in the JAX
package's layout (stacked ``[L, ...]`` layer weights under ``"layers"``;
``embed``; ``final_norm``; ``lm_head`` absent when tied — e.g. the arrays
of a JAX params pytree after ``numpy.asarray``) and returns the same tree
of torch tensors, so both packages compute the same function.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(array: Any) -> torch.Tensor:
    array = np.asarray(array)
    if array.dtype.name == "bfloat16":
        # numpy has no native bfloat16: reinterpret the 16-bit payload
        bits = np.ascontiguousarray(array).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(array).copy())


def params_from_numpy(
    tree: "dict[str, Any]",
    *,
    device: "torch.device | str" = "cuda",
    dtype: "torch.dtype | None" = None,
) -> "dict[str, Any]":
    """→ the same tree with every array as a tensor on ``device``, cast to
    ``dtype`` when one is given (else kept in the arrays' own dtype)."""
    out: dict[str, Any] = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out[name] = params_from_numpy(value, device=device, dtype=dtype)
            continue
        tensor = _to_tensor(value)
        if dtype is not None:
            tensor = tensor.to(dtype)
        out[name] = tensor.to(device)
    return out
