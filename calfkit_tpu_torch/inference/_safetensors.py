"""A reader of the safetensors format, without the ``safetensors`` package.

A file is an 8-byte little-endian header length, a JSON header mapping each
tensor's name to its ``dtype``, ``shape`` and ``data_offsets`` (begin, end)
in the data section (plus an optional ``__metadata__`` entry), then the
data section of raw little-endian bytes.  Tensors are read on demand into
CPU tensors; BF16 is read as 16-bit words and viewed as ``torch.bfloat16``,
so no numpy bfloat16 type is needed.
"""

from __future__ import annotations

import json
import math
import struct
from pathlib import Path

import numpy as np
import torch

# the floating types checkpoints are stored in: safetensors dtype → (numpy
# dtype of the raw words, torch dtype they view as)
DTYPES: dict[str, tuple[str, torch.dtype]] = {
    "F32": ("<f4", torch.float32),
    "F16": ("<f2", torch.float16),
    "BF16": ("<u2", torch.bfloat16),
}


class SafetensorsFile:
    """One ``.safetensors`` file: its header, read when opened, and its
    tensors, read by :meth:`get_tensor`."""

    def __init__(self, path: "str | Path"):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self._data_start = 8 + n
        self._header: dict[str, dict] = header

    def keys(self) -> "list[str]":
        return list(self._header)

    def get_tensor(self, name: str) -> torch.Tensor:
        entry = self._header[name]
        dtype = entry["dtype"]
        if dtype not in DTYPES:
            raise ValueError(f"{self.path.name}: tensor {name!r} has unsupported dtype {dtype!r}")
        words, torch_dtype = DTYPES[dtype]
        shape = tuple(entry["shape"])
        begin, end = entry["data_offsets"]
        count = math.prod(shape)
        if end - begin != count * np.dtype(words).itemsize:
            raise ValueError(
                f"{self.path.name}: tensor {name!r} spans {end - begin} bytes, "
                f"not {count} x {dtype}"
            )
        array = np.fromfile(
            self.path, dtype=words, count=count, offset=self._data_start + begin
        ).reshape(shape)
        tensor = torch.from_numpy(array)
        return tensor.view(torch_dtype) if dtype == "BF16" else tensor
