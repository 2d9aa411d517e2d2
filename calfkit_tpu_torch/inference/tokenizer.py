"""Tokenizer seam: HF tokenizers when a checkpoint directory is given, a
dependency-free byte tokenizer otherwise (tests and random-weight runs).
The port's own copy of the JAX package's ``Tokenizer`` protocol,
``ByteTokenizer`` and ``HFTokenizer``."""

from __future__ import annotations

from typing import Protocol


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: list[int]) -> str: ...

    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """UTF-8 bytes + 3 specials: deterministic, vocab 259, no deps."""

    pad_id = 0
    bos_id = 1
    eos_id = 2
    _OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self._OFFSET

    def encode(self, text: str) -> list[int]:
        return [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: list[int]) -> str:
        # ids beyond the byte range (a model vocab can be larger) are dropped
        data = bytes(
            i - self._OFFSET
            for i in ids
            if self._OFFSET <= i < 256 + self._OFFSET
        )
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """transformers' ``AutoTokenizer`` over a LOCAL directory (no network).
    ``transformers`` is imported when one is built, never with this module:
    a machine without it serves every other tokenizer."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # lazy: heavyweight, optional

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

        # id 0 is a legitimate special-token id: never `or` these
        def _id(value: "int | None", default: int) -> int:
            return value if value is not None else default

        self.bos_id = _id(self._tok.bos_token_id, 1)
        self.eos_id = _id(self._tok.eos_token_id, 2)
        self.pad_id = _id(self._tok.pad_token_id, 0)

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)
