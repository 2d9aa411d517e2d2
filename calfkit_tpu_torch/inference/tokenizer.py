"""Tokenizer seam: a dependency-free byte tokenizer (tests and random-weight
runs).  The port's own copy of the JAX package's ``Tokenizer`` protocol and
``ByteTokenizer``; the checkpoint tokenizer comes with the loader."""

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
