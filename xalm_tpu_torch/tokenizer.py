"""Trie-based greedy longest-match tokenizer with byte fallback
(counterpart of ``xalm_tpu/tokenizer.py``).

- Vocab is the ``tokenizer.tokens`` U8 tensor: NUL-terminated strings, one
  per token id.
- Byte-fallback range found by locating ``<0x00>``; EOT id by scanning for
  ``<|eot_id|>`` / ``<|end|>`` / ``<|im_end|>``.
- ``encode``: greedy longest match over a byte trie, falling back to
  ``<0xNN>`` byte tokens.
- ``decode_one``: strips one leading space after BOS and maps byte-fallback
  ids to raw bytes.

``encode`` runs the native C++ trie (``native.NativeTrie``,
``native/tokenizer.cpp``) where the native library loads, and the Python
trie here otherwise; both give the same ids.
"""

from __future__ import annotations

import numpy as np

from xalm_tpu_torch.native import NativeTrie

__all__ = ["Tokenizer"]


def _parse_id(value: str) -> int:
    # metadata ids may be "2" or "[2, 3]"
    value = value.strip()
    if value.startswith("["):
        value = value[1:-1].split(",")[0]
    return int(value)


class Tokenizer:
    def __init__(self, tokens_blob: np.ndarray, bos_token_id: str, eos_token_id: str):
        self.bos_id = _parse_id(bos_token_id)
        self.eos_id = _parse_id(eos_token_id)
        blob = tokens_blob.tobytes()
        self.vocab: list[bytes] = blob.split(b"\x00")
        if self.vocab and self.vocab[-1] == b"":
            self.vocab.pop()

        self.byte_fallback_start = -1
        self.eot_id = -1
        for i, tok in enumerate(self.vocab):
            if tok == b"<0x00>":
                self.byte_fallback_start = i
            elif tok in (b"<|eot_id|>", b"<|end|>", b"<|im_end|>"):
                self.eot_id = i

        # byte-keyed trie: {byte: [token_id | None, children]}
        self._trie: dict = {}
        for i, word in enumerate(self.vocab):
            if not word:
                continue
            node = self._trie
            entry = None
            for b in word:
                entry = node.setdefault(b, [None, {}])
                node = entry[1]
            entry[0] = i

        self._native = None
        try:
            self._native = NativeTrie(blob, self.bos_id, self.eos_id)
        except RuntimeError:  # no native library: the Python trie encodes
            pass

    @classmethod
    def from_xalm(cls, xf) -> "Tokenizer":
        return cls(
            xf.load("tokenizer.tokens"),
            xf.config["bos_token_id"],
            xf.config["eos_token_id"],
        )

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def encode(self, text: str | bytes, bos: bool = True) -> list[int]:
        data = text.encode("utf-8") if isinstance(text, str) else text
        if self._native is not None:
            return self._native.encode(data, bos)
        return self.encode_python(data, bos)

    def encode_python(self, data: bytes, bos: bool = True) -> list[int]:
        """``encode`` on the Python trie."""
        out: list[int] = [self.bos_id] if bos else []
        i = 0
        n = len(data)
        while i < n:
            node = self._trie
            best_id, best_len = -1, 0
            k = 0
            while i + k < n:
                entry = node.get(data[i + k])
                if entry is None:
                    break
                k += 1
                if entry[0] is not None:
                    best_id, best_len = entry[0], k
                node = entry[1]
            if best_id < 0:
                if self.byte_fallback_start >= 0:
                    out.append(data[i] + self.byte_fallback_start)
                i += 1
            else:
                out.append(best_id)
                i += best_len
        return out

    def decode_one(self, prev_token: int, token: int) -> bytes:
        piece = self.vocab[token]
        if prev_token == self.bos_id and piece.startswith(b" "):
            return piece[1:]
        if (
            self.byte_fallback_start >= 0
            and token >= self.byte_fallback_start
            and token - self.byte_fallback_start < 256
        ):
            return bytes([token - self.byte_fallback_start])
        return piece

    def decode(self, tokens: list[int]) -> str:
        prev = -1
        out = b""
        for t in tokens:
            if t == self.bos_id:
                prev = t
                continue
            out += self.decode_one(prev, t)
            prev = t
        return out.decode("utf-8", errors="replace")

    def is_stop(self, token: int) -> bool:
        return token == self.eos_id or token == self.eot_id
