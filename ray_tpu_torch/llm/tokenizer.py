"""Tokenizers for the LLM layer (the port's own copy of
``ray_tpu/llm/tokenizer.py``).

``ByteTokenizer`` is the built-in fallback (offline-safe; token = byte +
specials) used by tests and the tiny model; real deployments point
``ModelConfig.tokenizer`` at a local HuggingFace tokenizer directory
(``transformers`` is in the base image; loading is offline/local-only).
"""

from __future__ import annotations



class ByteTokenizer:
    """bytes 0..255 + BOS(256) + EOS(257)."""

    vocab_size = 258
    bos_id = 256
    eos_id = 257

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: list[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")


class HFTokenizer:
    """Local transformers tokenizer (no network: local files only)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = self._tok.vocab_size
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> list[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def get_tokenizer(spec: str):
    if spec == "byte":
        return ByteTokenizer()
    return HFTokenizer(spec)
