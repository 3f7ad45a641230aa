"""Byte-level tokenizer (a copy of ``repro.data.tokenizer``): 256 byte tokens
and three specials.  The gateway byte-tokenises string prompts with it."""
from __future__ import annotations


class ByteTokenizer:
    PAD = 256
    BOS = 257
    EOS = 258

    vocab_size = 259

    def encode(self, text, bos=True, eos=False):
        ids = list(text.encode("utf-8"))
        return [*([self.BOS] if bos else []), *ids, *([self.EOS] if eos else [])]

    def decode(self, ids):
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")
