"""CLIP BPE tokenizer, numpy-only; the encoding path of
``vision_ft_tpu/models/text_encoders/tokenizer.py`` (the JAX package's
module cannot be imported without importing jax).

``CLIPTokenizer.from_files(vocab.json, merges.txt)`` implements the
byte-level BPE with the CLIP-specific ``</w>`` word suffix, lowercasing
and whitespace cleanup. Output is numpy int32 (batch, max_length).
Added special tokens and ``decode`` (used by the JAX package's style
adapter) are not ported yet.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import os
import re
from typing import Sequence

import numpy as np

# CLIP's regex uses \p{L}/\p{N} (needs the `regex` package); the stdlib
# equivalent below treats all non-ASCII word chars via the catch-all class,
# which matches CLIP's behavior for the ASCII prompts this framework sees.
_TOKEN_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


@functools.lru_cache()
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte<->unicode map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    """Byte-level BPE with CLIP's `</w>` end-of-word marker."""

    def __init__(self, encoder: dict[str, int], bpe_merges: list[tuple[str, str]]):
        self.encoder = encoder
        self.byte_encoder = _bytes_to_unicode()
        self.bpe_ranks = dict(zip(bpe_merges, range(len(bpe_merges))))
        self.cache: dict[str, str] = {}
        self.bos_token_id = encoder.get("<|startoftext|>", 49406)
        self.eos_token_id = encoder.get("<|endoftext|>", 49407)
        self.pad_token_id = self.eos_token_id  # CLIP pads with eos

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "CLIPTokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # skip the "#version" header if present
        start = 1 if lines and lines[0].startswith("#") else 0
        merges = [tuple(line.split()) for line in lines[start:] if len(line.split()) == 2]
        return cls(encoder, merges)  # type: ignore[arg-type]

    @classmethod
    def from_pretrained_dir(cls, path: str) -> "CLIPTokenizer":
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt")
        )

    # -- BPE ----------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word[:-1], word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = set(zip(word[:-1], word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: list[int] = []
        for token in _TOKEN_PATTERN.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    # -- batch API (the protocol long_prompt.py consumes) --------------------

    def __call__(self, prompts: Sequence[str], max_length: int) -> np.ndarray:
        """Tokenize with bos/eos + truncation + pad-to-max_length.

        Returns int32 (batch, max_length)."""
        rows = []
        for prompt in prompts:
            ids = self.encode(prompt)[: max_length - 2]
            row = [self.bos_token_id, *ids, self.eos_token_id]
            row.extend([self.pad_token_id] * (max_length - len(row)))
            rows.append(row)
        return np.asarray(rows, dtype=np.int32)
