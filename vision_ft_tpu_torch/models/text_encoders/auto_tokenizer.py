"""Tokenizer construction from a checkpoint directory (the port's own copy
of ``vision_ft_tpu/models/text_encoders/auto_tokenizer.py``).

  tokenizer.json            -> the installed `tokenizers` (HF fast) lib
  tokenizer.model / *.model -> pure-Python SentencePiece loader
  vocab.json + merges.txt   -> the from-scratch CLIP BPE

``template`` (special-token placement) defaults per family: gemma -> bos,
t5 -> eos, clip handles its own bos/eos, json -> whatever the file's
post-processor encodes.
"""

from __future__ import annotations

import glob
import os
from typing import Optional, Sequence

FAMILY_TEMPLATES = {
    "gemma": "bos",   # Gemma-2: <bos> + text (Lumina2)
    "t5": "eos",      # T5/UMT5/Wan-T5: text + </s>
    "glm": "none",    # GLM-4 chat template applied upstream
}


class JsonTokenizer:
    """HF-call-compatible wrapper over a ``tokenizer.json`` (Rust
    `tokenizers` library — handles GLM-4 and any HF fast tokenizer)."""

    def __init__(self, tok, pad_id: Optional[int] = None):
        self._tok = tok
        if pad_id is None:
            pad = tok.token_to_id("<pad>")
            if pad is None:
                pad = tok.token_to_id("[PAD]")
            pad_id = pad if pad is not None else 0
        self.pad_id = pad_id

    @classmethod
    def from_file(cls, path: str, pad_id: Optional[int] = None) -> "JsonTokenizer":
        from tokenizers import Tokenizer

        return cls(Tokenizer.from_file(path), pad_id=pad_id)

    def __len__(self) -> int:
        return self._tok.get_vocab_size()

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def __call__(
        self,
        texts,
        max_length: Optional[int] = None,
        padding: str = "max_length",
        truncation: bool = True,
        return_tensors: Optional[str] = None,
        **_: object,
    ) -> dict:
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.encode(t) for t in texts]
        if max_length is None:
            max_length = max((len(e) for e in encoded), default=1)
        input_ids, attention_mask = [], []
        for ids in encoded:
            if truncation and len(ids) > max_length:
                ids = ids[:max_length]
            mask = [1] * len(ids)
            if padding == "max_length" and len(ids) < max_length:
                pad = max_length - len(ids)
                ids, mask = ids + [self.pad_id] * pad, mask + [0] * pad
            input_ids.append(ids)
            attention_mask.append(mask)
        return {"input_ids": input_ids, "attention_mask": attention_mask}


def load_tokenizer(path: str, family: Optional[str] = None):
    """Build a tokenizer from a file or checkpoint directory.

    Resolution order inside a directory: tokenizer.json (fast lib) ->
    tokenizer.model / *.model (SentencePiece) -> vocab.json + merges.txt
    (CLIP BPE). ``family`` picks the special-token template for
    SentencePiece models ("gemma" | "t5" | "glm").
    """
    if os.path.isfile(path):
        candidates = [path]
    else:
        candidates = (
            [os.path.join(path, "tokenizer.json")]
            + [os.path.join(path, "tokenizer.model")]
            + sorted(glob.glob(os.path.join(path, "*.model")))
            + [os.path.join(path, "vocab.json")]
        )
    for cand in candidates:
        if not os.path.isfile(cand):
            continue
        if cand.endswith(".json") and os.path.basename(cand) == "tokenizer.json":
            return JsonTokenizer.from_file(cand)
        if cand.endswith(".model"):
            from .sentencepiece import SentencePieceTokenizer

            template = FAMILY_TEMPLATES.get(family or "t5", "eos")
            return SentencePieceTokenizer.from_file(cand, template=template)
        if os.path.basename(cand) == "vocab.json":
            from .tokenizer import CLIPTokenizer

            return CLIPTokenizer.from_pretrained_dir(os.path.dirname(cand))
    raise FileNotFoundError(
        f"No tokenizer assets found at {path} (looked for tokenizer.json, "
        "*.model sentencepiece, vocab.json+merges.txt)"
    )


def maybe_auto_tokenizer(config, family: Optional[str] = None):
    """Best-effort tokenizer construction from a pipeline config: an
    explicit ``tokenizer_path``, else ``checkpoint_path/tokenizer_folder``
    (the layout of a Hugging Face snapshot).
    Returns None when no assets are found — the text encoder then raises
    its usual "No tokenizer configured" on first use."""
    paths = []
    tp = getattr(config, "tokenizer_path", None)
    if tp:
        paths.append(tp)
    cp = getattr(config, "checkpoint_path", None)
    tf = getattr(config, "tokenizer_folder", None)
    if cp and tf and os.path.isdir(cp):
        paths.append(os.path.join(cp, tf))
    if cp and os.path.isdir(cp):
        paths.append(cp)
    for p in paths:
        try:
            return load_tokenizer(p, family)
        except FileNotFoundError:
            continue
    return None
