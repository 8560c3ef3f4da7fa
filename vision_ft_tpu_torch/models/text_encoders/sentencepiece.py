"""SentencePiece tokenizer: a pure-Python loader for ``.model`` protos
(the port's own copy of ``vision_ft_tpu/models/text_encoders/
sentencepiece.py``; the two packages share no module).

It parses the SentencePiece ``ModelProto`` wire format directly (varint
and length-delimited fields only) and implements both inference
algorithms:

- **unigram**: Viterbi segmentation maximizing summed piece log-probs
  (T5/UMT5/Gemma-2 checkpoints are unigram models)
- **bpe**: greedy highest-score adjacent merge

plus byte-fallback (``<0xNN>`` pieces) and the standard normalizer
subset: whitespace collapse, ``▁`` escaping, optional dummy prefix.
``precompiled_charsmap`` (NFKC) normalization rules are NOT applied:
ASCII and already-normalized text tokenize identically.
:func:`serialize_model` writes a minimal valid ``.model`` (synthetic
vocabularies for tests and smoke runs).

Proto schema subset (sentencepiece_model.proto):
  ModelProto      { repeated SentencePiece pieces=1; TrainerSpec trainer_spec=2;
                    NormalizerSpec normalizer_spec=3; }
  SentencePiece   { string piece=1; float score=2; Type type=3; }
                  Type: NORMAL=1 UNKNOWN=2 CONTROL=3 USER_DEFINED=4 BYTE=6
  TrainerSpec     { ModelType model_type=3 (UNIGRAM=1 BPE=2);
                    int32 unk_id=40, bos_id=41, eos_id=42, pad_id=43; }
  NormalizerSpec  { string name=1; bytes precompiled_charsmap=2;
                    bool add_dummy_prefix=3; bool remove_extra_whitespaces=4;
                    bool escape_whitespaces=5; }
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Sequence

WS = "▁"  # ▁


# ---------------------------------------------------------------------------
# protobuf wire parsing / writing (varint + length-delimited only)


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val, pos = buf[pos : pos + 8], pos + 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val, pos = buf[pos : pos + ln], pos + ln
        elif wtype == 5:  # 32-bit
            val, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def write_field(fnum: int, wtype: int, payload: bytes | int) -> bytes:
    head = _write_varint((fnum << 3) | wtype)
    if wtype == 0:
        return head + _write_varint(payload)
    if wtype in (1, 5):  # fixed64 / fixed32: raw bytes, no length prefix
        return head + payload
    return head + _write_varint(len(payload)) + payload


def serialize_model(
    pieces: Sequence[tuple[str, float, int]],
    model_type: int = 1,
    unk_id: int = 0,
    bos_id: int = 1,
    eos_id: int = 2,
    pad_id: int = -1,
    add_dummy_prefix: bool = True,
) -> bytes:
    """Build a minimal valid ``.model`` proto."""
    out = bytearray()
    for piece, score, ptype in pieces:
        sub = (
            write_field(1, 2, piece.encode("utf-8"))
            + write_field(2, 5, struct.pack("<f", score))
            + write_field(3, 0, ptype)
        )
        out += write_field(1, 2, sub)
    trainer = (
        write_field(3, 0, model_type)
        + write_field(40, 0, unk_id & 0xFFFFFFFF)
        + write_field(41, 0, bos_id & 0xFFFFFFFF)
        + write_field(42, 0, eos_id & 0xFFFFFFFF)
        + write_field(43, 0, pad_id & 0xFFFFFFFF)
    )
    out += write_field(2, 2, trainer)
    norm = write_field(1, 2, b"identity") + write_field(3, 0, int(add_dummy_prefix))
    out += write_field(3, 2, norm)
    return bytes(out)


# ---------------------------------------------------------------------------
# model


@dataclass
class SentencePieceModel:
    pieces: list[str]
    scores: list[float]
    types: list[int]
    model_type: int = 1  # 1 unigram, 2 bpe
    unk_id: int = 0
    bos_id: int = 1
    eos_id: int = 2
    pad_id: int = -1
    add_dummy_prefix: bool = True
    piece_to_id: dict = field(default_factory=dict)
    _max_piece_len: int = 1
    _byte_ids: Optional[list[int]] = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        m = cls([], [], [])
        for fnum, wtype, val in _iter_fields(data):
            if fnum == 1 and wtype == 2:  # SentencePiece
                piece, score, ptype = "", 0.0, 1
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                m.pieces.append(piece)
                m.scores.append(score)
                m.types.append(ptype)
            elif fnum == 2 and wtype == 2:  # TrainerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 3:
                        m.model_type = v2
                    elif f2 == 40:
                        m.unk_id = _signed32(v2)
                    elif f2 == 41:
                        m.bos_id = _signed32(v2)
                    elif f2 == 42:
                        m.eos_id = _signed32(v2)
                    elif f2 == 43:
                        m.pad_id = _signed32(v2)
            elif fnum == 3 and wtype == 2:  # NormalizerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 3:
                        m.add_dummy_prefix = bool(v2)
        m.piece_to_id = {p: i for i, p in enumerate(m.pieces)}
        m._max_piece_len = max((len(p) for p in m.pieces), default=1)
        if all(f"<0x{b:02X}>" in m.piece_to_id for b in range(256)):
            m._byte_ids = [m.piece_to_id[f"<0x{b:02X}>"] for b in range(256)]
        return m

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -- normalization -----------------------------------------------------

    def normalize(self, text: str) -> str:
        text = " ".join(text.split())  # remove_extra_whitespaces
        if self.add_dummy_prefix and text:
            text = " " + text
        return text.replace(" ", WS)

    # -- encoding ----------------------------------------------------------

    def _fallback(self, ch: str) -> list[int]:
        if self._byte_ids is not None:
            return [self._byte_ids[b] for b in ch.encode("utf-8")]
        return [self.unk_id]

    def _encode_unigram(self, text: str) -> list[int]:
        """Viterbi over piece log-probs (the sentencepiece lattice)."""
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[Optional[tuple[int, Optional[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores, default=0.0) - 10.0
        for end in range(1, n + 1):
            for start in range(max(0, end - self._max_piece_len), end):
                if best[start] <= NEG / 2:
                    continue
                pid = self.piece_to_id.get(text[start:end])
                if pid is not None and self.types[pid] not in (3,):  # not CONTROL
                    s = best[start] + self.scores[pid]
                    if s > best[end]:
                        best[end], back[end] = s, (start, pid)
            if back[end] is None and best[end - 1] > NEG / 2:
                # unknown single char
                best[end] = best[end - 1] + unk_penalty
                back[end] = (end - 1, None)
        ids: list[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            ids.append(pid if pid is not None else -1)
            pos = start
        ids.reverse()
        out: list[int] = []
        for i, pid in enumerate(ids):
            if pid == -1:
                # recover the char span for fallback
                out.extend(self._fallback_span(text, i, ids))
            else:
                out.append(pid)
        return out

    def _fallback_span(self, text: str, idx: int, ids: list[int]) -> list[int]:
        # reconstruct position of the idx-th segment
        pos = 0
        for j in range(idx):
            pos += 1 if ids[j] == -1 else len(self.pieces[ids[j]])
        return self._fallback(text[pos])

    def _encode_bpe(self, text: str) -> list[int]:
        symbols = list(text)
        while True:
            best_score, best_i = None, None
            for i in range(len(symbols) - 1):
                pid = self.piece_to_id.get(symbols[i] + symbols[i + 1])
                if pid is not None:
                    s = self.scores[pid]
                    if best_score is None or s > best_score:
                        best_score, best_i = s, i
            if best_i is None:
                break
            symbols[best_i : best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        out: list[int] = []
        for sym in symbols:
            pid = self.piece_to_id.get(sym)
            if pid is None:
                out.extend(self._fallback(sym))
            else:
                out.append(pid)
        return out

    def encode(self, text: str) -> list[int]:
        text = self.normalize(text)
        if not text:
            return []
        if self.model_type == 2:
            return self._encode_bpe(text)
        return self._encode_unigram(text)

    def decode(self, ids: Sequence[int]) -> str:
        parts: list[str] = []
        byte_buf: list[int] = []

        def flush():
            if byte_buf:
                parts.append(bytes(byte_buf).decode("utf-8", errors="replace"))
                byte_buf.clear()

        for i in ids:
            piece = self.pieces[i] if 0 <= i < len(self.pieces) else ""
            if self.types[i] == 6 and len(piece) == 6:  # <0xNN>
                byte_buf.append(int(piece[3:5], 16))
                continue
            flush()
            if self.types[i] in (2, 3):  # UNKNOWN / CONTROL
                continue
            parts.append(piece)
        flush()
        return "".join(parts).replace(WS, " ").strip()


def _signed32(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


# ---------------------------------------------------------------------------
# HF-call-compatible wrapper


class SentencePieceTokenizer:
    """HF-tokenizer-compatible callable over a SentencePiece model.

    ``template``: "bos" prepends bos_id (Gemma-2 style), "eos" appends
    eos_id (T5/UMT5 style), "bos_eos" both, "none" neither.
    """

    def __init__(self, model: SentencePieceModel, template: str = "eos"):
        self.model = model
        self.template = template
        self.pad_id = model.pad_id if model.pad_id >= 0 else 0

    @classmethod
    def from_file(cls, path: str, template: str = "eos") -> "SentencePieceTokenizer":
        return cls(SentencePieceModel.from_file(path), template)

    def __len__(self) -> int:
        return len(self.model.pieces)

    def encode(self, text: str) -> list[int]:
        ids = self.model.encode(text)
        if self.template in ("bos", "bos_eos"):
            ids = [self.model.bos_id] + ids
        if self.template in ("eos", "bos_eos"):
            ids = ids + [self.model.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.model.decode(list(ids))

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
                if self.template in ("eos", "bos_eos"):
                    ids[-1] = self.model.eos_id
            mask = [1] * len(ids)
            if padding == "max_length" and len(ids) < max_length:
                pad = max_length - len(ids)
                ids = ids + [self.pad_id] * pad
                mask = mask + [0] * pad
            input_ids.append(ids)
            attention_mask.append(mask)
        return {"input_ids": input_ids, "attention_mask": attention_mask}
