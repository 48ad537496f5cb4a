"""From-scratch SentencePiece unigram tokenizer (no ``sentencepiece`` lib).

The PyTorch port's own copy of bifold_tpu/data/spm.py (which cannot be
imported without JAX): a minimal protobuf wire-format reader and writer for
``spiece.model`` files plus unigram Viterbi segmentation reproducing
``SentencePieceProcessor.encode``. The SigLIP tokenizer
(:mod:`bifold_tpu_torch.data.tokenizers`) runs on it, offline.

Scope: unigram models only; ``nmt_nfkc`` normalization via ``unicodedata``
NFKC plus the NMT control/whitespace rules (not the precompiled charsmap),
which agree on ASCII/latin instruction text; ``byte_fallback`` supported.
"""

from __future__ import annotations

import struct
import unicodedata
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Optional

__all__ = [
    "SentencePieceModel",
    "serialize_model_proto",
    "NORMAL",
    "UNKNOWN",
    "CONTROL",
    "USER_DEFINED",
    "UNUSED",
    "BYTE",
]

# SentencePiece.Type enum (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_SPACE = "\u2581"  # the sentencepiece meta-space (LOWER ONE EIGHTH BLOCK)


# ---------------------------------------------------------------------------
# protobuf wire format (reader + minimal writer)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:  # 64-bit
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:  # 32-bit
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(fnum: int, wtype: int, payload: bytes) -> bytes:
    return _varint((fnum << 3) | wtype) + payload


def _len_field(fnum: int, payload: bytes) -> bytes:
    return _field(fnum, 2, _varint(len(payload)) + payload)


def serialize_model_proto(
        pieces: Iterable[tuple[str, float, int]],
        *,
        normalizer_name: str = "nmt_nfkc",
        add_dummy_prefix: bool = True,
        remove_extra_whitespaces: bool = True,
        escape_whitespaces: bool = True,
        model_type: int = 1,  # UNIGRAM
        byte_fallback: bool = False,
        unk_id: int = 0,
        bos_id: int = -1,
        eos_id: int = 1,
        pad_id: int = -1) -> bytes:
    """Build a minimal spm ``.model`` (ModelProto) — the test-fixture writer.

    ``pieces``: iterable of (piece, score, type)."""
    body = bytearray()
    for piece, score, ptype in pieces:
        sp = (_len_field(1, piece.encode("utf-8"))
              + _field(2, 5, struct.pack("<f", score))
              + _field(3, 0, _varint(ptype)))
        body += _len_field(1, sp)
    trainer = (_field(3, 0, _varint(model_type))
               + _field(35, 0, _varint(int(byte_fallback)))
               + _field(40, 0, _varint(unk_id & 0xFFFFFFFF))
               + _field(41, 0, _varint(bos_id & 0xFFFFFFFF))
               + _field(42, 0, _varint(eos_id & 0xFFFFFFFF))
               + _field(43, 0, _varint(pad_id & 0xFFFFFFFF)))
    body += _len_field(2, trainer)
    norm = (_len_field(1, normalizer_name.encode("utf-8"))
            + _field(3, 0, _varint(int(add_dummy_prefix)))
            + _field(4, 0, _varint(int(remove_extra_whitespaces)))
            + _field(5, 0, _varint(int(escape_whitespaces))))
    body += _len_field(3, norm)
    return bytes(body)


def fixture_model_bytes() -> bytes:
    """A tiny but fully usable unigram ``.model``: word pieces for the
    bench/demo instruction vocabulary plus single-character pieces covering
    ascii lowercase + digits, so ANY smoke instruction tokenizes through
    the real Viterbi path (never an unk flood).

    Smokes on random weights use it when no real ``spiece.model`` exists;
    its ids are FIXTURE ids, wrong for converted pretrained checkpoints
    (those carry their own asset)."""
    words = ("fold", "the", "towel", "cloth", "tshirt", "shirt", "trousers",
             "from", "left", "to", "right", "in", "half", "bottom", "top",
             "sleeve", "sleeves", "corner", "corners", "edge", "center",
             "middle", "pick", "place", "flatten", "unfold", "smooth",
             "grasp", "pull", "drag", "both", "hands", "arm", "diagonal",
             "vertically", "horizontally", "and", "then", "of", "it", "a")
    pieces = [("<unk>", 0.0, UNKNOWN), ("</s>", 0.0, CONTROL),
              ("▁", -3.0, NORMAL)]
    pieces += [("▁" + w, -1.0, NORMAL) for w in words]
    pieces += [(c, -8.0, NORMAL)
               for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    return serialize_model_proto(pieces, unk_id=0, eos_id=1)


def _i32(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


@dataclass
class SentencePieceModel:
    """Parsed spm model + unigram Viterbi encoder."""

    pieces: list[tuple[str, float, int]] = field(default_factory=list)
    normalizer_name: str = "nmt_nfkc"
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True
    model_type: int = 1
    byte_fallback: bool = False
    unk_id: int = 0

    def __post_init__(self):
        self._piece_to_id: dict[str, int] = {}
        self._match: dict[str, tuple[int, float]] = {}
        self._max_len = 1
        min_score = 0.0
        unk_from_type = None
        for i, (piece, score, ptype) in enumerate(self.pieces):
            self._piece_to_id.setdefault(piece, i)
            if ptype in (NORMAL, USER_DEFINED):
                # only normal/user-defined pieces match raw text; control
                # (</s>, <pad>) and the unk piece itself never do
                self._match[piece] = (i, score)
                self._max_len = max(self._max_len, len(piece))
            if ptype == NORMAL:
                min_score = min(min_score, score)
            if ptype == UNKNOWN and unk_from_type is None:
                unk_from_type = i
        if unk_from_type is not None:
            self.unk_id = unk_from_type
        # sentencepiece's kUnkPenalty: unk score = min_score - 10
        self._unk_score = min_score - 10.0
        self._byte_ids = None
        if self.byte_fallback:
            self._byte_ids = {}
            for b in range(256):
                j = self._piece_to_id.get(f"<0x{b:02X}>")
                if j is not None:
                    self._byte_ids[b] = j
            if len(self._byte_ids) < 256:
                self._byte_ids = None  # incomplete byte table: disable

    # -- construction -------------------------------------------------------

    @classmethod
    def from_bytes(cls, data: bytes) -> "SentencePieceModel":
        pieces: list[tuple[str, float, int]] = []
        kw: dict = {}
        for fnum, _, val in _iter_fields(data):
            if fnum == 1:  # SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, _, v2 in _iter_fields(val):
                    if f2 == 1:
                        piece = v2.decode("utf-8")
                    elif f2 == 2:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif fnum == 2:  # TrainerSpec
                for f2, _, v2 in _iter_fields(val):
                    if f2 == 3:
                        kw["model_type"] = v2
                    elif f2 == 35:
                        kw["byte_fallback"] = bool(v2)
                    elif f2 == 40:
                        kw["unk_id"] = _i32(v2)
            elif fnum == 3:  # NormalizerSpec
                for f2, _, v2 in _iter_fields(val):
                    if f2 == 1:
                        kw["normalizer_name"] = v2.decode("utf-8")
                    elif f2 == 3:
                        kw["add_dummy_prefix"] = bool(v2)
                    elif f2 == 4:
                        kw["remove_extra_whitespaces"] = bool(v2)
                    elif f2 == 5:
                        kw["escape_whitespaces"] = bool(v2)
        if kw.get("model_type", 1) != 1:
            raise ValueError(
                f"only unigram spm models supported, got model_type="
                f"{kw['model_type']} (BPE spm models are out of scope)")
        return cls(pieces=pieces, **kw)

    @classmethod
    def load(cls, path: str | Path) -> "SentencePieceModel":
        return cls.from_bytes(Path(path).read_bytes())

    # -- API ----------------------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def piece_to_id(self, piece: str) -> int:
        return self._piece_to_id.get(piece, self.unk_id)

    def id_to_piece(self, i: int) -> str:
        return self.pieces[i][0]

    def normalize(self, text: str) -> str:
        """The nmt_nfkc recipe re-implemented (see module docstring for the
        precompiled-charsmap caveat): NMT control/space cleanup + NFKC +
        optional whitespace collapse, dummy prefix, ▁-escaping."""
        if "nfkc" in self.normalizer_name:
            out = []
            for ch in text:
                if ch in "\t\n\r\x0b\x0c" or ch == "\u200b":
                    out.append(" ")  # NMT: whitespace-ish controls -> space
                elif unicodedata.category(ch) in ("Cc", "Cf"):
                    continue  # NMT: drop other control/format chars
                else:
                    out.append(ch)
            text = unicodedata.normalize("NFKC", "".join(out))
            if "cf" in self.normalizer_name:  # nmt_nfkc_cf: casefold
                text = text.lower()
        if self.remove_extra_whitespaces:
            while "  " in text:
                text = text.replace("  ", " ")
            text = text.strip(" ")
        if self.add_dummy_prefix and text:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", _SPACE)
        return text

    def encode_pieces(self, text: str) -> list[str]:
        """Viterbi unigram segmentation of the normalized text."""
        s = self.normalize(text)
        if not s:
            return []
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        best[0] = 0.0
        back: list[Optional[int]] = [None] * (n + 1)  # start index, None=unk
        unk = [False] * (n + 1)
        for i in range(1, n + 1):
            lo = max(0, i - self._max_len)
            for j in range(lo, i):
                entry = self._match.get(s[j:i])
                if entry is not None and best[j] > NEG:
                    sc = best[j] + entry[1]
                    if sc > best[i]:
                        best[i], back[i], unk[i] = sc, j, False
            # single-char unknown fallback (kUnkPenalty score)
            sc = best[i - 1] + self._unk_score
            if sc > best[i]:
                best[i], back[i], unk[i] = sc, i - 1, True
        # backtrace
        spans: list[tuple[int, int, bool]] = []
        i = n
        while i > 0:
            j = back[i]
            spans.append((j, i, unk[i]))
            i = j
        spans.reverse()
        out: list[str] = []
        k = 0
        while k < len(spans):
            j, i, is_unk = spans[k]
            if not is_unk:
                out.append(s[j:i])
                k += 1
                continue
            # merge consecutive unknown chars into ONE unk piece
            # (sentencepiece behavior), unless byte_fallback emits bytes
            end = i
            while k + 1 < len(spans) and spans[k + 1][2]:
                k += 1
                end = spans[k][1]
            chunk = s[j:end]
            if self._byte_ids is not None:
                out.extend(f"<0x{b:02X}>" for b in chunk.encode("utf-8"))
            else:
                out.append(chunk)
            k += 1
        return out

    def pieces_to_ids(self, pieces: Iterable[str]) -> list[int]:
        """Map segmentation output to ids: matchable/byte pieces by table,
        anything else (unk chunks — including text that coincidentally
        spells a control piece) to ``unk_id``."""
        ids = []
        for p in pieces:
            i = self._piece_to_id.get(p)
            matchable = (self._match.get(p) is not None
                         or (i is not None and self.pieces[i][2] == BYTE))
            ids.append(i if matchable and i is not None else self.unk_id)
        return ids

    def encode(self, text: str) -> list[int]:
        return self.pieces_to_ids(self.encode_pieces(text))
