"""The text paths: fixed-length int32 ids, offline.

The port's own copy of bifold_tpu/data/tokenizers.py's SigLIP and CLIP
parts (:48-210, :220-345, :374-485):

- SigLIP: the sentencepiece tokenizer on the built-in unigram engine
  (:mod:`bifold_tpu_torch.data.spm`), the asset lookup and the generated
  fixture model for smokes;
- CLIP: OpenAI CLIP's byte-pair tokenizer (77 tokens, lowercased,
  ``<|startoftext|>`` / ``<|endoftext|>``, zero padding) on the merges file
  the port carries itself (``data/assets/bpe_simple_vocab_16e6.txt.gz``, or
  ``$BIFOLD_CLIP_BPE``);
- T5: the checkpoint's own ``spiece.model`` on the same unigram engine
  (``SpmT5Tokenizer``, :283), or a hash capped at the encoder's vocabulary
  (``pad`` 0, ``eos`` 1) when a local dir has no ``spiece.model`` or the
  name is a registry one (:436-486);
- the deterministic hashing fallback in either layout when an asset is
  missing.

The JAX package first asks ``transformers.AutoTokenizer`` with
``local_files_only=True`` for a T5 name without a local ``spiece.model``
(:458-468); the port has no ``transformers`` and goes straight to the
capped hash, which is what the JAX package gives on a host whose Hugging
Face cache lacks the name.

The same asset gives the same ids as the JAX package. The JAX package
splits CLIP words with the ``regex`` module's ``\\p{L}`` / ``\\p{N}`` classes
when that module is installed; the port gives those ids without it
(:func:`_clip_words`, from ``unicodedata`` categories), for every character
the interpreter's Unicode database assigns.
"""

from __future__ import annotations

import gzip
import hashlib
import html
import json
import os
import re
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["HashTokenizer", "SpmSiglipTokenizer", "SpmT5Tokenizer", "ClipBPETokenizer",
           "build_tokenizer", "siglip_spm_path", "clip_bpe_path",
           "ensure_spm_fixture", "SIGLIP_CONTEXT_LENGTH", "CLIP_CONTEXT_LENGTH",
           "CLIP_MODEL_NAMES"]

SIGLIP_CONTEXT_LENGTH = 64
CLIP_CONTEXT_LENGTH = 77
_SIGLIP_VOCAB_SIZE = 32000
_CLIP_VOCAB_SIZE = 49408
# the CLIP model names the reference tokenizes with its vendored BPE
CLIP_MODEL_NAMES = {"RN50", "RN101", "RN50x4", "RN50x16", "RN50x64",
                    "ViT-B/32", "ViT-B/16", "ViT-L/14", "ViT-L/14@336px"}


def _stable_hash(token: str) -> int:
    return int.from_bytes(hashlib.md5(token.encode("utf-8")).digest()[:8], "little")


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class HashTokenizer:
    """Deterministic word-level stand-in: lowercase, map each word to a
    stable hash bucket. SigLIP layout (the default): punctuation dropped,
    eos 1, pad 1. CLIP layout (``sot`` given): punctuation characters are
    words of their own, ``sot`` first, ``eot`` last, ``pad`` 0. T5 layout
    (``drop_punctuation=False`` without ``sot``): punctuation kept, ``eot``
    last."""

    def __init__(self, vocab_size: int, context_length: int,
                 eot: int = 1, pad: int = 1, reserved: int = 3,
                 sot: Optional[int] = None, drop_punctuation: Optional[bool] = None):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = sot
        self.eot = eot
        self.pad = pad
        self.reserved = reserved
        self.drop_punctuation = (sot is None if drop_punctuation is None
                                 else drop_punctuation)

    def __call__(self, text: str) -> np.ndarray:
        text = _whitespace_clean(_basic_clean(text)).lower()
        pattern = r"[a-z0-9]+" if self.drop_punctuation else r"[a-z0-9]+|[^\sa-z0-9]"
        span = self.vocab_size - self.reserved
        ids = [self.reserved + _stable_hash(w) % span
               for w in re.findall(pattern, text)]
        head = [] if self.sot is None else [self.sot]
        ids = head + ids[: self.context_length - 1 - len(head)] + [self.eot]
        out = np.full((self.context_length,), self.pad, dtype=np.int32)
        out[: len(ids)] = ids
        return out


@lru_cache()
def _bytes_to_unicode() -> dict:
    """GPT-2's byte <-> printable unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_SPECIAL = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_class(ch: str) -> str:
    """"L" (a letter, ``\\p{L}``), "N" (a number, ``\\p{N}``), " " (white
    space, ``\\s``) or "" (anything else)."""
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else ""


def _clip_words(text: str) -> list:
    """``findall`` of CLIP's pre-tokenizer pattern,
    ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``,
    on lowercased text, written out: at each position the first alternative
    that matches is taken, and a position where none matches (white space)
    is skipped."""
    words, i, n = [], 0, len(text)
    while i < n:
        alt = next((a for a in _SPECIAL + _CONTRACTIONS if text.startswith(a, i)), None)
        if alt is not None:
            words.append(alt)
            i += len(alt)
            continue
        cls = _char_class(text[i])
        if cls == " ":
            i += 1
            continue
        j = i + 1
        if cls == "L":
            while j < n and _char_class(text[j]) == "L":
                j += 1
        elif cls == "":
            while j < n and _char_class(text[j]) == "":
                j += 1
        words.append(text[i:j])
        i = j
    return words


def _get_pairs(word: tuple) -> set:
    return set(zip(word[:-1], word[1:]))


class ClipBPETokenizer:
    """OpenAI CLIP's byte-pair tokenizer: clean, lowercase, split
    (:func:`_clip_words`), byte-encode and merge each word by rank with a
    word-final ``</w>``; ``<|startoftext|>`` ids ``<|endoftext|>``, cut to
    ``context_length`` keeping the EOT, zero-padded."""

    def __init__(self, bpe_path, context_length: int = CLIP_CONTEXT_LENGTH):
        self.context_length = context_length
        self.byte_encoder = _bytes_to_unicode()
        merges_raw = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges_raw[1: 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(_SPECIAL)
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache: dict = {}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list:
        ids = []
        for token in _clip_words(_whitespace_clean(_basic_clean(text)).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, text: str) -> np.ndarray:
        ids = [self.sot] + self.encode(text) + [self.eot]
        if len(ids) > self.context_length:
            ids = ids[: self.context_length - 1] + [self.eot]
        out = np.zeros((self.context_length,), dtype=np.int32)
        out[: len(ids)] = ids
        return out


class SpmSiglipTokenizer:
    """HF ``SiglipTokenizer`` on the built-in unigram engine: "▁"-prefix,
    lowercase, strip ASCII punctuation, collapse whitespace, encode
    ``<unk>`` + text without the dummy prefix and drop the unk pieces, append
    ``</s>``, truncate keeping eos, right-pad with ``</s>``."""

    _PUNCT_TABLE = str.maketrans(
        "", "", r"""!"#$%&'()*+,-./:;<=>?@[\]^_`{|}~""")

    def __init__(self, model_path, context_length: int = SIGLIP_CONTEXT_LENGTH,
                 unk_token: str = "<unk>", eos_token: str = "</s>",
                 pad_token: str = "</s>"):
        from bifold_tpu_torch.data.spm import SentencePieceModel

        self.spm = (SentencePieceModel.from_bytes(model_path)
                    if isinstance(model_path, bytes)
                    else SentencePieceModel.load(model_path))
        self.spm.add_dummy_prefix = False
        self.context_length = context_length
        self.unk_token = unk_token
        self.eot = self.spm.piece_to_id(eos_token)
        self.pad = self.spm.piece_to_id(pad_token)
        self.vocab_size = self.spm.vocab_size
        self._unk_len = len(self.spm.encode_pieces(unk_token))

    def encode(self, text: str) -> list[int]:
        text = ("▁" + text.replace("▁", " ")).lower()
        text = text.translate(self._PUNCT_TABLE)
        text = re.sub(r"\s+", " ", text).strip()
        pieces = self.spm.encode_pieces(self.unk_token + text)
        if len(pieces) >= self._unk_len:
            pieces = pieces[self._unk_len:]
        return self.spm.pieces_to_ids(pieces)

    def __call__(self, text: str) -> np.ndarray:
        ids = self.encode(text)[: self.context_length - 1] + [self.eot]
        out = np.full((self.context_length,), self.pad, dtype=np.int32)
        out[: len(ids)] = ids
        return out


class SpmT5Tokenizer:
    """HF ``T5Tokenizer`` in its default legacy mode on the built-in
    unigram engine: plain unigram encode with the model's own
    ``add_dummy_prefix`` (no lowercasing or punctuation stripping), append
    ``</s>``, right-pad with ``<pad>``."""

    def __init__(self, model_path, context_length: int = CLIP_CONTEXT_LENGTH):
        from bifold_tpu_torch.data.spm import SentencePieceModel

        self.spm = (SentencePieceModel.from_bytes(model_path)
                    if isinstance(model_path, bytes)
                    else SentencePieceModel.load(model_path))
        self.context_length = context_length
        self.eot = self.spm.piece_to_id("</s>")
        self.pad = self.spm.piece_to_id("<pad>")
        self.vocab_size = self.spm.vocab_size

    def __call__(self, text: str) -> np.ndarray:
        ids = self.spm.encode(text)[: self.context_length - 1] + [self.eot]
        out = np.full((self.context_length,), self.pad, dtype=np.int32)
        out[: len(ids)] = ids
        return out


def siglip_spm_path(autoprocessor_name: Optional[str] = None) -> Optional[Path]:
    """The SigLIP ``spiece.model``: ``$BIFOLD_SIGLIP_SPM``, else a copy in
    this package's ``data/assets``, else a local HF hub snapshot keyed to
    ``autoprocessor_name`` (the generic ``*siglip*`` glob only for siglip
    names). None when absent."""
    env = os.environ.get("BIFOLD_SIGLIP_SPM")
    if env and Path(env).exists():
        return Path(env)
    vendored = Path(__file__).parent / "assets" / "spiece.model"
    if vendored.exists():
        return vendored
    hub = Path(os.environ.get("HF_HOME",
                              Path.home() / ".cache" / "huggingface")) / "hub"
    pats = []
    if autoprocessor_name:
        pats.append("models--" + autoprocessor_name.replace("/", "--"))
    if autoprocessor_name is None or "siglip" in autoprocessor_name.lower():
        pats += ["models--google--siglip-*", "models--*siglip*"]
    for pat in pats:
        for cand in sorted(hub.glob(f"{pat}/snapshots/*/spiece.model")):
            return cand
    return None


def ensure_spm_fixture() -> Optional[Path]:
    """Point ``$BIFOLD_SIGLIP_SPM`` at the generated fixture model when no
    real ``spiece.model`` resolves, so smokes run the real Viterbi path
    (fixture ids, not the SigLIP vocabulary). Returns the path in use, or
    None when a real asset already resolves."""
    if siglip_spm_path("siglip-base") is not None:
        return None
    import tempfile

    from bifold_tpu_torch.data.spm import fixture_model_bytes

    uid = os.getuid() if hasattr(os, "getuid") else 0
    path = Path(tempfile.gettempdir()) / f"bifold_spm_fixture_{uid}.model"
    blob = fixture_model_bytes()
    if not (path.exists() and path.read_bytes() == blob):
        tmp = path.with_suffix(f".tmp{os.getpid()}")
        tmp.write_bytes(blob)
        tmp.replace(path)
    os.environ["BIFOLD_SIGLIP_SPM"] = str(path)
    return path


def clip_bpe_path() -> Optional[Path]:
    """The CLIP BPE merges file: ``$BIFOLD_CLIP_BPE``, else the port's own
    copy in ``data/assets``; None when neither exists."""
    env = os.environ.get("BIFOLD_CLIP_BPE")
    if env and Path(env).exists():
        return Path(env)
    vendored = Path(__file__).parent / "assets" / "bpe_simple_vocab_16e6.txt.gz"
    return vendored if vendored.exists() else None


def _warn_hash_fallback(missing: str) -> None:
    import warnings
    warnings.warn(
        f"tokenizer falling back to deterministic hashing (no {missing}): fine "
        "for random-weight smokes, wrong for pretrained checkpoints; set "
        "$BIFOLD_SIGLIP_SPM or $BIFOLD_CLIP_BPE, or put the checkpoint's "
        "spiece.model in its T5 dir", stacklevel=3)


def build_tokenizer(autoprocessor_name: Optional[str], spm_asset=None,
                    text_encoder: Optional[str] = None):
    """The tokenizer the JAX package picks: SigLIP's for an
    ``autoprocessor_name`` (``spm_asset``, a ``spiece.model`` path or its
    bytes, when given, else the resolved asset); else CLIP's BPE for a CLIP
    model name (:data:`CLIP_MODEL_NAMES`) or no ``text_encoder``; either
    falls back, loudly, to hashing in its layout when its asset is missing.
    Any other ``text_encoder`` is a T5 encoder: a local T5 checkpoint dir's
    ``spiece.model``, else (loudly) a hash in T5's layout capped at the
    dir's vocabulary, at a registry name's (``T5_CONFIGS``), or at CLIP's
    size for any other name."""
    if autoprocessor_name:
        if spm_asset is None:
            spm_asset = siglip_spm_path(autoprocessor_name)
        if spm_asset is not None:
            return SpmSiglipTokenizer(spm_asset)
        _warn_hash_fallback(f"sentencepiece model for {autoprocessor_name!r}")
        return HashTokenizer(_SIGLIP_VOCAB_SIZE, SIGLIP_CONTEXT_LENGTH)
    if text_encoder is None or text_encoder in CLIP_MODEL_NAMES:
        bpe = clip_bpe_path()
        if bpe is not None:
            return ClipBPETokenizer(bpe)
        _warn_hash_fallback("CLIP BPE merges file")
        return HashTokenizer(_CLIP_VOCAB_SIZE, CLIP_CONTEXT_LENGTH,
                             sot=_CLIP_VOCAB_SIZE - 2, eot=_CLIP_VOCAB_SIZE - 1,
                             pad=0)
    from bifold_tpu_torch.models.backbones.t5_backbone import T5_CONFIGS

    vocab = _CLIP_VOCAB_SIZE
    cfg_path = Path(str(text_encoder)) / "config.json"
    if cfg_path.is_file():
        raw = json.loads(cfg_path.read_text())
        if raw.get("model_type") == "t5":
            spm = cfg_path.parent / "spiece.model"
            if spm.exists():
                return SpmT5Tokenizer(spm)
            _warn_hash_fallback(f"spiece.model in {text_encoder!r}")
            return HashTokenizer(int(raw.get("vocab_size", 32128)), CLIP_CONTEXT_LENGTH,
                                 eot=1, pad=0, drop_punctuation=False)
    elif text_encoder in T5_CONFIGS:
        vocab = T5_CONFIGS[text_encoder].vocab_size
    _warn_hash_fallback(f"tokenizer assets for {text_encoder!r}")
    return HashTokenizer(vocab, CLIP_CONTEXT_LENGTH, eot=1, pad=0,
                         drop_punctuation=False)
