"""The SigLIP text path: fixed-length int32 ids, offline.

The port's own copy of the SigLIP parts of bifold_tpu/data/tokenizers.py
(:220-345, :395-485): the sentencepiece tokenizer on the built-in unigram
engine (:mod:`bifold_tpu_torch.data.spm`), the asset lookup, the generated
fixture model for smokes, and the deterministic hashing fallback used when
no ``spiece.model`` is available. The same asset gives the same ids as the
JAX package.
"""

from __future__ import annotations

import hashlib
import html
import os
import re
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["HashTokenizer", "SpmSiglipTokenizer", "build_tokenizer",
           "siglip_spm_path", "ensure_spm_fixture", "SIGLIP_CONTEXT_LENGTH"]

SIGLIP_CONTEXT_LENGTH = 64
_SIGLIP_VOCAB_SIZE = 32000


def _stable_hash(token: str) -> int:
    return int.from_bytes(hashlib.md5(token.encode("utf-8")).digest()[:8], "little")


class HashTokenizer:
    """Deterministic word-level stand-in: lowercase, strip punctuation, map
    each word to a stable hash bucket; SigLIP layout (eos 1, pad 1)."""

    def __init__(self, vocab_size: int, context_length: int,
                 eot: int = 1, pad: int = 1, reserved: int = 3):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.eot = eot
        self.pad = pad
        self.reserved = reserved

    def __call__(self, text: str) -> np.ndarray:
        text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)).strip())
        words = re.findall(r"[a-z0-9]+", text.strip().lower())
        span = self.vocab_size - self.reserved
        ids = [self.reserved + _stable_hash(w) % span for w in words]
        ids = ids[: self.context_length - 1] + [self.eot]
        out = np.full((self.context_length,), self.pad, dtype=np.int32)
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


def build_tokenizer(autoprocessor_name: Optional[str], spm_asset=None):
    """The SigLIP tokenizer for ``autoprocessor_name``: ``spm_asset`` (a
    ``spiece.model`` path or its bytes) when given, else the resolved asset,
    else a loud hashing fallback with the same layout."""
    if not autoprocessor_name:
        raise NotImplementedError(
            "only the SigLIP (autoprocessor) text path is ported")
    if spm_asset is None:
        spm_asset = siglip_spm_path(autoprocessor_name)
    if spm_asset is not None:
        return SpmSiglipTokenizer(spm_asset)
    import warnings
    warnings.warn(
        f"tokenizer falling back to deterministic hashing (no sentencepiece "
        f"model for {autoprocessor_name!r}): fine for random-weight smokes, "
        "wrong for pretrained checkpoints; set $BIFOLD_SIGLIP_SPM",
        stacklevel=2)
    return HashTokenizer(_SIGLIP_VOCAB_SIZE, SIGLIP_CONTEXT_LENGTH)
