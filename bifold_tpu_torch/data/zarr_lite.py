"""Minimal zarr v2 directory-store reader (pure python + ctypes codecs).

The port's copy of bifold_tpu/data/zarr_lite.py. The reference reads the
vr-folding dataset through the `zarr` package (bimanual_dataset.py:24-28),
which a host may lack. This implements the subset needed to read such stores: hierarchical groups (.zgroup/.zattrs),
chunked arrays (.zarray metadata, C order), and the common codecs — blosc
(via the system libblosc), zstd (libzstd), zlib/gzip/bz2/lzma (stdlib), or
raw. Falls back to the real `zarr` package transparently when importable
(bifold_tpu_torch.data.bimanual_dataset prefers it).

Supports read-only access: `open_group(path)["samples"]["x"]["mesh"]
["cloth_verts"][:]` and integer fancy indexing on the first axis.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import zlib
from functools import lru_cache
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np

__all__ = ["open_group", "Group", "Array"]


@lru_cache()
def _blosc():
    for name in ("blosc", "libblosc.so.1", "libblosc.so"):
        path = ctypes.util.find_library(name) if "/" not in name else name
        try:
            lib = ctypes.CDLL(path or name)
            lib.blosc_decompress_ctx.restype = ctypes.c_int
            lib.blosc_decompress_ctx.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
            return lib
        except OSError:
            continue
    return None


@lru_cache()
def _zstd():
    for name in ("zstd", "libzstd.so.1", "libzstd.so"):
        path = ctypes.util.find_library(name) if "/" not in name else name
        try:
            lib = ctypes.CDLL(path or name)
            lib.ZSTD_decompress.restype = ctypes.c_size_t
            lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                            ctypes.c_void_p, ctypes.c_size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            return lib
        except OSError:
            continue
    return None


def _decompress(raw: bytes, compressor: Optional[dict], nbytes: int) -> bytes:
    if compressor is None:
        return raw
    cid = compressor.get("id")
    if cid == "blosc":
        lib = _blosc()
        if lib is None:
            raise RuntimeError("blosc-compressed zarr chunk but libblosc is "
                               "not available on this system")
        out = ctypes.create_string_buffer(nbytes)
        n = lib.blosc_decompress_ctx(raw, out, nbytes, 1)
        if n <= 0:
            raise RuntimeError(f"blosc decompression failed (code {n})")
        return out.raw[:n]
    if cid == "zstd":
        lib = _zstd()
        if lib is None:
            raise RuntimeError("zstd-compressed zarr chunk but libzstd missing")
        out = ctypes.create_string_buffer(nbytes)
        n = lib.ZSTD_decompress(out, nbytes, raw, len(raw))
        if lib.ZSTD_isError(ctypes.c_size_t(n)):
            raise RuntimeError("zstd decompression failed")
        return out.raw[:n]
    if cid in ("zlib", "gzip"):
        return zlib.decompress(raw, zlib.MAX_WBITS | (16 if cid == "gzip" else 0))
    if cid == "bz2":
        import bz2
        return bz2.decompress(raw)
    if cid == "lzma":
        import lzma
        return lzma.decompress(raw)
    raise RuntimeError(f"Unsupported zarr compressor {cid!r}")


class Array:
    """A read-only chunked zarr v2 array."""

    def __init__(self, path: Path):
        self.path = Path(path)
        meta = json.loads((self.path / ".zarray").read_text())
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.compressor = meta.get("compressor")
        self.fill_value = meta.get("fill_value", 0)
        self.order = meta.get("order", "C")
        self.sep = meta.get("dimension_separator", ".")
        if meta.get("filters"):
            raise RuntimeError("zarr filters are not supported by zarr_lite")

    def _chunk(self, idx: tuple) -> np.ndarray:
        name = self.sep.join(str(i) for i in idx) if self.shape else "0"
        fp = self.path / name
        csize = int(np.prod(self.chunks)) if self.chunks else 1
        if not fp.exists():
            fill = 0 if self.fill_value is None else self.fill_value
            return np.full(self.chunks, fill, self.dtype)
        raw = fp.read_bytes()
        buf = _decompress(raw, self.compressor, csize * self.dtype.itemsize)
        arr = np.frombuffer(buf, self.dtype, count=csize)
        return arr.reshape(self.chunks, order=self.order)

    def __len__(self) -> int:
        return self.shape[0] if self.shape else 0

    def _materialize(self) -> np.ndarray:
        out = np.empty(self.shape, self.dtype)
        grid = [range((s + c - 1) // c) for s, c in zip(self.shape, self.chunks)]
        import itertools
        for idx in itertools.product(*grid):
            chunk = self._chunk(idx)
            slices = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(idx, self.chunks, self.shape))
            trim = tuple(slice(0, sl.stop - sl.start) for sl in slices)
            out[slices] = chunk[trim]
        return out

    def __getitem__(self, key) -> np.ndarray:
        return self._materialize()[key]

    def __array__(self, dtype=None):
        arr = self._materialize()
        return arr.astype(dtype) if dtype is not None else arr


class Group:
    """A zarr v2 hierarchy node (directory with .zgroup / child arrays)."""

    def __init__(self, path: Path):
        self.path = Path(path)

    @property
    def attrs(self) -> dict:
        f = self.path / ".zattrs"
        return json.loads(f.read_text()) if f.exists() else {}

    def __contains__(self, key: str) -> bool:
        return (self.path / key).is_dir()

    def __iter__(self) -> Iterator[str]:
        for child in sorted(self.path.iterdir()):
            if child.is_dir():
                yield child.name

    def keys(self) -> Iterator[str]:
        return iter(self)

    def get(self, key: str, default: Any = None):
        try:
            return self[key]
        except KeyError:
            return default

    def __getitem__(self, key: str):
        node = self.path
        for part in str(key).split("/"):
            node = node / part
        if (node / ".zarray").exists():
            return Array(node)
        if node.is_dir():
            return Group(node)
        raise KeyError(key)


def open_group(path, mode: str = "r") -> Group:
    """Open a directory store; prefers the real `zarr` package when present."""
    assert mode == "r", "zarr_lite is read-only"
    try:
        import zarr  # noqa: WPS433
        return zarr.open(str(path), mode="r")
    except ImportError:
        pass
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    return Group(path)
