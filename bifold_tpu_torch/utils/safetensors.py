"""The safetensors file format, read and written without the ``safetensors``
package.

A file is an 8-byte little-endian header length N, N bytes of a JSON header
(``{name: {"dtype": "F32", "shape": [...], "data_offsets": [begin, end]},
"__metadata__": {...}}``, offsets into the byte buffer that follows), then
that buffer: each tensor's raw little-endian bytes in row-major order.
``BF16`` has no numpy dtype, so it is read as ``uint16`` and viewed as
``torch.bfloat16``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["load_file", "save_file"]

_NUMPY = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8",
          "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}
_NAMES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
          torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
          torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}


def load_file(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, on the CPU, by name."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file ({len(raw)} bytes)")
    (n,) = struct.unpack("<Q", raw[:8])
    if 8 + n > len(raw):
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        kind = info["dtype"]
        if kind not in _NUMPY:
            raise ValueError(f"{path}: {name} has unsupported dtype {kind}")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        arr = np.frombuffer(data[begin:end], dtype=_NUMPY[kind]).reshape(shape)
        if kind == "BF16":
            out[name] = torch.from_numpy(arr.view("<i2").copy()).view(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(arr.copy())
    return out


def save_file(tensors: Dict[str, torch.Tensor], path,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; contiguous copies are taken) to
    ``path`` in the order given, the header padded with spaces to 8 bytes."""
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        blob = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        blob = blob.astype(blob.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    if metadata:
        header["__metadata__"] = dict(metadata)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for blob in blobs:
            f.write(blob)
