"""Reading a checkpoint that the JAX trainer wrote, without JAX.

Counterpart of the reading half of bifold_tpu/utils/checkpoint.py
(:175 ``load_checkpoint``). The file is a pickle of the payload that
``_build_payload`` (:83) assembles: ``params`` and ``extra_vars`` as trees
of host numpy arrays, ``opt_state`` as optax's state classes
(``optax._src.transform.ScaleByAdamState``, ``optax._src.base.EmptyState``,
...), and RNG states, keys and bookkeeping. Under the trainer's
``precast_frozen`` default the frozen tower weights are bfloat16 arrays,
whose dtype pickles as the global ``ml_dtypes.bfloat16``.

:func:`load_checkpoint` reads it with a restricted unpickler that imports
nothing:

- numpy's array and dtype reconstruction, numpy scalars and a few inert
  builtins are admitted;
- every class of optax, jax, jaxlib, flax or chex becomes an inert stand-in
  that keeps its arguments (only ``params`` and ``extra_vars`` are used);
  flax's ``FrozenDict`` becomes a dict;
- a bfloat16 array is read as its raw 2-byte payload into a
  ``torch.bfloat16`` tensor, without ml_dtypes;
- any other global is refused with :class:`pickle.UnpicklingError`.
"""

from __future__ import annotations

import collections
import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["load_checkpoint"]

_MULTIARRAY = ("numpy.core.multiarray", "numpy._core.multiarray")
_NUMERIC = ("numpy.core.numeric", "numpy._core.numeric")
_INERT_ROOTS = ("optax", "jax", "jaxlib", "flax", "chex")
_SCALAR = np.float64(0).__reduce__()[0]      # numpy's scalar reconstructor
_BUILTINS = {("builtins", "set"): set, ("builtins", "frozenset"): frozenset,
             ("builtins", "complex"): complex, ("builtins", "slice"): slice,
             ("builtins", "bytearray"): bytearray, ("builtins", "range"): range,
             ("collections", "OrderedDict"): collections.OrderedDict}


class _Bfloat16:
    """Stands in for ``ml_dtypes.bfloat16`` (the scalar type)."""


class _Bfloat16Dtype:
    """Stands in for ``numpy.dtype(ml_dtypes.bfloat16)``; numpy's pickled
    dtype state that follows it is ignored."""

    def __setstate__(self, state):
        pass


_BF16 = _Bfloat16Dtype()


def _dtype(obj, align=False, copy=False):
    if obj is _Bfloat16:
        return _BF16
    return np.dtype(obj, align, copy)


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """bfloat16 payload bits (a uint16 array) as a torch.bfloat16 tensor."""
    return torch.from_numpy(np.array(bits, order="C")).view(torch.bfloat16)


class _PendingArray:
    """What numpy's ``_reconstruct`` returns while unpickling: the array is
    made when its state arrives (``value``), as a torch tensor for
    bfloat16."""

    value: Any = None

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if dtype is _BF16:
            bits = np.frombuffer(raw, np.uint16)
            self.value = _bf16_tensor(bits.reshape(tuple(shape)[::-1]).T if fortran
                                      else bits.reshape(shape))
        else:
            arr = np.empty(0, np.uint8)
            arr.__setstate__(state)
            self.value = arr


def _reconstruct(cls, shape, typecode):
    if cls is not np.ndarray:
        raise pickle.UnpicklingError(f"array subclass {cls!r} in a checkpoint")
    return _PendingArray()


def _frombuffer(buf, dtype, shape, order, axis_order=None):
    """numpy's ``_frombuffer`` (protocol-5 arrays; numpy 2.3 adds
    ``axis_order``), into an array the caller owns."""
    flat = np.frombuffer(buf, np.uint16 if dtype is _BF16 else dtype)
    if order == "K" and axis_order is not None:
        arr = flat.reshape(shape, order="C").transpose(axis_order)
    else:
        arr = flat.reshape(shape, order=order)
    return _bf16_tensor(arr) if dtype is _BF16 else np.array(arr)


class _Inert:
    """Stands in for a class of optax, jax or flax: keeps what the pickle
    hands it and does nothing with it."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args, obj.state = args, None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


_INERT: Dict[str, type] = {}


def _inert(module: str, name: str):
    if name == "FrozenDict":
        return dict
    key = f"{module}.{name}"
    if key not in _INERT:
        _INERT[key] = type(name, (_Inert,), {"__qualname__": key})
    return _INERT[key]


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _MULTIARRAY and name == "_reconstruct":
            return _reconstruct
        if module in _MULTIARRAY and name == "scalar":
            return _SCALAR
        if module in _NUMERIC and name == "_frombuffer":
            return _frombuffer
        if module == "numpy" and name == "ndarray":
            return np.ndarray
        if module == "numpy" and name == "dtype":
            return _dtype
        if module == "ml_dtypes" and name == "bfloat16":
            return _Bfloat16
        if (module, name) in _BUILTINS:
            return _BUILTINS[(module, name)]
        if module.split(".")[0] in _INERT_ROOTS:
            return _inert(module, name)
        raise pickle.UnpicklingError(
            f"checkpoint refers to {module}.{name}; the port reads numpy "
            "arrays, bfloat16 payloads and inert optax/jax/flax state only")


def _resolve(obj):
    """The loaded tree with every pending array replaced by its value."""
    if isinstance(obj, _PendingArray):
        return obj.value
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    if type(obj) is tuple:
        return tuple(_resolve(v) for v in obj)
    return obj


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """The payload of a JAX trainer checkpoint at ``path``: the dict that
    ``bifold_tpu.utils.checkpoint.save_checkpoint`` wrote, its arrays as
    numpy arrays (``torch.bfloat16`` tensors for bfloat16), its optax, jax
    and flax objects inert. Restores no RNG state."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a checkpoint of the JAX trainer "
                         "(a pickled dict with 'params')")
    return _resolve(payload)
