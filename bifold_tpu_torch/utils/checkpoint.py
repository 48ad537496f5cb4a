"""Trainer checkpoints in the JAX package's format, read and written without JAX.

Counterpart of bifold_tpu/utils/checkpoint.py. Reading
(:175 ``load_checkpoint``) takes both the JAX trainer's files and the
port's own. The file is a pickle of the payload that
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

The writing half (:func:`save_checkpoint`, :class:`AsyncCheckpointer`,
:func:`latest_checkpoint`; bifold_tpu/utils/checkpoint.py:57, :134, :209)
writes the same payload keys, atomically (a ``.tmp`` file, then a rename):

- ``params``: the JAX params tree that ``models.convert.convert_bifold``
  makes of the port's state dict, as host numpy arrays. bfloat16 tensors
  (the precast frozen towers) are written as their exact float32 upcast,
  since the port does not import ``ml_dtypes``; a loader re-applies
  ``precast_frozen``. So the JAX package's ``load_checkpoint`` and both
  packages' ``ServingModel.from_checkpoint`` read a port-trained file.
- ``opt_state``: the port's own dict (:meth:`Optimizer.state_dict
  <bifold_tpu_torch.optim.Optimizer.state_dict>`: ``format``, ``count``,
  per trainable parameter name ``mu`` and ``nu`` or ``trace``, the skip and
  accumulation counters). The JAX Trainer cannot resume its optimizer from
  it; the port's Trainer resumes the optimizer from either package's file
  (a JAX file's ``ScaleByAdamState`` gives the Adam moments).
- ``jax_key`` / ``loop_key``: ``torch.Generator.get_state()`` bytes, viewed
  as little-endian uint32 pairs of shape (n, 2) (:func:`pack_generator_state`),
  not JAX key data. The JAX package's reader wraps them as an inert batch of
  keys; :func:`unpack_generator_state` returns the generator state. A file
  of the port says so in ``metadata["writer"]``.
- ``host_rng_states``: named generator states of the port (names start
  with ``torch:``, which the JAX Trainer's restore never matches);
  ``np_rng_state`` and ``py_rng_state`` as JAX writes them.
"""

from __future__ import annotations

import collections
import pickle
import random
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["load_checkpoint", "save_checkpoint", "AsyncCheckpointer",
           "latest_checkpoint", "pack_generator_state", "unpack_generator_state",
           "WRITER"]

WRITER = "bifold_tpu_torch"

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
    """The loaded tree with every pending array replaced by its value (also
    inside the inert stand-ins, whose arguments may hold optimizer state)."""
    if isinstance(obj, _PendingArray):
        return obj.value
    if isinstance(obj, _Inert):
        obj.args, obj.state = _resolve(obj.args), _resolve(obj.state)
        return obj
    if isinstance(obj, dict):
        return {k: _resolve(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_resolve(v) for v in obj]
    if type(obj) is tuple:
        return tuple(_resolve(v) for v in obj)
    return obj


def load_checkpoint(path: str | Path) -> Dict[str, Any]:
    """The payload of a trainer checkpoint at ``path``: the dict that the
    JAX package's ``save_checkpoint`` or :func:`save_checkpoint` wrote, its
    arrays as numpy arrays (``torch.bfloat16`` tensors for bfloat16), its
    optax, jax and flax objects inert. Restores no RNG state."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a trainer checkpoint "
                         "(a pickled dict with 'params')")
    return _resolve(payload)


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def pack_generator_state(state) -> np.ndarray:
    """``torch.Generator.get_state()`` (a uint8 tensor) -> uint32 (n, 2)."""
    raw = np.asarray(torch.as_tensor(state).cpu().numpy(), np.uint8)
    if raw.size % 8:
        raise ValueError(f"generator state of {raw.size} bytes is not a multiple of 8")
    return raw.view("<u4").reshape(-1, 2).copy()


def unpack_generator_state(packed) -> torch.Tensor:
    """The inverse of :func:`pack_generator_state`."""
    raw = np.ascontiguousarray(np.asarray(packed, "<u4")).reshape(-1).view(np.uint8)
    return torch.from_numpy(raw.copy())


def _to_host(tree: Any, copy: bool = False) -> Any:
    """A tree of tensors and arrays as host numpy arrays: bfloat16 tensors
    as their exact float32 upcast; ``copy`` gives arrays that share no
    memory with the caller's (a CPU tensor's ``numpy()`` would)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return arr.copy() if copy and t.device.type == "cpu" else arr
    if isinstance(tree, np.ndarray):
        return tree.copy() if copy else tree
    if isinstance(tree, dict):
        return {k: _to_host(v, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v, copy) for v in tree)
    return tree


def _build_payload(*, params, opt_state=None, extra_vars=None, epoch=0,
                   best_eval=None, jax_key=None, step=0, step_in_epoch=0,
                   loop_key=None, metadata=None, host_rng_states=None,
                   copy=False) -> Dict:
    """The payload of bifold_tpu/utils/checkpoint.py:_build_payload (:83),
    fetched to the host now: ``jax_key`` and ``loop_key`` are generator
    states (or None), packed by :func:`pack_generator_state`."""
    return {
        "params": _to_host(params, copy),
        "opt_state": _to_host(opt_state, copy),
        "extra_vars": _to_host(extra_vars, copy),
        "epoch": epoch,
        "step": step,
        "step_in_epoch": int(step_in_epoch),
        "best_eval": best_eval,
        "np_rng_state": np.random.get_state(),
        "py_rng_state": random.getstate(),
        "host_rng_states": _to_host(host_rng_states or {}, copy),
        "jax_key": None if jax_key is None else pack_generator_state(jax_key),
        "loop_key": None if loop_key is None else pack_generator_state(loop_key),
        "metadata": {**(metadata or {}), "writer": WRITER},
    }


def _write_payload(path: Path, payload: Dict) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    return path


def save_checkpoint(path: str | Path, **fields) -> Path:
    """Write a checkpoint at ``path`` atomically (tmp + rename). ``fields``
    are those of the JAX package's ``save_checkpoint``: ``params``,
    ``opt_state``, ``extra_vars``, ``epoch``, ``best_eval``, ``jax_key``,
    ``step``, ``step_in_epoch``, ``loop_key``, ``metadata``,
    ``host_rng_states``; an unknown one is a TypeError."""
    return _write_payload(Path(path), _build_payload(**fields))


class AsyncCheckpointer:
    """Checkpoint writes off the training loop: :meth:`save` copies
    everything to host memory inline (later steps update the parameters in
    place), then pickles and writes in a thread. At most one write is in
    flight: a new ``save`` (or ``wait``) joins the previous one first and
    raises its error, so a failed write is never lost. Call :meth:`wait`
    before reading the file back and at shutdown."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str | Path, **fields) -> Path:
        self.wait()
        path = Path(path)
        payload = _build_payload(copy=True, **fields)

        def write():
            try:
                _write_payload(path, payload)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="bifold-ckpt-writer")
        self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err


def latest_checkpoint(ckpt_dir: str | Path, prefer: str = "last") -> Optional[Path]:
    """``<prefer>.ckpt``, else ``last.ckpt``, else ``best.ckpt`` in
    ``ckpt_dir``; None when there is none."""
    ckpt_dir = Path(ckpt_dir)
    for name in (f"{prefer}.ckpt", "last.ckpt", "best.ckpt"):
        p = ckpt_dir / name
        if p.exists():
            return p
    return None
