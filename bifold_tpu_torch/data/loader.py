"""Host-side batching loader feeding the device-side Processor.

Counterpart of bifold_tpu/data/loader.py (``collate`` :31, ``DataLoader``
:53): dataset ``__getitem__`` does the cheap decode/tokenize work, records
are collated as numpy and handed to the Processor, which transforms the
whole batch on the loader's device, and a background thread builds the
next batches while the device computes (``prefetch`` batches in a bounded
queue).

Randomness is stateless and index-derived, as in the JAX package: the
epoch's shuffle permutation comes from ``default_rng([seed, epoch])`` and
each batch's augmentation from a ``torch.Generator`` on the device seeded
with ``default_rng([seed, epoch, batch_index]).integers(0, 2**31 - 1)``,
never from a stream that advances as batches are built. Restarting an epoch
at batch K (``start_batch``) therefore rebuilds the remaining batches
exactly, however far the interrupted run's prefetch thread had got. Call
:meth:`DataLoader.set_epoch` each epoch (the Trainer does). The draws are
torch's, not JAX's: the port reproduces its own batches, not the JAX
package's augmentation.

On a CUDA device the producer thread copies each batch's arrays into pinned
host buffers (a ring of ``prefetch + 1`` sets, one reused only after the
event of its last copy has completed), uploads them without blocking and
runs the Processor on a side stream the loader owns, then records an event.
The consumer's current stream waits on that event before the batch is used,
and every tensor of the batch is marked with ``record_stream`` for it, so
the caching allocator never hands its memory to the side stream while the
consumer's kernels still read it. An abandoned iterator (a ``break``, a
preemption) stops the thread within its 5 s join and synchronises the side
stream before the dropped batches are freed.

Data parallelism (bifold_tpu/data/loader.py:80-124): with
``process_count`` > 1 every process walks the same global order and builds
only its contiguous slice (``process_id``) of each global batch of
``batch_size``; ``drop_last`` is then on, so every slice has the same size.
The batch's generator is still the global batch index's, and the Processor
makes the global batch's draws and keeps this slice's
(:meth:`~bifold_tpu_torch.data.processor.Processor.draw`), so each
process's batch is the slice of the batch one process would build.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

__all__ = ["DataLoader", "collate"]


def collate(records: list) -> Dict[str, Any]:
    """Stack a list of raw records into one batch dict.

    ndarray values stack; strings and other scalars become lists;
    ``label_keys`` (identical across records) passes through.
    """
    batch: Dict[str, Any] = {}
    first = records[0]
    for k, v in first.items():
        if k == "label_keys":
            batch[k] = v
        elif isinstance(v, np.ndarray):
            batch[k] = np.stack([r[k] for r in records])
        elif isinstance(v, (np.integer, int, float, np.floating)):
            batch[k] = np.asarray([r[k] for r in records])
        else:
            batch[k] = [r[k] for r in records]
    return batch


class _Staged:
    """A processed batch on a CUDA device and the event its side-stream
    work recorded."""

    def __init__(self, batch: Dict[str, Any], ready: torch.cuda.Event):
        self.batch = batch
        self.ready = ready


class _PinnedRing:
    """Sets of pinned host buffers, keyed by array name, taken in turn; a set
    is handed out again only after the event recorded after its uploads has
    completed."""

    def __init__(self, n: int):
        self.slots = [({}, None) for _ in range(n)]
        self.next = 0

    def upload(self, batch: Dict[str, Any], device, stream) -> Dict[str, torch.Tensor]:
        buffers, copied = self.slots[self.next]
        if copied is not None:
            copied.synchronize()
        x = {}
        with torch.cuda.stream(stream):
            for k, v in batch.items():
                if not isinstance(v, np.ndarray):
                    continue
                buf = buffers.get(k)
                if buf is None or tuple(buf.shape) != v.shape or buf.numpy().dtype != v.dtype:
                    buf = torch.from_numpy(np.empty_like(v)).pin_memory()
                    buffers[k] = buf
                buf.numpy()[...] = v
                x[k] = buf.to(device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        self.slots[self.next] = (buffers, copied)
        self.next = (self.next + 1) % len(self.slots)
        return x


class DataLoader:
    """Shuffling/batching iterator over a raw-record dataset.

    Each yielded batch has been through the Processor on ``device``
    (model-ready tensors, plus ``raw_instruction``). ``drop_last`` defaults
    to ``shuffle`` (True for train) so train batch shapes stay fixed.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: Optional[bool] = None,
                 num_workers: int = 0, prefetch: int = 2, device="cpu",
                 process_id: int = 0, process_count: int = 1):
        if batch_size % process_count:
            raise ValueError(f"global batch_size {batch_size} must be divisible by "
                             f"process_count {process_count}")
        self.process_id, self.process_count = process_id, process_count
        self._local_bs = batch_size // process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last
        if process_count > 1:
            self.drop_last = True     # equal slices on every process
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self._seed = int(seed)
        self.epoch = 0
        # one-shot mid-epoch resume point: __iter__ starts at this batch
        # index (then resets to 0); the Trainer sets it when a checkpoint
        # carries step_in_epoch > 0
        self.start_batch = 0
        self.processor = dataset.processor
        self.device = torch.device(device)
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._ring = _PinnedRing(self.prefetch + 1)
        else:
            self._stream = self._ring = None

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """Select the epoch whose (seed, epoch)-derived permutation and batch
        generators the next iteration uses."""
        self.epoch = int(epoch)

    def index_batches(self, start: int = 0):
        """(batch index, dataset indices of this process's slice) of this
        epoch from batch ``start``."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng([self._seed, self.epoch]).shuffle(idx)
        lo = self.process_id * self._local_bs
        for b in range(start, len(self)):
            g = idx[b * self.batch_size: (b + 1) * self.batch_size]
            yield b, g[lo: lo + self._local_bs]

    def batch_seed(self, batch_index: int) -> int:
        """The seed of batch ``batch_index``'s augmentation generator, from
        (seed, epoch, batch index) alone."""
        return int(np.random.default_rng(
            [self._seed, self.epoch, batch_index]).integers(0, 2 ** 31 - 1))

    def _make_batch(self, batch_index: int, indices):
        batch = collate([self.dataset[int(i)] for i in indices])
        gen = torch.Generator(self.device).manual_seed(self.batch_seed(batch_index))
        rows = ((self.process_id * self._local_bs, self.batch_size)
                if self.process_count > 1 else None)
        if self.device.type != "cuda":
            return self.processor.process_batch(batch, self.device, generator=gen,
                                                rows=rows)
        x = self._ring.upload(batch, self.device, self._stream)
        with torch.cuda.stream(self._stream):
            out = self.processor.process_tensors(batch, x, generator=gen, rows=rows)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return _Staged(out, ready)

    def _take(self, item) -> Dict[str, Any]:
        """The batch of ``item``, safe to use on the caller's current stream."""
        if not isinstance(item, _Staged):
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.ready)
        for v in item.batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(stream)
        return item.batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        start, self.start_batch = self.start_batch, 0
        if self.prefetch <= 1:
            for b, indices in self.index_batches(start):
                yield self._take(self._make_batch(b, indices))
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error: list = []
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer is gone: a plain
            # q.put() would block for ever on a full queue once the consumer
            # abandons the iterator
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b, indices in self.index_batches(start):
                    if stop.is_set() or not _put(self._make_batch(b, indices)):
                        return
            except BaseException as e:  # noqa: BLE001 - raised on the consumer side
                error.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True, name="bifold-loader")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield self._take(item)
        finally:
            # runs on exhaustion and on generator close/GC
            stop.set()
            while True:     # unblock a producer waiting in put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
            if self._stream is not None:
                # no side-stream work may outlive the batches dropped above
                self._stream.synchronize()
