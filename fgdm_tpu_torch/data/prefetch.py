"""The input pipeline: batches assembled by worker threads, then copied to
the device ahead of the step.

Counterpart of ``fgdm_tpu/data/prefetch.py`` (the reference's
``DataLoader(num_workers)``, ``main.py:225-242``):

* ``ParallelBatchLoader`` assembles batches in a thread pool while the
  device computes.  Threads, not processes: the per-sample work (Pillow's
  resizes, the ctypes transforms of ``data/native.py``) runs outside the
  interpreter lock, and nothing is pickled.  Batches come out in submission
  order; the shuffle depends on ``seed`` and the epoch only, and each
  sample's augmentation RNG on ``(dataset.seed, epoch, idx)``
  (``SemanticDataset.sample``), so a run reproduces exactly whatever the
  worker count.  ``process_index``/``process_count`` cut each global batch
  into contiguous per-process slices, as in JAX.
* ``device_prefetch`` keeps ``size`` batches in flight on the device.  On a
  CUDA device each array goes to pinned host memory and is copied
  ``non_blocking`` on a side stream, where the NHWC images become the NCHW
  tensors the step takes (``train/train_step.py``); the consumer's stream
  waits on an event recorded after that batch's copies (never a
  ``synchronize()``), and every tensor is marked ``record_stream`` for the
  consumer's stream, so the allocator does not hand its memory to the side
  stream while a step still reads it.  With ``mesh`` the device is the
  rank's own (``parallel.mesh.mesh_device``) and the batches are its rows
  of the global batch: a ``ParallelBatchLoader`` built with
  ``process_index``/``process_count`` = the rank's place on the ``data``
  dim and its size (``parallel.mesh.data_rank``/``data_size``) cuts them.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from fgdm_tpu_torch.data.dataset import stack_items
from fgdm_tpu_torch.utils.profiling import span

__all__ = ["ParallelBatchLoader", "device_prefetch", "to_device",
           "NHWC_KEYS"]

NHWC_KEYS = ("image", "rgb", "latent")   # 4-D arrays made NCHW on the way


def _assemble(dataset, idxs, tokenizer, epoch: int = 0) -> Dict[str, Any]:
    # ``sample(idx, salt)`` seeds each sample's augmentation from (epoch,
    # idx): the same whatever thread runs it
    if hasattr(dataset, "sample"):
        items = [dataset.sample(int(i), epoch) for i in idxs]
    else:
        items = [dataset[int(i)] for i in idxs]
    return stack_items(items, tokenizer)


class ParallelBatchLoader:
    """Iterable over batches assembled by ``num_workers`` threads, with up
    to ``prefetch_batches`` batches in flight ahead of the consumer."""

    def __init__(self, dataset, batch_size: int, tokenizer=None,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = True,
                 epochs: Optional[int] = None, num_workers: int = 8,
                 prefetch_batches: int = 4, process_index: int = 0,
                 process_count: int = 1):
        """``batch_size`` is global: process ``process_index`` of
        ``process_count`` assembles its contiguous ``batch_size /
        process_count`` rows of every batch, from a shuffle that is the same
        on every process."""
        if batch_size % process_count:
            raise ValueError(f"global batch {batch_size} must divide over "
                             f"{process_count} processes")
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} outside "
                             f"[0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.tokenizer = tokenizer
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epochs = epochs
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.process_index = process_index
        self.process_count = process_count

    def _index_batches(self):
        rng = np.random.default_rng(self.seed)
        n = len(self.dataset)
        local_bs = self.batch_size // self.process_count
        lo = self.process_index * local_bs
        epoch = 0
        while self.epochs is None or epoch < self.epochs:
            order = np.arange(n)
            if self.shuffle:
                rng.shuffle(order)
            for start in range(0, n, self.batch_size):
                idxs = order[start:start + self.batch_size]
                # a ragged tail is dropped, and never split over processes
                if len(idxs) < self.batch_size and (
                        self.drop_last or self.process_count > 1):
                    break
                yield epoch, idxs[lo:lo + local_bs]
            epoch += 1

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        pending: collections.deque = collections.deque()
        with ThreadPoolExecutor(self.num_workers) as pool:
            try:
                for epoch, idxs in self._index_batches():
                    pending.append(pool.submit(_assemble, self.dataset, idxs,
                                               self.tokenizer, epoch))
                    if len(pending) >= self.prefetch_batches:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()


KEYS = ("image", "input_ids", "rgb", "latent", "parts")


def to_device(batch: Dict[str, Any], device, keys=KEYS) -> Dict[str, Any]:
    """One batch with the arrays under ``keys`` as tensors on ``device``,
    the 4-D ``image``/``rgb``/``latent`` NCHW, copied now (no prefetch)."""
    out = dict(batch)
    for k in keys:
        if k in out and hasattr(out[k], "shape"):
            t = torch.from_numpy(np.ascontiguousarray(out[k]))
            if k in NHWC_KEYS and t.dim() == 4:
                t = t.permute(0, 3, 1, 2)
            out[k] = t.contiguous().to(device)
    return out


def device_prefetch(iterator, device=None, size: int = 2, keys=KEYS,
                    mesh=None):
    """Yield the batches of ``iterator`` with the arrays under ``keys`` as
    tensors on ``device`` (CUDA unless named; the rank's device of
    ``mesh`` when given), ``size`` batches ahead; 4-D
    ``image``/``rgb``/``latent`` arrays become NCHW.  Other entries (the
    captions) pass through."""
    from fgdm_tpu_torch import resolve_device

    if mesh is not None:
        from fgdm_tpu_torch.parallel.mesh import mesh_device

        device = mesh_device(mesh)
    dev = resolve_device(device)
    it = iter(iterator)
    if dev.type != "cuda":
        def take():
            batch = next(it, None)
            return None if batch is None else to_device(batch, dev, keys)

        yield from _spanned(take)
        return

    copy_stream = torch.cuda.Stream(dev)

    def put(batch):
        out = dict(batch)
        with torch.cuda.stream(copy_stream):
            for k in keys:
                if k in out and hasattr(out[k], "shape"):
                    host = torch.from_numpy(
                        np.ascontiguousarray(out[k])).pin_memory()
                    t = host.to(dev, non_blocking=True)
                    if k in NHWC_KEYS and t.dim() == 4:
                        t = t.permute(0, 3, 1, 2).contiguous()
                    out[k] = t
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def hand_over(entry):
        out, done = entry
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for k in keys:
            if isinstance(out.get(k), torch.Tensor):
                out[k].record_stream(consumer)
        return out

    buf: collections.deque = collections.deque()

    def take():
        for batch in it:   # until ``size`` batches wait behind the next
            buf.append(put(batch))
            if len(buf) > size:
                break
        return hand_over(buf.popleft()) if buf else None

    yield from _spanned(take)


def _spanned(take):
    """Yield ``take()`` until it gives None, each call (the upstream fetch,
    the copy and the hand-over of one batch) in a ``data.next_batch`` span
    that closes before the yield: the consumer's spans do not nest in
    it."""
    while True:
        with span("data.next_batch"):
            out = take()
        if out is None:
            return
        yield out
