"""Host -> device input pipeline -- the port of
``weather_unet_tpu/data/pipeline.py``: threaded decode and batching
(``BatchLoader``, in place of torch DataLoader worker processes,
``t_est_train.py:176-196``) and a prefetch that copies batches onto the GPU
ahead of the step from pinned memory on a side stream.

Under a process group (``parallel/launch.py``) each rank loads only its
``process_slice`` of every global batch (``process_shard``) and keeps its
rows (the ranks of one data row of a tensor-parallel grid load the same
rows: ``launch.data_index``): where the JAX package assembles one global
array from the hosts' shards, a rank's rows here stay its own, and the
steps all-reduce their gradients instead.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from weather_unet_tpu_torch.parallel.launch import (
    data_count, process_slice)


def _stack(samples):
    """Collate per-sample tuples into a tuple of stacked arrays (fields that
    are not numbers or arrays become object arrays, e.g. photo ids)."""
    out = []
    for f in zip(*samples):
        first = f[0]
        if isinstance(first, np.ndarray):
            out.append(np.stack(f))
        elif isinstance(first, (int, float, bool, np.integer, np.floating)):
            out.append(np.asarray(f))
        else:
            out.append(np.asarray(f, dtype=object))
    return tuple(out)


class BatchLoader:
    """Iterable over collated batches with threaded sample loading.

    The knobs are the reference DataLoader's: ``shuffle``, ``drop_last``,
    ``sampler`` (an iterable of indices, e.g. ``ImbalancedSampler``),
    ``num_workers`` (threads).  ``process_shard``: under a process group
    every rank draws the same seeded index sequence (the ``seed`` and the
    sampler's are the caller's to keep equal) and loads only its
    ``process_slice`` of each batch, so a batch of ``batch_size`` global
    rows reaches each of W data rows of ranks as ``batch_size / W`` rows
    (``launch.data_count``: the ranks, unless a tensor-parallel grid puts
    several in one data row); without a process group it changes
    nothing.  A ``drop_last=False`` tail that
    does not divide over the ranks is refused here, not at the epoch's
    last batch.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = True,
                 sampler: Optional[Iterable[int]] = None,
                 num_workers: int = 8, seed: int = 0,
                 process_shard: bool = False):
        pc = data_count()
        if process_shard and not drop_last and pc > 1:
            try:
                n = len(sampler) if sampler is not None else len(dataset)
            except TypeError:
                n = None              # an unsized sampler: no pre-check
            tail = n % batch_size if n is not None else 0
            if tail % pc:
                raise ValueError(
                    f"process_shard with drop_last=False: the tail batch "
                    f"({tail} rows) is not divisible by "
                    f"process_count={pc}, so the epoch would crash at its "
                    f"last batch -- use drop_last=True (what the training "
                    f"CLIs do multi-process) or size the dataset")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sampler = sampler
        self.num_workers = max(1, num_workers)
        self.process_shard = process_shard
        self.seed = seed
        self._rng = np.random.default_rng(seed)

    def set_epoch(self, epoch: int):
        """Reseed the shuffle for ``epoch`` from ``SeedSequence((seed,
        epoch))``, so the order is a function of the absolute epoch and a
        resumed run replays it; the ``sampler`` and the dataset's
        ``transform`` get ``set_epoch`` too where they have it."""
        self._rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, epoch)))
        for obj in (self.sampler, getattr(self.dataset, "transform", None)):
            se = getattr(obj, "set_epoch", None)
            if se is not None:
                se(epoch)

    def __len__(self):
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        return n // self.batch_size if self.drop_last else -(
            -n // self.batch_size)

    def _indices(self):
        if self.sampler is not None:
            return list(iter(self.sampler))
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx.tolist()

    def __iter__(self) -> Iterator[tuple]:
        indices = self._indices()
        bs = self.batch_size
        n_full = len(indices) // bs
        batches = [indices[i * bs:(i + 1) * bs] for i in range(n_full)]
        if not self.drop_last and len(indices) % bs:
            batches.append(indices[n_full * bs:])
        if self.process_shard and data_count() > 1:
            batches = [b[process_slice(len(b))] for b in batches]
        with ThreadPoolExecutor(self.num_workers) as pool:
            # the next batch's samples load while the current one is used
            pending = collections.deque()
            for b in batches[:2]:
                pending.append([pool.submit(self.dataset.__getitem__, i)
                                for i in b])
            k = 2
            while pending:
                futs = pending.popleft()
                if k < len(batches):
                    pending.append([pool.submit(self.dataset.__getitem__, i)
                                    for i in batches[k]])
                    k += 1
                yield _stack([f.result() for f in futs])


def assemble_global_batch(sharding, local: np.ndarray) -> torch.Tensor:
    """This rank's rows of a batch on its device: the DDP counterpart of
    the JAX package's ``assemble_global_batch``, which builds one global
    array from every process's rows.  Here a rank's rows stay its own; the
    gradients meet in the steps' all-reduce.  ``sharding`` is a plan's
    ``batch()`` (its first device) or a device."""
    device = (sharding.plan.devices[0] if hasattr(sharding, "plan")
              else torch.device(sharding))
    return torch.as_tensor(np.asarray(local)).to(device)


def device_prefetch(iterator: Iterable, device, depth: int = 2,
                    device_fields: Optional[Sequence[int]] = None,
                    assembly: str = "auto"):
    """Copy batches onto ``device`` ``depth`` steps ahead of their use.

    ``assembly`` says what a batch is under a process group, as in the JAX
    package: ``"process_local"`` this rank's rows (kept as they are),
    ``"global"`` the whole global batch on every rank (each field cut to
    this rank's ``process_slice``), ``"auto"`` process-local under a
    process group of several ranks and global otherwise (where the two are
    the same).

    On CUDA each selected field (a numeric numpy array; ``device_fields``
    picks the tuple positions, default all) is pinned and copied on a side
    stream; the consumer's stream waits on the copy's event before the
    batch is handed over, and the tensor is marked as used on that stream
    (``record_stream``) so its memory is not reused under it.  Fields left
    out (photo ids, labels the caller ships itself) stay on the host.  On
    a CPU device batches pass through unchanged."""
    if assembly not in ("auto", "global", "process_local"):
        raise ValueError(f"unknown assembly mode {assembly!r}")
    if assembly == "global" and data_count() > 1:
        iterator = (tuple(x[process_slice(len(x))]
                          if isinstance(x, np.ndarray) else x for x in b)
                    for b in iterator)
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    copy_stream = torch.cuda.Stream(device)

    def put(batch):
        out = []
        with torch.cuda.stream(copy_stream):
            for i, x in enumerate(batch):
                if ((device_fields is None or i in device_fields)
                        and isinstance(x, np.ndarray) and x.dtype != object):
                    x = torch.from_numpy(x).pin_memory().to(
                        device, non_blocking=True)
                out.append(x)
        event = torch.cuda.Event()
        event.record(copy_stream)
        return tuple(out), event

    queue: collections.deque = collections.deque()
    it = iter(iterator)
    for batch in it:
        queue.append(put(batch))
        if len(queue) == depth:
            break
    while queue:
        batch, event = queue.popleft()
        for nxt in it:
            queue.append(put(nxt))
            break
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(event)
        for x in batch:
            if isinstance(x, torch.Tensor):
                x.record_stream(consumer)
        yield batch
