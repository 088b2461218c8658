"""Deterministic prefetching data loader (host → card).

Counterpart of ``exaspim_tpu/data/loader.py``: a producer thread builds
batches into a bounded queue, with the same ``SeedSequence([seed, epoch])``
shuffle (identical order for identical seeds), exceptions forwarded to the
consumer, ``set_epoch``, the count-space collates that only stack uint16
patches (the transform runs on the device inside the step) and the
host-transform collates that apply the frozen transform on the host.
:func:`prefetch_to_device` keeps batches in flight to the card.

``num_workers > 0`` fetches and collates batches in a pool of worker
processes, each holding one copy of the dataset; batches come back in
submission order, so the stream does not depend on worker timing. The
workers are forked: a memory-mapped cache is inherited, never pickled.
Each worker writes its batch's arrays into one of a set of slots of
shared memory mapped before the fork, and sends back only their layout;
the parent copies the arrays out and hands the slot to the next batch.
The slots are sized by the first batch, which the parent collates itself
(a later batch that does not fit comes back pickled). A forked child can
use neither CUDA nor the OpenMP thread pool that torch has started in
the parent: its first parallel CPU op waits forever on threads that did
not survive the fork. Workers run torch ops on one thread (the host
collates' transform), inline. A dataset whose items run torch ops
(``items_run_torch``: a BM4D teacher, on the card or the CPU) is refused
with ``ValueError``; fetch it with ``num_workers=0``. Items of numpy only
(the patch caches) are what workers serve.

torch has no uint16 arithmetic: :func:`to_tensor` ships uint16 arrays as
their int16 bit patterns and :func:`counts_f32` widens them on the device.
"""

from __future__ import annotations

import collections
import mmap
import queue
import threading

import numpy as np
import torch

from exaspim_tpu_torch.utils.profiling import span

__all__ = [
    "DataLoader",
    "make_count_train_collate",
    "make_count_val_collate",
    "make_train_collate",
    "make_val_collate",
    "prefetch_to_device",
    "to_tensor",
    "counts_f32",
]


def to_tensor(a, device="cuda"):
    """numpy → torch on ``device``; uint16 travels as its int16 bits."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a read-only memmap view
        a = a.copy()
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    t = torch.from_numpy(a)
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def counts_f32(t):
    """Counts tensor → f32; int16 holds uint16 bit patterns."""
    if t.dtype == torch.int16:
        return (t.to(torch.int32) & 0xFFFF).to(torch.float32)
    return t.to(torch.float32)


def _to_net(x):
    """(B, z, y, x) float → (B, z, y, x, 1) float32 channels-last."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    return np.asarray(x, dtype=np.float32)[..., None]


def make_train_collate(transform, preserve_foreground=False):
    """Collate (raw, teacher, fg) count-space items → (x, y, fg) batches
    in the network domain, on the host: ``x = transform(raw)``,
    ``y = transform(teacher)``, or ``transform(where(fg, raw, teacher))``
    when ``preserve_foreground``. numpy in, numpy out."""

    def collate(items):
        raw = np.stack([it[0] for it in items])
        teacher = np.stack([it[1] for it in items])
        fg = np.stack([it[2] for it in items]).astype(bool)
        target = np.where(fg, raw, teacher) if preserve_foreground else teacher
        x = transform.forward(raw.astype(np.float32))
        y = transform.forward(target.astype(np.float32))
        return _to_net(x), _to_net(y), fg[..., None]

    return collate


def make_val_collate(transform):
    """Collate (raw, teacher, raw, fg) items → (x, y, raw_counts, fg),
    x and y in the network domain."""

    def collate(items):
        raw = np.stack([it[0] for it in items])
        teacher = np.stack([it[1] for it in items])
        counts = np.stack([it[2] for it in items])
        fg = np.stack([it[3] for it in items]).astype(bool)
        x = transform.forward(raw.astype(np.float32))
        y = transform.forward(teacher.astype(np.float32))
        return _to_net(x), _to_net(y), counts, fg[..., None]

    return collate


def make_count_train_collate(preserve_foreground=False):
    """Count-space collate: ``(raw_u16, target_u16, fg)`` batches shaped
    (B, D, H, W, 1), stacking only; ``target = where(fg, raw, teacher)``
    when ``preserve_foreground``."""

    def collate(items):
        raw = np.stack([it[0] for it in items])
        teacher = np.stack([it[1] for it in items])
        fg = np.stack([it[2] for it in items]).astype(bool)
        target = np.where(fg, raw, teacher) if preserve_foreground else teacher
        return raw[..., None], target[..., None], fg[..., None]

    return collate


def make_count_val_collate():
    """Count-space validation collate → (raw, teacher, raw_counts, fg)."""

    def collate(items):
        raw = np.stack([it[0] for it in items])
        teacher = np.stack([it[1] for it in items])
        counts = np.stack([it[2] for it in items])
        fg = np.stack([it[3] for it in items]).astype(bool)
        return raw[..., None], teacher[..., None], counts, fg[..., None]

    return collate


_ALIGN = 64  # bytes; each array of a batch starts on a cache line
_WORKER = None  # (dataset, collate, slots, slot_bytes) in a worker


def _shared(a):
    """Whether ``a`` travels through a slot (an array of plain values)."""
    return isinstance(a, np.ndarray) and not a.dtype.hasobject


def _packed_nbytes(batch):
    """Slot bytes a tuple batch's arrays take (0 for any other batch)."""
    if not isinstance(batch, tuple):
        return 0
    return sum(-(-a.nbytes // _ALIGN) * _ALIGN for a in batch if _shared(a))


def _pack(batch, buf, base, size):
    """Write a batch's arrays into ``buf[base:base + size]``; returns
    ``("slot", layout)``, or ``("batch", batch)`` where the batch is no
    tuple or does not fit."""
    if not isinstance(batch, tuple) or _packed_nbytes(batch) > size:
        return "batch", batch
    layout, off = [], 0
    for a in batch:
        if not _shared(a):
            layout.append(("object", a))
            continue
        np.ndarray(a.shape, a.dtype, buffer=buf, offset=base + off)[...] = a
        layout.append(("array", off, a.shape, a.dtype.str))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    return "slot", layout


def _unpack(packed, buf, base):
    """The batch of :func:`_pack`, its arrays copied out of the slot."""
    kind, body = packed
    if kind == "batch":
        return body
    return tuple(
        np.ndarray(e[2], np.dtype(e[3]), buffer=buf, offset=base + e[1]).copy()
        if e[0] == "array" else e[1] for e in body)


def _worker_init(dataset, collate, slots, slot_bytes):
    """Hold the dataset, the collate and the shared slots in a worker
    process (inherited through fork, never pickled). One intra-op thread:
    a collate's torch ops (the host transform) then run inline, never in
    the parent's OpenMP pool, whose threads did not survive the fork."""
    global _WORKER
    torch.set_num_threads(1)
    _WORKER = (dataset, collate, slots, slot_bytes)


def _worker_fetch(indices, slot):
    """Fetch and collate one batch; its arrays go into shared ``slot``."""
    dataset, collate, slots, slot_bytes = _WORKER
    batch = collate([dataset[int(i)] for i in indices])
    return _pack(batch, slots, slot * slot_bytes, slot_bytes)


class DataLoader:
    """Prefetching batch loader over a map-style dataset.

    ``shuffle`` + ``seed`` give the deterministic epoch permutation,
    ``prefetch`` bounds the producer queue, ``drop_last=False`` keeps the
    final partial batch. ``num_workers=0`` (the default) fetches items in
    one producer thread; ``num_workers > 0`` fetches and collates batches
    in that many forked worker processes (see the module docstring), with
    ``prefetch + num_workers`` batches in flight, one shared slot each.
    """

    _STOP = object()

    def __init__(self, dataset, batch_size, collate, shuffle=False,
                 seed=0, prefetch=2, drop_last=False, num_workers=0):
        if int(num_workers) > 0 and getattr(dataset, "items_run_torch",
                                            False):
            raise ValueError(
                "num_workers > 0 needs a dataset whose items are numpy "
                "only: this one runs torch ops (a BM4D teacher), and a "
                "forked worker can use neither CUDA nor the parent's "
                "OpenMP threads; pass num_workers=0")
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = int(prefetch)
        self.drop_last = drop_last
        self.num_workers = int(num_workers)
        self.epoch = 0
        self._pool = None
        self._slots = None  # shared memory, one slot per batch in flight
        self._slot_bytes = 0

    def _executor(self, batch):
        """Map the shared slots, sized by ``batch``, then fork the
        workers, which inherit them."""
        import concurrent.futures as futures
        import multiprocessing

        self._slot_bytes = max(_ALIGN, _packed_nbytes(batch))
        self._slots = mmap.mmap(-1, self._slot_bytes * self._in_flight())
        self._pool = futures.ProcessPoolExecutor(
            max_workers=self.num_workers,
            mp_context=multiprocessing.get_context("fork"),
            initializer=_worker_init,
            initargs=(self.dataset, self.collate, self._slots,
                      self._slot_bytes),
        )
        return self._pool

    def _in_flight(self):
        return max(1, self.prefetch) + self.num_workers

    def close(self):
        """Shut down the worker processes (nothing to do in thread mode)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self._slots = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def set_epoch(self, epoch):
        """Select the epoch whose deterministic shuffle to use."""
        self.epoch = int(epoch)

    def _order(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, self.epoch])
            )
            return rng.permutation(n)
        return np.arange(n)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batches(self, order):
        for lo in range(0, len(order), self.batch_size):
            idx = order[lo:lo + self.batch_size]
            if self.drop_last and len(idx) < self.batch_size:
                return
            yield idx

    def _iter_pool(self, order):
        import concurrent.futures as futures

        batches = self._batches(order)
        first = None
        pool = self._pool
        if pool is None:  # the first batch, collated here, sizes the slots
            idx = next(batches, None)
            if idx is None:
                return
            first = self.collate([self.dataset[int(i)] for i in idx])
            pool = self._executor(first)
        free = list(range(self._in_flight()))
        pending = collections.deque()

        def submit():
            idx = next(batches, None)
            if idx is not None:
                slot = free.pop()
                pending.append((pool.submit(_worker_fetch, list(idx), slot),
                                slot))
            return idx is not None

        try:
            while free and submit():
                pass
            if first is not None:
                yield first
            while pending:
                fut, slot = pending.popleft()
                with span("loader.wait"):
                    packed = fut.result()
                batch = _unpack(packed, self._slots, slot * self._slot_bytes)
                free.append(slot)
                submit()
                yield batch
        finally:
            # A slot is free again only once no worker writes into it.
            for fut, _ in pending:
                fut.cancel()
            futures.wait([fut for fut, _ in pending])

    def __iter__(self):
        order = self._order()
        if self.num_workers > 0:
            yield from self._iter_pool(order)
            return
        q = queue.Queue(maxsize=max(1, self.prefetch))

        def producer():
            try:
                for idx in self._batches(order):
                    items = [self.dataset[int(i)] for i in idx]
                    q.put(self.collate(items))
                q.put(self._STOP)
            except BaseException as exc:  # forwarded, not swallowed
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            with span("loader.wait"):
                item = q.get()
            if item is self._STOP:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def prefetch_to_device(iterator, size=2, device="cuda"):
    """Keep ``size`` batches in flight to ``device``: each numpy array of
    a batch goes through :func:`to_tensor` (pinned, non-blocking on the
    card), so the next copy overlaps the current step."""
    buf = collections.deque()

    def put(batch):
        with span("loader.upload"):
            return tuple(to_tensor(a, device) if isinstance(a, np.ndarray)
                         else a for a in batch)

    it = iter(iterator)
    for batch in it:
        buf.append(put(batch))
        if len(buf) >= size:
            break
    while buf:
        out = buf.popleft()
        nxt = next(it, None)
        if nxt is not None:
            buf.append(put(nxt))
        yield out
