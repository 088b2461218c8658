"""Deterministic prefetching data loader (host → card).

Counterpart of ``exaspim_tpu/data/loader.py``: a producer thread builds
batches into a bounded queue, with the same ``SeedSequence([seed, epoch])``
shuffle (identical order for identical seeds), exceptions forwarded to the
consumer, ``set_epoch``, and the count-space collates that only stack
uint16 patches (the transform runs on the device inside the step).
:func:`prefetch_to_device` keeps batches in flight to the card.

Worker processes (the reference's ``num_workers > 0``) are later work;
this loader is single-process.

torch has no uint16 arithmetic: :func:`to_tensor` ships uint16 arrays as
their int16 bit patterns and :func:`counts_f32` widens them on the device.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

__all__ = [
    "DataLoader",
    "make_count_train_collate",
    "make_count_val_collate",
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


class DataLoader:
    """Prefetching batch loader over a map-style dataset.

    ``shuffle`` + ``seed`` give the deterministic epoch permutation,
    ``prefetch`` bounds the producer queue, ``drop_last=False`` keeps the
    final partial batch.
    """

    _STOP = object()

    def __init__(self, dataset, batch_size, collate, shuffle=False,
                 seed=0, prefetch=2, drop_last=False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.collate = collate
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = int(prefetch)
        self.drop_last = drop_last
        self.epoch = 0

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

    def __iter__(self):
        order = self._order()
        q = queue.Queue(maxsize=max(1, self.prefetch))

        def producer():
            try:
                for lo in range(0, len(order), self.batch_size):
                    idx = order[lo:lo + self.batch_size]
                    if self.drop_last and len(idx) < self.batch_size:
                        break
                    items = [self.dataset[int(i)] for i in idx]
                    q.put(self.collate(items))
                q.put(self._STOP)
            except BaseException as exc:  # forwarded, not swallowed
                q.put(exc)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
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
        return tuple(to_tensor(a, device) if isinstance(a, np.ndarray) else a
                     for a in batch)

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
