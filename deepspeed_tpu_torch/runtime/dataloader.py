"""Data loading, a port of ``deepspeed_tpu/runtime/dataloader.py``:
``DataLoader`` (a checkpointable position, a lazy fast-forward on
resume), ``RepeatingLoader``, ``PrefetchLoader`` and
``random_token_batches``.

One process feeds the global batch (one card). Batches are host numpy
dicts, as in JAX; the engine moves them to the device. The order within
an epoch is a pure function of (seed, epoch), numpy's
``default_rng(seed + epoch)`` shuffle, so the two packages yield the same
batches for the same dataset, seed and epochs.
"""

import collections
from typing import Any, Callable, Iterator

import numpy as np


class DataLoader:
    """Batching loader over an indexable dataset of rows (dicts, tuples or
    arrays)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = True, collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.epoch = 0
        self._pos = 0          # batches yielded this epoch (ckpt position)
        self._resume_pos = 0   # batches to skip on the next __iter__

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self._pos = 0

    # the checkpointable position: a resume must neither replay nor skip
    # data, and (epoch, pos, seed) names the position fully
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "pos": self._pos, "seed": self.seed}

    def load_state_dict(self, sd: dict) -> None:
        self.seed = int(sd.get("seed", self.seed))
        self.set_epoch(int(sd.get("epoch", 0)))
        # the fast-forward happens lazily at the next __iter__: the order
        # is regenerated from (seed, epoch) and `pos` batches are skipped,
        # so the next batch is the first one the saved run had not consumed
        self._resume_pos = int(sd.get("pos", 0))
        self._pos = self._resume_pos

    def __iter__(self) -> Iterator:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        skip, self._resume_pos = self._resume_pos, 0
        self._pos = skip
        starts = range(0, n - (self.batch_size - 1 if self.drop_last else 0),
                       self.batch_size)
        for bi, start in enumerate(starts):
            if bi < skip:
                continue
            idx = order[start:start + self.batch_size]
            rows = [self.dataset[int(i)] for i in idx]
            self._pos = bi + 1
            yield self.collate_fn(rows)


class PrefetchLoader:
    """Keeps ``depth`` batches placed ahead of the consumer.

    ``put_fn`` places one host batch; the engine's places it on the card
    from pinned host memory on a side stream, so the copy of batch N+1
    overlaps step N. The batch ORDER is the wrapped loader's, across epoch
    boundaries too (``set_epoch`` / ``epoch`` proxy through)."""

    def __init__(self, loader, put_fn: Callable[[Any], Any], depth: int = 2):
        if put_fn is None:
            raise ValueError("PrefetchLoader needs a placement function "
                             "(the engine's)")
        self.loader = loader
        self.put_fn = put_fn
        self.depth = max(1, int(depth))

    def __len__(self):
        return len(self.loader)

    @property
    def epoch(self):
        return getattr(self.loader, "epoch", 0)

    def set_epoch(self, epoch: int):
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)

    def __iter__(self) -> Iterator:
        it = iter(self.loader)
        buf = collections.deque()
        try:
            while len(buf) < self.depth:
                buf.append(self.put_fn(next(it)))
        except StopIteration:
            pass
        while buf:
            out = buf.popleft()
            # top up BEFORE yielding: the put of batch N+depth is issued
            # while the consumer still holds (and then steps on) batch N
            try:
                buf.append(self.put_fn(next(it)))
            except StopIteration:
                pass
            yield out


class RepeatingLoader:
    """Infinite cycling wrapper: a new epoch (``set_epoch``) at each
    rollover. It is its own iterator, so a loop that takes a few batches
    at a time continues where the last one stopped."""

    def __init__(self, loader):
        self.loader = loader
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(getattr(self.loader, "epoch", 0) + 1)
            self._it = iter(self.loader)
            return next(self._it)

    # position checkpointing proxies (attach_dataloader takes either the
    # bare DataLoader or this wrapper)
    def state_dict(self) -> dict:
        return self.loader.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.loader.load_state_dict(sd)
        # drop the live iterator: it was positioned for the OLD state, and
        # DataLoader's lazy fast-forward applies at the next iter()
        self._it = iter(self.loader)


def _default_collate(rows):
    if isinstance(rows[0], dict):
        return {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    if isinstance(rows[0], (tuple, list)):
        return tuple(np.stack([r[i] for r in rows])
                     for i in range(len(rows[0])))
    return np.stack(rows)


def random_token_batches(batch_size: int, seq_len: int, vocab_size: int,
                         num_batches: int, seed: int = 0):
    """Synthetic LM data: ``num_batches`` dicts of int32 ``input_ids``
    [batch_size, seq_len], the JAX package's stream for the same seed."""
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        ids = rng.integers(0, vocab_size, size=(batch_size, seq_len),
                           dtype=np.int32)
        yield {"input_ids": ids}
