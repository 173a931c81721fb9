"""Checkpointable batch loader on worker processes (counterpart of
`cvpr23_lfdm_tpu/data/grain_loader.py`, which runs on Grain; the card's
machine has no `grain`, so this one runs on PyTorch's own
`torch.utils.data.DataLoader` worker processes).

Like the JAX loader:

* **Deterministic visits.** The stream is a sequence of visits `(index,
  epoch)`: epoch `e` visits every index once, in a permutation seeded by
  `(seed, e)`, and the epochs follow each other without a break (a batch
  may straddle two). A worker loads a visit as `dataset.sample(index,
  epoch)`, whose random stream is keyed by the visit
  (`datasets.visit_rng`), so a batch is a pure function of `(dataset,
  seed, batch number)`: the same across runs, worker counts and restarts.
* **Checkpointable iteration.** `iter(loader)` is one persistent iterator;
  `get_state()` serialises the count of batches consumed (with the seed and
  the dataset's length, checked on restore) to `bytes`, and `set_state`
  seeks to it, so a resumed run continues mid-epoch on the exact next
  batch.

The visit order is not Grain's (Grain shuffles with its own native index
permutation, which only Grain reproduces): a checkpoint's loader state
from the JAX package does not resume here, and the two packages see their
batches in different orders. With `shard_count` S, shard k yields the k-th
contiguous `batch_size / S` slice of every global batch, as `PrefetchLoader`
does.
"""

from __future__ import annotations

import json

import numpy as np
import torch.utils.data as tud

from cvpr23_lfdm_torch.data.loader import collate


def epoch_order(seed: int, epoch: int, n: int, shuffle: bool = True) -> np.ndarray:
    """The indices epoch `epoch` visits, in order (`PrefetchLoader`'s
    per-epoch permutation)."""
    if not shuffle:
        return np.arange(n)
    return np.random.default_rng(np.random.SeedSequence(entropy=seed, spawn_key=(epoch,))).permutation(n)


class _Visits(tud.Sampler):
    """This shard's visits `(index, epoch)` from global batch `start` on,
    without end."""

    def __init__(self, n: int, batch: int, local: int, shard: int, seed: int, shuffle: bool, start: int):
        self.n, self.batch, self.local, self.shard = n, batch, local, shard
        self.seed, self.shuffle, self.start = seed, shuffle, start

    def __iter__(self):
        epoch, order = -1, None
        b = self.start
        while True:
            first = b * self.batch + self.shard * self.local
            for pos in range(first, first + self.local):
                e, i = divmod(pos, self.n)
                if e != epoch:
                    epoch, order = e, epoch_order(self.seed, e, self.n, self.shuffle)
                yield int(order[i]), e
            b += 1


class _Load(tud.Dataset):
    """A visit -> the dataset's item (`sample(index, epoch)`, else
    `dataset[index]`); runs in the worker processes."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __getitem__(self, visit):
        index, epoch = visit
        sample = getattr(self.dataset, "sample", None)
        return self.dataset[index] if sample is None else sample(index, epoch)


def _counted(batches, consumed: list):
    """The batches, counting each one handed out in `consumed[0]` (no
    reference back to the loader, so dropping the loader frees it)."""
    for batch in batches:
        consumed[0] += 1
        yield batch


class GrainLoader:
    """Infinite shuffled batch iterator over a map-style dataset, its items
    loaded in `num_workers` worker processes (0: in this process).

    Interface-compatible with :class:`PrefetchLoader`: yields dicts of
    stacked numpy arrays (non-array fields as lists). `batch_size` is the
    global batch; this loader yields shard `shard_index`'s `batch_size /
    shard_count` of it. `prefetch` batches are loaded ahead per worker. The
    stream never ends, so `drop_last` (kept for the JAX interface) never
    drops anything. The dataset must be picklable when `num_workers > 0`.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, num_workers: int = 4,
                 prefetch: int = 4, seed: int = 0, drop_last: bool = True, shard_index: int = 0,
                 shard_count: int = 1):
        if len(dataset) == 0:
            raise ValueError("empty dataset (wrong split or data root?)")
        if batch_size % shard_count != 0:
            raise ValueError(f"batch {batch_size} not divisible by {shard_count} shards")
        self.dataset, self.batch_size, self.shuffle = dataset, batch_size, shuffle
        self.num_workers, self.prefetch, self.seed = num_workers, max(1, prefetch), seed
        self.drop_last, self.shard_index, self.shard_count = drop_last, shard_index, shard_count
        self._consumed = [0]  # batches consumed, shared with the iterator
        self._it = None
        self._loader_it = None

    def _start(self):
        local = self.batch_size // self.shard_count
        visits = _Visits(len(self.dataset), self.batch_size, local, self.shard_index, self.seed,
                         self.shuffle, self._consumed[0])
        extra = {"prefetch_factor": self.prefetch} if self.num_workers > 0 else {}
        loader = tud.DataLoader(_Load(self.dataset), batch_size=local, sampler=visits,
                                num_workers=self.num_workers, collate_fn=collate, **extra)
        self._loader_it = iter(loader)
        return _counted(self._loader_it, self._consumed)

    def __iter__(self):
        """Persistent iterator: repeated `iter()` continues the same stream,
        so `get_state()` always reflects the consumed position."""
        if self._it is None:
            self._it = self._start()
        return self._it

    def close(self) -> None:
        """Stop the worker processes (a later `iter()` starts new ones at
        the consumed position)."""
        it, self._it, self._loader_it = getattr(self, "_loader_it", None), None, None
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()

    def __del__(self):
        # shut the workers down while the iterator's queues are alive (left
        # to the iterator's own finaliser, each worker waits out a 5 s join)
        self.close()

    # ------------------------------------------------------- checkpointing

    def get_state(self) -> bytes:
        """The iterator's position: batches consumed, with the seed, the
        dataset's length and the batch layout it counts in."""
        return json.dumps({"batches": self._consumed[0], "seed": self.seed, "length": len(self.dataset),
                           "batch_size": self.batch_size, "shard": [self.shard_index, self.shard_count]},
                          sort_keys=True).encode()

    def set_state(self, state: bytes) -> None:
        """Seek to a position `get_state` returned: the next batch is the one
        that followed it. Raises if the state belongs to another stream."""
        saved = json.loads(bytes(state).decode())
        own = json.loads(self.get_state().decode())
        for key in ("seed", "length", "batch_size", "shard"):
            if saved[key] != own[key]:
                raise ValueError(f"loader state of another stream: {key} {saved[key]} != {own[key]}")
        self.close()
        self._consumed[0] = int(saved["batches"])
