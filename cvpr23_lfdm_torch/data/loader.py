"""Threaded prefetching batch loader (a copy of
`cvpr23_lfdm_tpu/data/loader.py`, which imports no JAX; the port keeps its
own copy).

Decode and augmentation happen in a thread pool (cv2/numpy release the GIL
for the heavy parts) while the device runs the previous step; batches are
collated to stacked numpy arrays, ready for `torch.from_numpy(...).to(device)`.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def collate(samples: list[dict]) -> dict:
    """Stack array fields; gather non-arrays into lists."""
    out = {}
    for k in samples[0]:
        v0 = samples[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([s[k] for s in samples])
        else:
            out[k] = [s[k] for s in samples]
    return out


class PrefetchLoader:
    """Infinite shuffled batch iterator with background prefetch.

    Deterministic and seekable: epoch `e`'s permutation is derived from
    `(seed, e)` alone, and each sample visit is dispatched as
    `dataset.sample(i, epoch)` (falling back to `dataset[i]`), whose
    stream is keyed by visit identity (`datasets.visit_rng`). Together the
    batch stream is a pure function of `(dataset, seed, batch_number)` —
    so crash-resume (`start_batch=N`, the reference `--set-start`
    protocol, DM/train_video_flow_diffusion_mug.py:173-181) replays
    EXACTLY the batches a straight-through run would have seen, which
    torch DataLoader workers cannot do.

    Batches are mapped in `num_workers` threads (cv2/numpy release the
    GIL), collated, and buffered in a bounded queue of `prefetch`.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 6,
        prefetch: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        start_batch: int = 0,
        shard_index: int = 0,
        shard_count: int = 1,
    ):
        """`batch_size` is the GLOBAL batch; with `shard_count` processes
        (multi-host DCN, `parallel.distributed.host_shard`) each loader
        yields its contiguous `batch_size / shard_count` slice of every
        global batch — the index stream (and therefore resume seeking) is
        identical on every host."""
        if len(dataset) == 0:
            raise ValueError("empty dataset (wrong split or data root?)")
        if batch_size % shard_count != 0:
            raise ValueError(
                f"batch {batch_size} not divisible by {shard_count} shards"
            )
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.drop_last = drop_last
        self.start_batch = start_batch
        self.shard_index = shard_index
        self.shard_count = shard_count

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(epoch,))
        )
        return rng.permutation(n)

    def _batches_per_epoch(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_stream(self):
        """Yields (epoch, index-array) per batch, seeking past
        `start_batch` in O(1) (epoch permutations are independent)."""
        bpe = self._batches_per_epoch()
        epoch, offset = divmod(self.start_batch, bpe)
        local = self.batch_size // self.shard_count
        lo = self.shard_index * local
        while True:
            order = self._epoch_order(epoch)
            for b in range(offset, bpe):
                s = b * self.batch_size
                yield epoch, order[s + lo : s + lo + local]
            offset = 0
            epoch += 1

    def _fetch(self, epoch: int, i: int):
        sample = getattr(self.dataset, "sample", None)
        if sample is None:
            return self.dataset[i]
        return sample(i, epoch)

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        batch_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that re-checks `stop` so an abandoned iterator
            (consumer gone, queue full) can't wedge the producer thread —
            and its worker pool — forever."""
            while not stop.is_set():
                try:
                    batch_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for epoch, idx in self._index_stream():
                        if stop.is_set():
                            return
                        samples = list(
                            pool.map(lambda i: self._fetch(epoch, int(i)), idx)
                        )
                        if not put_or_stop(collate(samples)):
                            return
            except BaseException as e:  # surface worker failures, don't hang
                put_or_stop(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch = batch_q.get()
                if isinstance(batch, BaseException):
                    raise RuntimeError("data loader worker failed") from batch
                yield batch
        finally:
            stop.set()

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.batch_size
