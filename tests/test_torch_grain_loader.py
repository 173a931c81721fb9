"""The port's `GrainLoader` (torch worker processes; `grain` is not on the
card) held to the properties the JAX tests ask of the Grain loader
(`tests/test_resume.py`, `tests/test_data.py::test_grain_loader`), with 0
(in process) and 2 worker processes:

* the same stream run to run at a fixed worker count, and across worker
  counts;
* `get_state` / `set_state` resume the exact next batches mid-epoch, also
  after the iterator is closed and in a new loader; a state of another
  stream is refused;
* each epoch visits a permutation of all indices, and the stream runs on
  across epoch boundaries;
* each item equals `dataset.sample(index, epoch)` of its visit (the
  datasets' `sample` is held against the JAX package in
  `tests/test_torch_data.py`), on a real `DMVideoDataset`;
* with `shard_count` 2, each shard's batch is its half of the global batch.

The visit order is not Grain's (module docstring), so no batch is compared
with the JAX loader's.
"""

import numpy as np
import pytest
import torch

from cvpr23_lfdm_torch.data import DMVideoDataset, get_spec
from cvpr23_lfdm_torch.data.grain_loader import GrainLoader, epoch_order
from cvpr23_lfdm_torch.data.synthetic import make_synthetic_corpus


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Visits:
    """A dataset whose item is its visit: `sample(index, epoch)` -> the
    index, the epoch and a value drawn from the visit's own stream."""

    def __init__(self, n: int = 10):
        self.n = n

    def __len__(self):
        return self.n

    def sample(self, index: int, epoch: int) -> dict:
        rng = np.random.default_rng([index, epoch, 7])
        return {"index": np.int64(index), "epoch": np.int64(epoch), "x": rng.random(3),
                "tag": f"{index}/{epoch}"}


def take(loader, n: int) -> list:
    it = iter(loader)
    return [next(it) for _ in range(n)]


def assert_same(a: list, b: list):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for k in ("index", "epoch", "x"):
            np.testing.assert_array_equal(x[k], y[k])
        assert x["tag"] == y["tag"]


@pytest.mark.parametrize("workers", [0, 2])
def test_stream_is_the_same_run_to_run(workers):
    mk = lambda w: GrainLoader(Visits(), batch_size=4, num_workers=w, seed=3)  # noqa: E731
    a, b = take(mk(workers), 6), take(mk(workers), 6)
    assert_same(a, b)
    assert_same(a, take(mk(0 if workers else 2), 6))  # and across worker counts


@pytest.mark.parametrize("workers", [0, 2])
def test_state_resumes_mid_epoch(workers):
    mk = lambda: GrainLoader(Visits(), batch_size=4, num_workers=workers, seed=8)  # noqa: E731
    ref = mk()
    take(ref, 3)  # 12 visits: past the first epoch of 10, mid the second
    saved = ref.get_state()
    expect = take(ref, 4)
    fresh = mk()
    fresh.set_state(saved)
    assert_same(take(fresh, 4), expect)
    assert fresh.get_state() == ref.get_state()
    ref.close()  # a closed loader goes on from where it was
    again = take(ref, 2)
    fresh2 = mk()
    fresh2.set_state(saved)
    assert_same(take(fresh2, 6)[4:], again)
    with pytest.raises(ValueError, match="another stream"):
        GrainLoader(Visits(), batch_size=4, num_workers=workers, seed=9).set_state(saved)
    for loader in (ref, fresh, fresh2):
        loader.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_each_epoch_is_a_permutation(workers):
    n, batch = 10, 4
    loader = GrainLoader(Visits(n), batch_size=batch, num_workers=workers, seed=5)
    got = take(loader, 3 * n // batch + 1)  # 32 visits: three epochs and a bit
    loader.close()
    index = np.concatenate([b["index"] for b in got])
    epoch = np.concatenate([b["epoch"] for b in got])
    np.testing.assert_array_equal(epoch[:30], np.repeat([0, 1, 2], n))
    for e in range(3):
        assert sorted(index[epoch == e]) == list(range(n))
        np.testing.assert_array_equal(index[epoch == e], epoch_order(5, e, n))
    assert len({tuple(index[epoch == e]) for e in range(3)}) == 3  # reshuffled per epoch
    for b in got:
        for i, e, x in zip(b["index"], b["epoch"], b["x"]):
            np.testing.assert_array_equal(x, Visits(n).sample(int(i), int(e))["x"])
    unshuffled = GrainLoader(Visits(n), batch_size=batch, num_workers=0, shuffle=False)
    np.testing.assert_array_equal(np.concatenate([b["index"] for b in take(unshuffled, 5)]),
                                  np.arange(20) % n)


@pytest.mark.parametrize("workers", [0, 2])
def test_shards_are_halves_of_the_global_batch(workers):
    whole = take(GrainLoader(Visits(12), batch_size=4, num_workers=workers, seed=2), 5)
    halves = [take(GrainLoader(Visits(12), batch_size=4, num_workers=workers, seed=2, shard_index=k,
                               shard_count=2), 5) for k in (0, 1)]
    for j, batch in enumerate(whole):
        for k in (0, 1):
            part = halves[k][j]
            assert len(part["tag"]) == 2
            assert part["tag"] == batch["tag"][2 * k: 2 * k + 2]
            np.testing.assert_array_equal(part["x"], batch["x"][2 * k: 2 * k + 2])
    with pytest.raises(ValueError, match="not divisible"):
        GrainLoader(Visits(12), batch_size=5, shard_count=2)


@pytest.mark.parametrize("workers", [0, 2])
def test_items_are_the_datasets_visits(tmp_path, workers):
    root = str(tmp_path / "corpus")
    make_synthetic_corpus(root, "mug", num_frames=8, size=32, seed=1, takes=2)
    ds = DMVideoDataset(get_spec("mug"), root, "train", num_frames=4, image_size=32,
                        sampling="very_random", seed=3)
    loader = GrainLoader(ds, batch_size=3, num_workers=workers, seed=4)
    got = take(loader, 4)
    loader.close()
    pos = 0
    for batch in got:
        assert batch["video"].shape == (3, 4, 32, 32, 3)
        for k in range(3):
            epoch, i = divmod(pos, len(ds))
            want = ds.sample(int(epoch_order(4, epoch, len(ds))[i]), epoch)
            np.testing.assert_array_equal(batch["video"][k], want["video"])
            assert batch["name"][k] == want["name"]
            pos += 1
