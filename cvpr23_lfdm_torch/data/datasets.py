"""Datasets: LFAE frame pairs and DM video clips over frame-folder corpora
(a copy of `cvpr23_lfdm_tpu/data/datasets.py` over the port's data modules).

Two parameterized classes replace the reference's per-dataset zoo
(LFAE/{mug,mhad,natops}_dataset.py and the MUG/MHAD/NATOPS + _test/_gen/
_select variants in DM/datasets_*.py). Mode selection:

  DMVideoDataset(spec, root, split="train")  == MUG(...)
  DMVideoDataset(..., split="test")          == MUG_test(...)
  DMVideoDataset(..., combos=True)           == MUG_gen / MUG_gen_train
  .find(subject, class_name)                 == MUG_select

All outputs are channel-last float32 in [0, 1] ([F, H, W, 3] videos,
[H, W, 3] frames) — the layout the models consume directly.
"""

from __future__ import annotations

import numpy as np

from cvpr23_lfdm_torch.data import native
from cvpr23_lfdm_torch.data.augment import ClipAugment, color_jitter_clip
from cvpr23_lfdm_torch.data.io import list_frames, pad_resize, read_image
from cvpr23_lfdm_torch.data.sampling import pair_indices, sample_indices
from cvpr23_lfdm_torch.data.specs import DatasetSpec, VideoEntry

# DM color jitter strengths (DM/datasets_mug.py:94-97)
DM_JITTER = dict(brightness=64.0 / 255, contrast=0.25, saturation=0.25, hue=0.04)


def visit_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Random stream for one dataset visit, derived from identity alone.

    Keyed by (dataset seed, epoch, index) — NOT by thread/process — so the
    augmentation stream is identical no matter which loader, worker count,
    or restart produced the visit. This is what makes crash-resume replay
    the exact batch stream (the reference cannot: torch workers reseed per
    run) and makes Grain-worker streams run-to-run reproducible. A fresh
    Generator per sample costs ~1 us, noise against image decode.
    """
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(epoch, index))
    )


def _split_entries(spec: DatasetSpec, root: str, split: str) -> list[VideoEntry]:
    subjects = {
        "train": spec.train_subjects,
        "test": spec.test_subjects,
        "all": tuple(spec.train_subjects) + tuple(spec.test_subjects),
    }[split]
    return spec.list_videos(root, subjects)


def _read_clip(paths: list[str], idx: np.ndarray, crop) -> np.ndarray:
    frames = [read_image(paths[i]) for i in idx]
    if crop is not None:
        y0, y1, x0, x1 = crop
        frames = [f[y0:y1, x0:x1] for f in frames]
    return np.stack(frames).astype(np.float32) / 255.0


class DMVideoDataset:
    """Video clips for diffusion training/eval (DM/datasets_*.py).

    `__getitem__` -> {video [F,H,W,3], text, name}. With `combos=True`,
    indexes (subject x class) pairs and yields the first take of each combo
    (the *_gen evaluation protocol, datasets_mug.py:203-323).

    `mean` is the reference's per-channel pixel-mean knob (0-255 scale,
    subtracted after resize and before /255, datasets_mug.py:109-113).
    Every shipped reference script passes MEAN=(0,0,0) (e.g.
    DM/train_video_flow_diffusion_mug.py:50,193), so the default here is
    zeros and videos land in [0,1]; the (128,128,128) seen in the MUG
    class signatures (datasets_mug.py:16,119) is a dead default that no
    reference entry point uses — kept available for checkpoint
    reproduction experiments."""

    def __init__(
        self,
        spec: DatasetSpec,
        root: str,
        split: str = "train",
        num_frames: int = 40,
        image_size: int = 128,
        color_jitter: bool = True,
        sampling: str = "random",
        combos: bool = False,
        mean: tuple[float, float, float] = (0.0, 0.0, 0.0),
        seed: int = 0,
    ):
        self.spec = spec
        self.num_frames = num_frames
        self.image_size = image_size
        self.color_jitter = color_jitter
        self.sampling = sampling
        self.mean = np.asarray(mean, np.float32)
        self.seed = seed
        entries = _split_entries(spec, root, split)
        if combos:
            first = {}
            for e in entries:
                first.setdefault((e.subject, e.class_name), e)
            entries = [first[k] for k in sorted(first)]
        self.entries = entries

    def __len__(self) -> int:
        return len(self.entries)

    def find(self, subject: str, class_name: str) -> int:
        """*_select protocol (datasets_mug.py:450+): index by combo."""
        for i, e in enumerate(self.entries):
            if e.subject == str(subject) and e.class_name == class_name:
                return i
        raise KeyError((subject, class_name))

    def __getitem__(self, index: int) -> dict:
        return self.sample(index, 0)

    def sample(self, index: int, epoch: int = 0) -> dict:
        """Deterministic visit: same (seed, epoch, index) -> same clip."""
        rng = visit_rng(self.seed, epoch, index)
        e = self.entries[index]
        paths = list_frames(e.path)
        idx = sample_indices(rng, len(paths), self.num_frames, self.sampling)
        clip = _read_clip(paths, idx, self.spec.crop)
        if self.color_jitter:
            # reference jitters at native resolution, fixed B,C,S,H order
            # (DM/datasets_mug.py:93-105), one draw per clip
            clip = color_jitter_clip(
                rng, clip, shuffle_order=False, **DM_JITTER
            )
        clip = native.pad_resize_batch_f32(clip, self.image_size)
        if self.mean.any():
            # reference order: jitter -> resize -> (x - mean) -> /255
            # (datasets_mug.py:106-113); our clip is already /255, so
            # subtract mean/255 after the resize — same output.
            clip = clip - self.mean / 255.0
        return {
            "video": clip.astype(np.float32),
            "text": e.class_name,
            "name": e.name,
            "subject": e.subject,  # cFVD/sFVD grouping key (eval/metrics.py)
        }


class LFAEPairDataset:
    """Source/driving frame pairs for stage-1 training
    (LFAE/mug_dataset.py:32-120): 2 sorted random frames, pad-resize,
    clip augmentation (flips + jitter, config/mug128.yaml:28-36).

    `id_sampling` reproduces the generic FramesDataset protocol
    (LFAE/frames_dataset.py:120-127): the dataset indexes IDENTITIES
    (subjects) and each visit draws a random take of that identity —
    instead of indexing takes directly. `pairs_list` (a CSV of
    source/driving video names) is stored for `PairedDataset` to consume —
    matching the reference, where only PairedDataset reads it
    (frames_dataset.py:89,207-222; no shipped config sets it)."""

    def __init__(
        self,
        spec: DatasetSpec,
        root: str,
        split: str = "train",
        frame_shape: int = 128,
        augment: ClipAugment | None = ClipAugment(),
        seed: int = 0,
        id_sampling: bool = False,
        pairs_list: str | None = None,
    ):
        self.spec = spec
        self.frame_shape = frame_shape
        self.augment = augment
        self.seed = seed
        self.id_sampling = id_sampling
        self.pairs_list = pairs_list  # consumed by PairedDataset (class doc)
        self.entries = _split_entries(spec, root, split)
        if id_sampling:
            by_subject: dict[str, list[VideoEntry]] = {}
            for e in self.entries:
                by_subject.setdefault(e.subject, []).append(e)
            self.identities = sorted(by_subject)
            self._takes = by_subject

    def __len__(self) -> int:
        if self.id_sampling:
            return len(self.identities)
        return len(self.entries)

    def __getitem__(self, index: int) -> dict:
        return self.sample(index, 0)

    def sample(self, index: int, epoch: int = 0) -> dict:
        rng = visit_rng(self.seed, epoch, index)
        if self.id_sampling:
            takes = self._takes[self.identities[index]]
            e = takes[int(rng.integers(0, len(takes)))]
        else:
            e = self.entries[index]
        paths = list_frames(e.path)
        idx = pair_indices(rng, len(paths))
        pair = []
        for i in idx:
            img = read_image(paths[i])
            if self.spec.crop is not None:
                y0, y1, x0, x1 = self.spec.crop
                img = img[y0:y1, x0:x1]
            pair.append(pad_resize(img, self.frame_shape))
        clip = np.stack(pair).astype(np.float32) / 255.0
        if self.augment is not None:
            clip = self.augment(rng, clip)
        return {"source": clip[0], "driving": clip[1], "name": e.name, "id": index}


class DatasetRepeater:
    """Epoch stretcher (LFAE/frames_dataset.py:178-190)."""

    def __init__(self, dataset, num_repeats: int = 100):
        self.dataset = dataset
        self.num_repeats = num_repeats

    def __len__(self) -> int:
        return self.num_repeats * len(self.dataset)

    def __getitem__(self, idx: int):
        return self.sample(idx, 0)

    def sample(self, idx: int, epoch: int = 0):
        """Each underlying video is visited `num_repeats` times per repeater
        epoch; give every visit a distinct deterministic stream."""
        n = len(self.dataset)
        inner = getattr(self.dataset, "sample", None)
        if inner is None:
            return self.dataset[idx % n]
        return inner(idx % n, epoch * self.num_repeats + idx // n)


class PairedDataset:
    """(driving, source) video pairs for cross-video animation eval
    (LFAE/frames_dataset.py:196-233).

    Wraps any indexable dataset whose items are dicts. Pairs come from
    either

    * a random cross-product: all (i, j) with i, j < min(number_of_pairs,
      len(dataset)), subsampled to `number_of_pairs` without replacement
      under `seed` (the reference seeds the global numpy RNG; here a
      private Generator), or
    * the wrapped dataset's `pairs_list` CSV with `source`/`driving`
      columns of video names — rows whose names are missing from the
      dataset are dropped, order preserved, truncated to
      `number_of_pairs`. This is where the reference's stored-but-dead
      `pairs_list` knob becomes live.

    Items are the two wrapped items with `driving_`/`source_` key
    prefixes, e.g. `driving_video`, `source_video`.
    """

    def __init__(self, initial_dataset, number_of_pairs: int, seed: int = 0):
        self.initial_dataset = initial_dataset
        pairs_list = getattr(initial_dataset, "pairs_list", None)
        if pairs_list is None:
            max_idx = min(number_of_pairs, len(initial_dataset))
            xy = np.mgrid[:max_idx, :max_idx].reshape(2, -1).T
            number_of_pairs = min(xy.shape[0], number_of_pairs)
            rng = np.random.default_rng(seed)
            take = rng.choice(xy.shape[0], number_of_pairs, replace=False)
            self.pairs = [tuple(int(v) for v in xy[i]) for i in take]
        else:
            import csv

            names = [e.name for e in initial_dataset.entries]
            name_to_index = {n: i for i, n in enumerate(names)}
            self.pairs = []
            with open(pairs_list, newline="") as f:
                for row in csv.DictReader(f):
                    d, s = row["driving"], row["source"]
                    if d in name_to_index and s in name_to_index:
                        self.pairs.append((name_to_index[d], name_to_index[s]))
                    if len(self.pairs) >= number_of_pairs:
                        break

    def __len__(self) -> int:
        return len(self.pairs)

    def __getitem__(self, idx: int) -> dict:
        d_idx, s_idx = self.pairs[idx]
        first = self.initial_dataset[d_idx]
        second = self.initial_dataset[s_idx]
        out = {f"driving_{k}": v for k, v in first.items()}
        out.update({f"source_{k}": v for k, v in second.items()})
        return out
