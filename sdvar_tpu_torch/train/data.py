"""Training data: a copy of ``sdvar_tpu/train/data.py``.

Seeded synthetic datasets with the ImageNet interface (``SyntheticImageNet``
noise, ``StructuredSynthImages`` class-conditional patterns with learnable
structure, ``write_structured_folder`` to write the latter as PNGs), the
folder dataset (``FolderImageNet``: shorter edge resized to 1.125x reso
with LANCZOS, random or center crop, optional hflip, values in [-1, 1];
PIL imported only when a folder is read) and the host-side samplers:
``EvalDistributedSampler`` (contiguous per-rank shards) and
``DistInfiniteBatchSampler`` (an epoch-seeded global permutation, filled to
whole batches, a contiguous slice per rank, resumable). Every sample and
index sequence equals the JAX package's.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def normalize_01_into_pm1(x: np.ndarray) -> np.ndarray:
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


class SyntheticImageNet:
    """Deterministic random dataset with the ImageNet interface; stands in
    for a real dataset in tests and smoke runs."""

    def __init__(self, reso: int = 256, num_classes: int = 1000,
                 length: int = 1024, seed: int = 0):
        self.reso, self.num_classes, self.length = reso, num_classes, length
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        img = rng.uniform(-1, 1, (3, self.reso, self.reso)).astype(np.float32)
        label = int(rng.integers(0, self.num_classes))
        return img, label


class StructuredSynthImages:
    """Class-conditional procedural images with learnable structure (unlike
    ``SyntheticImageNet``'s pure noise): each class fixes a pattern family,
    a frequency/orientation band and a palette; each sample draws phase,
    position and amplitude jitter plus pixel noise. Coarse scales become
    predictable from the class while fine scales stay stochastic, so a
    model trained on it lands at partial per-scale accuracy."""

    def __init__(self, reso: int = 288, num_classes: int = 16,
                 length: int = 2048, seed: int = 0, noise: float = 0.06):
        self.reso, self.num_classes = reso, num_classes
        self.length, self.seed, self.noise = length, seed, noise
        r = reso
        self._yy, self._xx = np.mgrid[0:r, 0:r].astype(np.float32) / r

    def __len__(self):
        return self.length

    def _pattern(self, c: int, rng) -> np.ndarray:
        """(reso, reso) float32 in [-1, 1]; family from c%4, band from c//4."""
        x, y = self._xx, self._yy
        fam, lvl = c % 4, c // 4
        tau = 2.0 * np.pi
        if fam == 0:      # oriented stripes
            f = 3.0 + 2.0 * lvl
            th = np.deg2rad(45.0 * lvl + rng.uniform(-12, 12))
            v = np.sin(tau * f * (x * np.cos(th) + y * np.sin(th))
                       + rng.uniform(0, tau))
        elif fam == 1:    # checker product
            f = 2.0 + lvl
            v = (np.sin(tau * f * x + rng.uniform(0, tau))
                 * np.sin(tau * f * y + rng.uniform(0, tau)))
        elif fam == 2:    # radial rings around a jittered center
            f = 4.0 + 2.0 * lvl
            cx, cy = 0.5 + rng.uniform(-0.15, 0.15, 2)
            v = np.sin(tau * f * np.hypot(x - cx, y - cy)
                       + rng.uniform(0, tau))
        else:             # soft blobs at random positions
            v = np.zeros_like(x)
            for _ in range(3 + lvl):
                cx, cy = rng.uniform(0.1, 0.9, 2)
                v += np.exp(-(np.hypot(x - cx, y - cy) ** 2) / (2 * 0.08**2))
            v = v / max(float(v.max()), 1e-6) * 2.0 - 1.0
        return v.astype(np.float32)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        c = i % self.num_classes
        rng = np.random.default_rng(self.seed * 9_999_991 + i)
        v = self._pattern(c, rng)
        # distinct per-class palette (hue wheel) with per-sample amplitude
        hue = 2.0 * np.pi * c / self.num_classes
        base = np.array([np.cos(hue), np.cos(hue - 2.0943951),
                         np.cos(hue + 2.0943951)], np.float32) * 0.5
        amp = rng.uniform(0.75, 1.0)
        img = base[:, None, None] * (0.35 + 0.65 * v[None]) * amp * 2.0
        img = img + rng.normal(0, self.noise, img.shape).astype(np.float32)
        return np.clip(img, -1.0, 1.0).astype(np.float32), c


def write_structured_folder(root: str, num_classes: int = 16,
                            per_class: int = 128, reso: int = 288,
                            seed: int = 0) -> int:
    """Materialize ``StructuredSynthImages`` as a class-dir PNG tree so the
    REAL folder pipeline (FolderImageNet crops, pretokenize passes, eval
    center-crop) runs end-to-end on it. Idempotent. Returns image count."""
    from PIL import Image

    ds = StructuredSynthImages(reso=reso, num_classes=num_classes,
                               length=num_classes * per_class, seed=seed)
    n = 0
    for i in range(len(ds)):
        img, c = ds[i]
        d = os.path.join(root, f"cls_{c:03d}")
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, f"img_{i:05d}.png")
        if not os.path.exists(p):
            u8 = ((img.transpose(1, 2, 0) + 1.0) * 127.5).clip(0, 255)
            Image.fromarray(u8.astype(np.uint8)).save(p)
        n += 1
    return n


class FolderImageNet:
    """The images ``root/{class_dir}/*.{jpg,png,jpeg,...}``, one class a
    directory. train: mid-resize 1.125x + random crop (+ optional hflip);
    val: center crop."""

    EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")

    def __init__(self, root: str, reso: int = 256, train: bool = True,
                 hflip: bool = False, mid_reso: float = 1.125, seed: int = 0):
        from PIL import Image  # noqa: F401 - fail fast without PIL

        self.root, self.reso, self.train = root, reso, train
        self.hflip, self.seed = hflip, seed
        self.mid = round(mid_reso * reso)
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(self.EXTS):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        from PIL import Image

        path, label = self.samples[i]
        img = Image.open(path).convert("RGB")
        w, h = img.size
        # the shorter edge to mid_reso (LANCZOS)
        scale = self.mid / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)),
                         Image.LANCZOS)
        w, h = img.size
        if self.train:
            rng = np.random.default_rng(self.seed * 7_777_777 + i)
            x0 = int(rng.integers(0, w - self.reso + 1))
            y0 = int(rng.integers(0, h - self.reso + 1))
            if self.hflip and rng.uniform() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            x0, y0 = (w - self.reso) // 2, (h - self.reso) // 2
        img = img.crop((x0, y0, x0 + self.reso, y0 + self.reso))
        arr = np.asarray(img, dtype=np.float32).transpose(2, 0, 1) / 255.0
        return normalize_01_into_pm1(arr), label


def build_dataset(root: Optional[str], reso: int = 256, train: bool = True,
                  hflip: bool = False, synthetic_len: int = 1024):
    """Folder dataset when root exists, synthetic otherwise."""
    if root and os.path.isdir(root):
        return FolderImageNet(root, reso=reso, train=train, hflip=hflip)
    return SyntheticImageNet(reso=reso, length=synthetic_len)


class EvalDistributedSampler:
    """Contiguous per-rank shards without padding."""

    def __init__(self, length: int, num_replicas: int, rank: int):
        per = (length + num_replicas - 1) // num_replicas
        beg = per * rank
        end = min(length, beg + per)
        self.indices = list(range(beg, end))

    def __iter__(self):
        return iter(self.indices)

    def __len__(self):
        return len(self.indices)


class DistInfiniteBatchSampler:
    """Epoch-seeded global permutation, fill-last, per-rank contiguous
    slice, resumable via (start_ep, start_it)."""

    def __init__(self, dataset_len: int, glb_batch_size: int,
                 world_size: int = 1, rank: int = 0,
                 seed: int = 0, shuffle: bool = True, fill_last: bool = True,
                 start_ep: int = 0, start_it: int = 0):
        assert glb_batch_size % world_size == 0
        self.dataset_len = dataset_len
        self.glb_batch_size = glb_batch_size
        self.batch_size = glb_batch_size // world_size
        self.world_size, self.rank = world_size, rank
        self.seed, self.shuffle, self.fill_last = seed, shuffle, fill_last
        self.iters_per_ep = (
            dataset_len // glb_batch_size
            if not fill_last
            else (dataset_len + glb_batch_size - 1) // glb_batch_size
        )
        self.epoch = start_ep
        self.start_it = start_it

    def _epoch_global_indices(self, ep: int) -> np.ndarray:
        g = np.random.default_rng(self.seed + ep) if self.shuffle else None
        idx = (
            g.permutation(self.dataset_len)
            if g is not None
            else np.arange(self.dataset_len)
        )
        total = self.iters_per_ep * self.glb_batch_size
        if total > len(idx):  # fill-last: pad by wrapping
            pad = total - len(idx)
            idx = np.concatenate([idx, idx[:pad]])
        return idx[:total]

    def __iter__(self) -> Iterator[List[int]]:
        while True:
            idx = self._epoch_global_indices(self.epoch)
            # per-rank contiguous slice
            per = self.iters_per_ep * self.batch_size
            mine = idx[self.rank * per : (self.rank + 1) * per]
            start = self.start_it
            self.start_it = 0
            for it in range(start, self.iters_per_ep):
                yield mine[it * self.batch_size : (it + 1) * self.batch_size].tolist()
            self.epoch += 1


def batch_arrays(dataset, indices: Sequence[int]):
    imgs, labels = zip(*(dataset[i] for i in indices))
    return np.stack(imgs), np.asarray(labels, dtype=np.int32)
