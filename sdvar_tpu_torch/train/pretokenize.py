"""Pre-tokenized training: VQVAE-encode the dataset once, then train off
the stored token ids (the counterpart of ``sdvar_tpu/train/pretokenize.py``,
with the same files, so either package reads what the other writes).

Layout of a token dataset directory (every file written atomically, so an
interrupted run resumes at the first missing shard):

    manifest.json            {num_samples, L, passes, shard_size, ...}
    tokens_00000.npy         (n, passes, L) uint16   [mmap-read at train time]
    labels_00000.npy         (n,) int32
    ...

``passes`` stores several augmentation draws (different crop/flip seeds) per
image; ``TokenDataset`` rotates the active pass with the epoch. The default
single pass matches the image path exactly (its crop rng is seeded per
index, not per epoch).
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import vqvae as VQ

MANIFEST = "manifest.json"


def _tok_name(k: int) -> str:
    return f"tokens_{k:05d}.npy"


def _lab_name(k: int) -> str:
    return f"labels_{k:05d}.npy"


def _atomic_save(path: str, arr: np.ndarray) -> None:
    tmp = path + ".tmp.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)


def pretokenize_dataset(
    vae_cfg: VQVAEConfig,
    vae_params,
    datasets: Sequence,
    out_dir: str,
    batch: int = 32,
    shard_size: int = 4096,
    tokenize_bf16: bool = False,
    log_every: int = 10,
) -> dict:
    """Encode every image of every dataset pass into token-id shards, on the
    parameters' device.

    ``datasets``: one dataset per augmentation pass (same length, same
    labels, different crop seeds). Returns the manifest dict. Resumable:
    shards whose files already exist are skipped.
    """
    n = len(datasets[0])
    passes = len(datasets)
    for d in datasets[1:]:
        if len(d) != n:
            raise ValueError("all passes must cover the same samples")
    L = sum(p * p for p in vae_cfg.patch_nums)
    if vae_cfg.vocab_size > 65536:
        raise ValueError("token ids must fit uint16")
    os.makedirs(out_dir, exist_ok=True)
    dev = vae_params["quant"]["codebook"].device
    # bf16 path: the channels-last encoder
    tok_fn = VQ.img_to_idxBl_nhwc if tokenize_bf16 else VQ.img_to_idxBl

    @torch.no_grad()
    def encode(img):
        return torch.cat(tok_fn(vae_cfg, vae_params,
                                torch.from_numpy(img).to(dev)), dim=1)

    num_shards = (n + shard_size - 1) // shard_size
    manifest = {
        "num_samples": n,
        "L": L,
        "passes": passes,
        "shard_size": shard_size,
        "num_shards": num_shards,
        "patch_nums": list(vae_cfg.patch_nums),
        "vocab_size": vae_cfg.vocab_size,
        "tokenize_bf16": tokenize_bf16,
    }

    t0 = time.time()
    done_imgs = 0
    for k in range(num_shards):
        tpath = os.path.join(out_dir, _tok_name(k))
        lpath = os.path.join(out_dir, _lab_name(k))
        beg, end = k * shard_size, min(n, (k + 1) * shard_size)
        if os.path.exists(tpath) and os.path.exists(lpath):
            done_imgs += (end - beg) * passes
            continue  # resume: shard already complete
        toks = np.empty((end - beg, passes, L), np.uint16)
        labs = np.empty((end - beg,), np.int32)
        for p, ds in enumerate(datasets):
            for off in range(beg, end, batch):
                hi = min(end, off + batch)
                imgs, labels = zip(*(ds[i] for i in range(off, hi)))
                img = np.stack(imgs)
                pad = batch - img.shape[0]
                if pad:
                    img = np.concatenate([img, np.zeros_like(img[:1]).repeat(pad, 0)])
                ids = encode(img).cpu().numpy()
                if pad:
                    ids = ids[:-pad]
                toks[off - beg : hi - beg, p] = ids.astype(np.uint16)
                if p == 0:
                    labs[off - beg : hi - beg] = np.asarray(labels, np.int32)
                done_imgs += hi - off
                if log_every and (off // batch) % log_every == 0:
                    rate = done_imgs / max(time.time() - t0, 1e-9)
                    print(f"[pretokenize] shard {k}/{num_shards} pass {p} "
                          f"{done_imgs}/{n * passes} ({rate:.1f} img/s)",
                          flush=True)
        _atomic_save(tpath, toks)
        _atomic_save(lpath, labs)

    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f)
    return manifest


class TokenDataset:
    """Training-side view over a pre-tokenized directory.

    Same interface as the image datasets (len / getitem -> (array, label)),
    so the resumable epoch-seeded sampler (DistInfiniteBatchSampler) works
    unchanged; ``__getitem__`` returns the (L,) int32 token row for the
    ACTIVE augmentation pass — call ``set_epoch`` to rotate passes."""

    def __init__(self, root: str):
        with open(os.path.join(root, MANIFEST)) as f:
            self.manifest = json.load(f)
        m = self.manifest
        self.root = root
        self.shard_size = int(m["shard_size"])
        self.passes = int(m["passes"])
        self.L = int(m["L"])
        self.num_samples = int(m["num_samples"])
        self.pass_idx = 0
        # mmap every shard once; rows are touched lazily by the sampler
        self._toks: List[np.ndarray] = []
        self._labs: List[np.ndarray] = []
        for k in range(int(m["num_shards"])):
            self._toks.append(
                np.load(os.path.join(root, _tok_name(k)), mmap_mode="r"))
            self._labs.append(np.load(os.path.join(root, _lab_name(k))))

    def set_epoch(self, ep: int) -> None:
        self.pass_idx = ep % self.passes

    def __len__(self) -> int:
        return self.num_samples

    def __getitem__(self, i: int):
        k, j = divmod(i, self.shard_size)
        return (np.asarray(self._toks[k][j, self.pass_idx], np.int32),
                int(self._labs[k][j]))


def build_token_datasets_for_passes(
    data_root: Optional[str], reso: int, passes: int, seed: int = 0,
    hflip: bool = False, synthetic_len: int = 1024,
) -> List:
    """One image dataset per augmentation pass (distinct crop/flip seeds)."""
    from sdvar_tpu_torch.train.data import FolderImageNet, SyntheticImageNet

    out = []
    for p in range(passes):
        if data_root and os.path.isdir(data_root):
            out.append(FolderImageNet(data_root, reso=reso, train=True,
                                      hflip=hflip or p > 0,
                                      seed=seed + 1_000_000 * p))
        else:
            out.append(SyntheticImageNet(reso=reso, length=synthetic_len,
                                         seed=seed + 1_000_000 * p))
    return out
