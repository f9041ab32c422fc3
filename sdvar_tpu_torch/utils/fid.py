"""FID packaging (the counterpart of ``sdvar_tpu/utils/fid.py``): exactly N
samples (50,000 by default) packed into an .npz of uint8 NHWC images under
``arr_0``, the input of the OpenAI guided-diffusion FID toolkit against
``VIRTUAL_imagenet256_labeled.npz``.

The array path (``create_npz_from_arrays``) needs numpy only. PNG files go
through PIL (``save_sample_pngs``, ``create_npz_from_sample_folder``),
imported where it is used: it raises where PIL is missing, and the array
path does not need it.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np


def create_npz_from_sample_folder(sample_dir: str, num: int = 50_000,
                                  out_path: Optional[str] = None) -> str:
    """Pack ``{sample_dir}/{000000..}.png`` into ``{sample_dir}.npz`` (uint8
    NHWC)."""
    from PIL import Image

    arr = np.stack([np.asarray(Image.open(os.path.join(sample_dir, f"{i:06d}.png")),
                               dtype=np.uint8) for i in range(num)])
    out_path = out_path or f"{sample_dir}.npz"
    np.savez(out_path, arr_0=arr)
    print(f"[fid] saved {arr.shape} to {out_path}")
    return out_path


def images01_to_uint8(imgs_BCHW: np.ndarray) -> np.ndarray:
    """[0, 1] float (B, 3, H, W) -> uint8 (B, H, W, 3), rounding half to
    even."""
    x = np.clip(np.asarray(imgs_BCHW), 0.0, 1.0)
    return (x * 255.0).round().astype(np.uint8).transpose(0, 2, 3, 1)


def create_npz_from_arrays(batches: Iterable[np.ndarray], out_path: str,
                           num: int = 50_000) -> str:
    """Stream image batches ((B, 3, H, W) in [0, 1]) straight into the FID
    npz, without PNG files; stops once ``num`` images have arrived and
    raises if fewer do."""
    chunks, total = [], 0
    for b in batches:
        u8 = images01_to_uint8(b)
        chunks.append(u8)
        total += u8.shape[0]
        if total >= num:
            break
    if total < num:
        raise ValueError(f"create_npz_from_arrays: {total} images, {num} asked")
    arr = np.concatenate(chunks)[:num]
    np.savez(out_path, arr_0=arr)
    print(f"[fid] saved {arr.shape} to {out_path}")
    return out_path


def save_sample_pngs(imgs_BCHW: np.ndarray, out_dir: str, start_idx: int = 0):
    """Write each [0, 1] (3, H, W) image as ``{out_dir}/{index:06d}.png``
    through PIL."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for i, im in enumerate(images01_to_uint8(imgs_BCHW)):
        Image.fromarray(im).save(os.path.join(out_dir, f"{start_idx + i:06d}.png"))
