"""Pre-tokenize an image folder into token-id shards, once (the counterpart
of the repository's ``tools/pretokenize.py``).

    python -m sdvar_tpu_torch.tools.pretokenize --data /path/to/train \\
        --out /path/to/tokens --reso 256 --passes 4 \\
        [--ckpt-vae vae_ch160v4096z32.pth] [--bf16] [--batch 32]

Then train off the stored ids with
``python -m sdvar_tpu_torch.train.train_loop --tokens /path/to/tokens``.
A thin command line over ``train/pretokenize.py``: one dataset per
augmentation pass (``build_token_datasets_for_passes``; synthetic images
without ``--data``), encoded by the frozen VQVAE (f32, or the
channels-last bf16 encoder with ``--bf16``). Without ``--ckpt-vae`` the
VQVAE is ``init_vqvae_params(seed=--seed)`` (a pipeline exercise, said on
a line of its own). Resumable: a second run skips the finished shards.
On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from sdvar_tpu_torch.config import VQVAEConfig, patch_nums_for_reso
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.train.pretokenize import (
    build_token_datasets_for_passes,
    pretokenize_dataset,
)
from sdvar_tpu_torch.utils.device import resolve_device
from sdvar_tpu_torch.utils.torch_port import vqvae_params_from_torch


def run(out: str, data: Optional[str] = None, reso: int = 256,
        passes: int = 1, batch: int = 32, shard_size: int = 4096,
        seed: int = 0, bf16: bool = False, hflip: bool = False,
        synthetic_len: int = 1024, ckpt_vae: Optional[str] = None,
        device="cuda") -> dict:
    """Write the shards and the manifest under ``out``; returns the
    manifest."""
    dev = resolve_device(device)
    vae_cfg = VQVAEConfig(patch_nums=patch_nums_for_reso(reso))
    if ckpt_vae:
        vae_params = vqvae_params_from_torch(
            vae_cfg, torch.load(ckpt_vae, map_location="cpu"), device=dev)
    else:
        print("[pretokenize] no --ckpt-vae: seed-initialized VQVAE "
              "(pipeline exercise only)", flush=True)
        vae_params = init_vqvae_params(vae_cfg, seed=seed, device=dev)
    datasets = build_token_datasets_for_passes(
        data, reso, passes, seed=seed, hflip=hflip, synthetic_len=synthetic_len)
    m = pretokenize_dataset(vae_cfg, vae_params, datasets, out, batch=batch,
                            shard_size=shard_size, tokenize_bf16=bf16)
    size_mb = m["num_samples"] * m["passes"] * m["L"] * 2 / 2 ** 20
    print(f"[pretokenize] DONE: {m['num_samples']} samples x {m['passes']} "
          f"passes -> {m['num_shards']} shards (~{size_mb:.0f} MiB) in "
          f"{out}", flush=True)
    return m


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data", type=str, default=None,
                    help="image train folder; synthetic data when absent")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--reso", type=int, default=256)
    ap.add_argument("--passes", type=int, default=1,
                    help="augmentation draws stored per image (crop/flip "
                         "seeds); training rotates them per epoch")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--shard-size", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bf16", action="store_true",
                    help="the channels-last bf16 encoder "
                         "(models/vqvae.img_to_idxBl_nhwc)")
    ap.add_argument("--hflip", action="store_true")
    ap.add_argument("--synthetic-len", type=int, default=1024)
    ap.add_argument("--ckpt-vae", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    run(a.out, data=a.data, reso=a.reso, passes=a.passes, batch=a.batch,
        shard_size=a.shard_size, seed=a.seed, bf16=a.bf16, hflip=a.hflip,
        synthetic_len=a.synthetic_len, ckpt_vae=a.ckpt_vae, device=a.device)


if __name__ == "__main__":
    main()
