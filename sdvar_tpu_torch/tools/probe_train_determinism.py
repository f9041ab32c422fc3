"""Whether a training run gives the same bits twice on this device.

    python -m sdvar_tpu_torch.tools.probe_train_determinism [depth] [iters] [--device cpu]

Writes a small structured dataset (4 classes x 32 images at 288px, as
``tools/train_pair.py`` does) into a temporary directory, pretokenizes it
once (one pass, the default VQVAE from seed 0), then runs the same
token-path ``run_training`` (VAR-``depth``, batch 16, bf16 compute) twice
in this process and counts the leaves of the parameters and of the
optimizer state that differ. Then one more step under
``torch.use_deterministic_algorithms(True, warn_only=True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and prints every op PyTorch warns
has no deterministic implementation. The switch is restored after.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import warnings

import torch

from sdvar_tpu_torch.config import TrainConfig, VQVAEConfig
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.train import train_loop as TL
from sdvar_tpu_torch.train.data import write_structured_folder
from sdvar_tpu_torch.train.pretokenize import (
    build_token_datasets_for_passes,
    pretokenize_dataset,
)
from sdvar_tpu_torch.train.trainer import tree_leaves
from sdvar_tpu_torch.utils.device import card_name, resolve_device


def run(depth: int = 4, iters: int = 12, device="cuda", reso: int = 256,
        var_cfg=None, vae_cfg=None) -> dict:
    """{"leaves", "differ" (paths), "flagged" (warning texts)}; ``reso``,
    ``var_cfg`` and ``vae_cfg`` shrink the run for a test."""
    dev = resolve_device(device)
    print(f"[determinism] {card_name(dev)}", flush=True)
    vae_cfg = vae_cfg or VQVAEConfig()
    tc = TrainConfig(depth=depth, reso=reso, global_batch_size=16, epochs=4,
                     saln_every=100)
    with tempfile.TemporaryDirectory() as work:
        data, tokens = os.path.join(work, "train"), os.path.join(work, "tok")
        write_structured_folder(data, 4, 32, reso=reso * 9 // 8, seed=0)
        pretokenize_dataset(
            vae_cfg, init_vqvae_params(vae_cfg, seed=0, device=dev),
            build_token_datasets_for_passes(data, reso, 1, seed=0, hflip=True),
            tokens, batch=32, log_every=0)

        def train(tag, n):
            state, _ = TL.run_training(
                tc, data_root=data, out_dir=os.path.join(work, tag), seed=0,
                max_iters=n, batch_override=16, dtype=torch.bfloat16,
                var_cfg=var_cfg, vae_cfg=vae_cfg, token_root=tokens,
                val_root=data, device=dev)
            return list(tree_leaves({"params": state.params,
                                     "opt_state": state.opt_state}))

        a, b = train("run0", iters), train("run1", iters)
        differ = [p for (p, x), (_, y) in zip(a, b) if not torch.equal(x, y)]
        print(f"[determinism] two runs of {iters} steps: {len(differ)} of "
              f"{len(a)} leaves differ {differ[:12]}", flush=True)
        saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                train("flagged", 1)
        finally:
            torch.use_deterministic_algorithms(False)
            if saved is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved
    flagged = sorted({str(w.message).split(". ")[0] for w in caught
                      if "deterministic" in str(w.message)})
    print(f"[determinism] ops without a deterministic implementation in a "
          f"step: {len(flagged)}", flush=True)
    for m in flagged:
        print(f"    {m}", flush=True)
    return {"leaves": len(a), "differ": differ, "flagged": flagged}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("depth", type=int, nargs="?", default=4)
    ap.add_argument("iters", type=int, nargs="?", default=12)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    run(a.depth, a.iters, device=a.device)


if __name__ == "__main__":
    main()
