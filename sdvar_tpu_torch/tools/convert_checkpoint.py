"""Convert reference PyTorch model-zoo checkpoints into port checkpoints
(the counterpart of the repository's ``tools/convert_checkpoint.py``).

    python -m sdvar_tpu_torch.tools.convert_checkpoint --var var_d16.pth \\
        --depth 16 --out d16/
    python -m sdvar_tpu_torch.tools.convert_checkpoint \\
        --vae vae_ch160v4096z32.pth --out vae/

Takes the published VAR family (d16/d20/d24/d30, and d36-s with
``--shared-aln``; a training checkpoint's ``trainer`` / ``var_wo_ddp``
wrapper is unwrapped) and the shared tokenizer, maps each state_dict
through ``utils/torch_port.py`` and writes ``<out>/ckpt-00000000``
(``tree.pt`` and ``meta.json`` with the JAX tool's keys ``kind``,
``depth`` and ``patch_nums``) with ``train.checkpoint.save_checkpoint``.
``load_checkpoint`` with a template from ``init_var_params`` /
``init_vqvae_params`` of the same configuration reads it back. The trees
are made on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import torch

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.train.checkpoint import save_checkpoint
from sdvar_tpu_torch.utils.device import resolve_device
from sdvar_tpu_torch.utils.torch_port import (
    var_params_from_torch,
    vqvae_params_from_torch,
)

PATCH_NUMS = "1_2_3_4_5_6_8_10_13_16"


def load_state_dict(path: str) -> Dict:
    """A reference ``.pth`` as its model state_dict (a training
    checkpoint's ``trainer`` / ``var_wo_ddp`` entry where it has one)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "trainer" in sd:
        sd = sd["trainer"]["var_wo_ddp"]
    return sd


def run(out: str, var: Optional[str] = None, vae: Optional[str] = None,
        depth: int = 16, patch_nums: str = PATCH_NUMS,
        shared_aln: bool = False, no_attn_l2: bool = False,
        device="cuda") -> Dict[str, str]:
    """Convert the given files; returns {"var" | "vqvae": checkpoint
    path}. Both go into ``out`` when both are given, as in the JAX tool
    (the VQVAE's ``ckpt-00000000`` then replaces the VAR's)."""
    dev = resolve_device(device)
    pns = tuple(int(p) for p in patch_nums.split("_"))
    os.makedirs(out, exist_ok=True)
    written = {}
    if var:
        cfg = VARConfig(depth=depth, patch_nums=pns, shared_aln=shared_aln,
                        attn_l2_norm=not no_attn_l2)
        params = var_params_from_torch(cfg, load_state_dict(var), device=dev)
        written["var"] = save_checkpoint(out, 0, params, meta={
            "kind": "var", "depth": depth, "patch_nums": list(pns)})
        print(f"[convert] VAR d{depth} -> {out}", flush=True)
    if vae:
        cfg = VQVAEConfig(patch_nums=pns)
        params = vqvae_params_from_torch(cfg, load_state_dict(vae), device=dev)
        written["vqvae"] = save_checkpoint(out, 0, params, meta={
            "kind": "vqvae", "patch_nums": list(pns)})
        print(f"[convert] VQVAE -> {out}", flush=True)
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--var", type=str, default=None, help="VAR .pth path")
    ap.add_argument("--vae", type=str, default=None, help="VQVAE .pth path")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--patch-nums", type=str, default=PATCH_NUMS)
    ap.add_argument("--shared-aln", action="store_true")
    ap.add_argument("--no-attn-l2", action="store_true")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.out, var=args.var, vae=args.vae, depth=args.depth,
        patch_nums=args.patch_nums, shared_aln=args.shared_aln,
        no_attn_l2=args.no_attn_l2, device=args.device)


if __name__ == "__main__":
    main()
