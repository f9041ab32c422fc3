"""Reference PyTorch checkpoints (VAR and VQVAE state_dicts) -> the port's
parameter trees, as f32 tensors on a device (the counterpart of
``sdvar_tpu/utils/torch_port.py``).

This is how the published model zoo (``vae_ch160v4096z32.pth``,
``var_d{16,20,24,30}.pth``) reaches the port. The port keeps the JAX
package's tree layout, so the mapping is the same: ``nn.Linear`` stores its
weight as (out, in) and the trees keep (in, out), so every linear weight is
transposed; per-layer tensors are stacked on a leading ``depth`` axis;
convolutions stay OIHW.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.utils.device import resolve_device


def _f32(sd: Dict, dev: torch.device):
    """A getter for state_dict entries as f32 tensors on ``dev``."""
    def get(name: str) -> torch.Tensor:
        v = sd[name]
        v = torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
        return v.detach().to(device=dev, dtype=torch.float32)
    return get


def var_params_from_torch(cfg: VARConfig, sd: Dict, device="cuda") -> Dict:
    """Map a reference VAR state_dict to the port's VAR tree."""
    get = _f32(sd, resolve_device(device))
    depth, C = cfg.depth, cfg.embed_dim

    def stack(fmt: str, transpose: bool = False) -> torch.Tensor:
        return torch.stack([get(fmt.format(i)).T if transpose else get(fmt.format(i))
                            for i in range(depth)]).contiguous()

    blocks = {
        "qkv_w": stack("blocks.{}.attn.mat_qkv.weight", transpose=True),
        "q_bias": stack("blocks.{}.attn.q_bias"),
        "v_bias": stack("blocks.{}.attn.v_bias"),
        "proj_w": stack("blocks.{}.attn.proj.weight", transpose=True),
        "proj_b": stack("blocks.{}.attn.proj.bias"),
        "fc1_w": stack("blocks.{}.ffn.fc1.weight", transpose=True),
        "fc1_b": stack("blocks.{}.ffn.fc1.bias"),
        "fc2_w": stack("blocks.{}.ffn.fc2.weight", transpose=True),
        "fc2_b": stack("blocks.{}.ffn.fc2.bias"),
    }
    if cfg.attn_l2_norm:
        blocks["scale_mul"] = stack("blocks.{}.attn.scale_mul_1H11").reshape(
            depth, cfg.num_heads)
    if cfg.shared_aln:
        blocks["ada_gss"] = stack("blocks.{}.ada_gss").reshape(depth, 1, 6, C)
    else:
        blocks["ada_lin_w"] = stack("blocks.{}.ada_lin.1.weight", transpose=True)
        blocks["ada_lin_b"] = stack("blocks.{}.ada_lin.1.bias")

    def linear(name: str) -> Dict:
        return {"w": get(name + ".weight").T.contiguous(), "b": get(name + ".bias")}

    params = {
        "word_embed": linear("word_embed"),
        "class_emb": get("class_emb.weight"),
        "pos_start": get("pos_start").reshape(cfg.first_l, C),
        "pos_1LC": get("pos_1LC").reshape(cfg.L, C),
        "lvl_embed": get("lvl_embed.weight"),
        "blocks": blocks,
        "head_nm": linear("head_nm.ada_lin.1"),
        "head": linear("head"),
    }
    if cfg.shared_aln:
        params["shared_ada_lin"] = linear("shared_ada_lin.1")
    return params


def quantizer_params_from_torch(cfg: VQVAEConfig, sd: Dict, device="cuda") -> Dict:
    """Map the VectorQuantizer2 weights (``quantize.``: codebook and phi
    convs)."""
    get = _f32(sd, resolve_device(device))
    K = cfg.num_phi
    if cfg.share_quant_resi == 1:
        names = ["quantize.quant_resi.qresi."]
    elif cfg.share_quant_resi == 0:
        names = [f"quantize.quant_resi.{k}." for k in range(K)]
    else:
        names = [f"quantize.quant_resi.qresi_ls.{k}." for k in range(K)]
    return {
        "codebook": get("quantize.embedding.weight"),
        "phi_w": torch.stack([get(n + "weight") for n in names]),
        "phi_b": torch.stack([get(n + "bias") for n in names]),
    }


def vqvae_params_from_torch(cfg: VQVAEConfig, sd: Dict, device="cuda") -> Dict:
    """Map a full reference VQVAE state_dict (encoder, decoder, the quant
    convs and the quantizer) to the port's VQVAE tree."""
    dev = resolve_device(device)
    get = _f32(sd, dev)
    nres = len(cfg.ch_mult)

    def conv(name):
        return {"w": get(name + ".weight"), "b": get(name + ".bias")}

    def gn(name):
        return {"g": get(name + ".weight"), "b": get(name + ".bias")}

    def res(name):
        p = {"norm1": gn(name + ".norm1"), "conv1": conv(name + ".conv1"),
             "norm2": gn(name + ".norm2"), "conv2": conv(name + ".conv2")}
        if name + ".nin_shortcut.weight" in sd:
            p["nin_shortcut"] = conv(name + ".nin_shortcut")
        return p

    def attn(name):
        return {"norm": gn(name + ".norm"), "qkv": conv(name + ".qkv"),
                "proj_out": conv(name + ".proj_out")}

    def level(pre, n_blocks, i, resample):
        lvl = {"block": [res(f"{pre}.block.{j}") for j in range(n_blocks)],
               "attn": ([attn(f"{pre}.attn.{j}") for j in range(n_blocks)]
                        if i == nres - 1 and cfg.using_sa else [])}
        if f"{pre}.{resample}.conv.weight" in sd:
            lvl[resample] = conv(f"{pre}.{resample}.conv")
        return lvl

    def mid(pre):
        return {"block_1": res(pre + ".block_1"), "attn_1": attn(pre + ".attn_1"),
                "block_2": res(pre + ".block_2")}

    encoder = {
        "conv_in": conv("encoder.conv_in"),
        "down": [level(f"encoder.down.{i}", cfg.num_res_blocks, i, "downsample")
                 for i in range(nres)],
        "mid": mid("encoder.mid"),
        "norm_out": gn("encoder.norm_out"),
        "conv_out": conv("encoder.conv_out"),
    }
    decoder = {
        "conv_in": conv("decoder.conv_in"),
        "mid": mid("decoder.mid"),
        "up": [level(f"decoder.up.{i}", cfg.num_res_blocks + 1, i, "upsample")
               for i in range(nres)],
        "norm_out": gn("decoder.norm_out"),
        "conv_out": conv("decoder.conv_out"),
    }
    return {
        "encoder": encoder,
        "decoder": decoder,
        "quant_conv": conv("quant_conv"),
        "post_quant_conv": conv("post_quant_conv"),
        "quant": quantizer_params_from_torch(cfg, sd, dev),
    }
