"""The port's checkpoint converter (``utils/torch_port.py``) against the JAX
package's (``sdvar_tpu/utils/torch_port.py``): a reference-layout VAR or
VQVAE state_dict, synthesized from a seed with the reference's key names,
goes through both, and every leaf agrees; both also give back the tree the
state_dict was made from."""

import numpy as np
import pytest
import torch

from sdvar_tpu.config import VARConfig as JVARConfig
from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.utils import torch_port as JT
from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.utils import torch_port as T

VAR_KW = dict(depth=2, num_classes=10, patch_nums=(1, 2, 3), vocab_size=64,
              Cvae=8, attn_l2_norm=True, head_dim=32)
VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2, 3))


def _flat(tree, prefix=""):
    """(path, leaf) pairs of a nested dict / list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            yield from _flat(v, path + "/")
        else:
            yield path, v


def _assert_trees_equal(got, want):
    """Same paths; torch or numpy leaves equal bit for bit."""
    g, w = dict(_flat(got)), dict(_flat(want))
    assert sorted(g) == sorted(w)
    for path, leaf in g.items():
        a = leaf.numpy() if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        b = w[path]
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == np.float32, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _var_state_dict(cfg: VARConfig, p):
    """The reference VAR state_dict of the port tree ``p``: nn.Linear
    weights (out, in), per-layer tensors unstacked."""
    C, H = cfg.embed_dim, cfg.num_heads
    sd = {"word_embed.weight": p["word_embed"]["w"].T,
          "word_embed.bias": p["word_embed"]["b"],
          "class_emb.weight": p["class_emb"],
          "pos_start": p["pos_start"].reshape(1, cfg.first_l, C),
          "pos_1LC": p["pos_1LC"].reshape(1, cfg.L, C),
          "lvl_embed.weight": p["lvl_embed"],
          "head_nm.ada_lin.1.weight": p["head_nm"]["w"].T,
          "head_nm.ada_lin.1.bias": p["head_nm"]["b"],
          "head.weight": p["head"]["w"].T, "head.bias": p["head"]["b"]}
    if cfg.shared_aln:
        sd["shared_ada_lin.1.weight"] = p["shared_ada_lin"]["w"].T
        sd["shared_ada_lin.1.bias"] = p["shared_ada_lin"]["b"]
    b = p["blocks"]
    for i in range(cfg.depth):
        pre = f"blocks.{i}."
        sd.update({pre + "attn.mat_qkv.weight": b["qkv_w"][i].T,
                   pre + "attn.q_bias": b["q_bias"][i],
                   pre + "attn.v_bias": b["v_bias"][i],
                   pre + "attn.proj.weight": b["proj_w"][i].T,
                   pre + "attn.proj.bias": b["proj_b"][i],
                   pre + "ffn.fc1.weight": b["fc1_w"][i].T,
                   pre + "ffn.fc1.bias": b["fc1_b"][i],
                   pre + "ffn.fc2.weight": b["fc2_w"][i].T,
                   pre + "ffn.fc2.bias": b["fc2_b"][i],
                   pre + "attn.scale_mul_1H11": b["scale_mul"][i].reshape(1, H, 1, 1)})
        if cfg.shared_aln:
            sd[pre + "ada_gss"] = b["ada_gss"][i].reshape(1, 1, 6, C)
        else:
            sd[pre + "ada_lin.1.weight"] = b["ada_lin_w"][i].T
            sd[pre + "ada_lin.1.bias"] = b["ada_lin_b"][i]
    return {k: v.contiguous().clone() for k, v in sd.items()}


@pytest.mark.parametrize("shared_aln", [False, True])
def test_var_state_dict_both_converters(shared_aln):
    """attn_l2_norm on, shared AdaLN both ways: the port's tree equals the
    JAX package's leaf for leaf, and both equal the tree the state_dict was
    made from (a non-trivial q/v bias and scale_mul included)."""
    cfg = VARConfig(shared_aln=shared_aln, **VAR_KW)
    p = init_var_params(cfg, seed=7, device="cpu")
    g = torch.Generator().manual_seed(8)
    for key in ("q_bias", "v_bias", "scale_mul", "fc1_b"):
        p["blocks"][key] = torch.randn(p["blocks"][key].shape, generator=g)
    sd = _var_state_dict(cfg, p)
    got = T.var_params_from_torch(cfg, sd, device="cpu")
    want = JT.var_params_from_torch(JVARConfig(shared_aln=shared_aln, **VAR_KW), sd)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, p)
    assert ("ada_gss" in got["blocks"]) == shared_aln
    assert ("shared_ada_lin" in got) == shared_aln


_RENAME = {"w": "weight", "g": "weight", "b": "bias", "upsample": "upsample.conv",
           "downsample": "downsample.conv"}


def _vqvae_state_dict(cfg: VQVAEConfig, p):
    """The reference VQVAE state_dict of the port tree ``p``."""
    sd = {}
    for part in ("encoder", "decoder", "quant_conv", "post_quant_conv"):
        for path, leaf in _flat(p[part], part + "/"):
            name = ".".join(_RENAME.get(s, s) for s in path.split("/"))
            sd[name] = leaf
    q = p["quant"]
    sd["quantize.embedding.weight"] = q["codebook"]
    for k in range(cfg.num_phi):
        pre = {1: "quantize.quant_resi.qresi.",
               0: f"quantize.quant_resi.{k}."}.get(
                   cfg.share_quant_resi, f"quantize.quant_resi.qresi_ls.{k}.")
        sd[pre + "weight"], sd[pre + "bias"] = q["phi_w"][k], q["phi_b"][k]
    return {k: v.contiguous().clone() for k, v in sd.items()}


@pytest.mark.parametrize("share_quant_resi", [4, 1, 0])
def test_vqvae_state_dict_both_converters(share_quant_resi):
    """Encoder, decoder, quant convs and quantizer, for each of the three
    phi layouts (shared list of 4, one shared, one per scale): both
    converters agree and give back the source tree."""
    cfg = VQVAEConfig(share_quant_resi=share_quant_resi, **VAE_KW)
    p = init_vqvae_params(cfg, seed=9, device="cpu", eini=1.0)
    sd = _vqvae_state_dict(cfg, p)
    got = T.vqvae_params_from_torch(cfg, sd, device="cpu")
    want = JT.vqvae_params_from_torch(
        JVQVAEConfig(share_quant_resi=share_quant_resi, **VAE_KW), sd)
    _assert_trees_equal(got, want)
    _assert_trees_equal(got, p)
    assert got["quant"]["phi_w"].shape[0] == cfg.num_phi


def test_numpy_state_dict_and_device_default(monkeypatch):
    """numpy leaves are taken as well as tensors, and with no device given
    the converter asks for the card, as every entry point does."""
    cfg = VARConfig(**VAR_KW)
    sd = {k: v.numpy() for k, v in
          _var_state_dict(cfg, init_var_params(cfg, seed=1, device="cpu")).items()}
    _assert_trees_equal(T.var_params_from_torch(cfg, sd, device="cpu"),
                        JT.var_params_from_torch(JVARConfig(**VAR_KW), sd))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.var_params_from_torch(cfg, sd)
