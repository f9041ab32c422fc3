"""Model factories (the counterpart of ``sdvar_tpu/models/__init__.py``).

``build_vae_var`` returns the configs and seeded random parameters of one
VQVAE and one VAR; ``build_vae_var_speculative_decoding`` a draft/target
pair that shares one tokenizer (its weights are not duplicated). The
parameters are drawn on ``device`` (the card unless the caller asks for
the CPU) by the port's own initialisers, from ``seed`` in place of a JAX
key; their distributions are the JAX package's.
"""

from __future__ import annotations

from sdvar_tpu_torch.config import PATCH_NUMS_256, VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params


def build_vae_var(
    seed: int = 0,
    patch_nums=PATCH_NUMS_256,
    V: int = 4096, Cvae: int = 32, ch: int = 160, share_quant_resi: int = 4,
    num_classes: int = 1000, depth: int = 16,
    shared_aln: bool = False, attn_l2_norm: bool = True,
    device="cuda",
):
    """((vae_cfg, var_cfg), (vae_params, var_params))."""
    vae_cfg = VQVAEConfig(
        vocab_size=V, z_channels=Cvae, ch=ch,
        share_quant_resi=share_quant_resi, patch_nums=tuple(patch_nums),
    )
    var_cfg = VARConfig(
        depth=depth, num_classes=num_classes, patch_nums=tuple(patch_nums),
        vocab_size=V, Cvae=Cvae, shared_aln=shared_aln,
        attn_l2_norm=attn_l2_norm,
    )
    vae_params = init_vqvae_params(vae_cfg, seed=seed, device=device)
    var_params = init_var_params(var_cfg, seed=seed + 1, device=device)
    return (vae_cfg, var_cfg), (vae_params, var_params)


def build_vae_var_speculative_decoding(
    seed: int = 0,
    patch_nums=PATCH_NUMS_256,
    V: int = 4096, Cvae: int = 32, ch: int = 160, share_quant_resi: int = 4,
    num_classes: int = 1000, depth_draft: int = 16, depth_target: int = 30,
    shared_aln: bool = False, attn_l2_norm: bool = True,
    device="cuda",
):
    """((vae_cfg, draft_cfg, target_cfg),
    (vae_params, draft_params, target_params))."""
    vae_cfg = VQVAEConfig(
        vocab_size=V, z_channels=Cvae, ch=ch,
        share_quant_resi=share_quant_resi, patch_nums=tuple(patch_nums),
    )
    mk = dict(
        num_classes=num_classes, patch_nums=tuple(patch_nums), vocab_size=V,
        Cvae=Cvae, shared_aln=shared_aln, attn_l2_norm=attn_l2_norm,
    )
    draft_cfg = VARConfig(depth=depth_draft, **mk)
    target_cfg = VARConfig(depth=depth_target, **mk)
    vae_params = init_vqvae_params(vae_cfg, seed=seed, device=device)
    draft_params = init_var_params(draft_cfg, seed=seed + 1, device=device)
    target_params = init_var_params(target_cfg, seed=seed + 2, device=device)
    return ((vae_cfg, draft_cfg, target_cfg),
            (vae_params, draft_params, target_params))
