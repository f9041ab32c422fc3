"""A minimal VQVAE training step (the counterpart of
``sdvar_tpu/train/vae_trainer.py``), the consumer of the quantizer's
training half.

One step: encode the images, ``models.quantizer.vq_train_forward``
(straight-through f_hat, per-scale codebook hits, the commitment and
codebook losses), decode, an L2 reconstruction loss, then plain SGD on
every parameter; the hits go into the EMA tracker
(``update_vocab_hit_ema``) and give ``vocab_usage_per_scale``. Where a
mesh is registered (``ops.partition.set_tp_mesh``) each rank steps on its
rows of the batch: the gradients and losses are averaged over "data" and
the hits summed, so the parameters, whole on every rank, stay equal
across the ranks and take the step of the whole batch. SGD only, no perceptual or GAN loss: the
module keeps the VAE-training surface exercised, it is not a VQVAE recipe.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from sdvar_tpu_torch.config import VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.ops.partition import data_count, mean_over_data, reduce_data
from sdvar_tpu_torch.train.trainer import tree_leaves, tree_map


@dataclasses.dataclass
class VAETrainState:
    params: Dict
    ema_hits_SV: torch.Tensor  # (num_scales, vocab) EMA codebook-hit tracker
    step: int = 0              # the blend schedule of update_vocab_hit_ema


def init_vae_train_state(cfg: VQVAEConfig, params: Dict) -> VAETrainState:
    dev = next(t for _, t in tree_leaves(params)).device
    return VAETrainState(params, torch.zeros(
        (len(cfg.patch_nums), cfg.vocab_size), dtype=torch.float32,
        device=dev), 0)


def vae_loss(cfg: VQVAEConfig, params: Dict, img: torch.Tensor
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, Dict]]:
    """Reconstruction + VQ loss of a batch: (loss, (hits (SN, V), {rec_loss,
    vq_loss}))."""
    f = VQ.img_to_f(cfg, params, img)
    f_hat_st, hits_SV, vq_loss = Q.vq_train_forward(cfg, params["quant"], f)
    rec = VQ.fhat_to_img(cfg, params, f_hat_st)
    rec_loss = ((rec - img.float()) ** 2).mean()
    return rec_loss + vq_loss, (hits_SV, {"rec_loss": rec_loss,
                                          "vq_loss": vq_loss})


def vae_train_step(cfg: VQVAEConfig, state: VAETrainState, img: torch.Tensor,
                   lr: float) -> Tuple[VAETrainState, Dict]:
    """One SGD step, ``p - lr * g`` on every parameter, and the EMA
    codebook-hit update. Returns the new state (new tensors) and the
    metrics: loss, rec_loss, vq_loss and usage_per_scale (SN,) in %. On a
    mesh ``img`` is this rank's rows: the gradients and the three losses
    are averaged over "data" (the global batch's mean, as the JAX step
    computes it on the whole batch) and the hits summed, so every rank
    takes the same step."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), state.params)
    flat = [t for _, t in tree_leaves(leaves)]
    loss, (hits_SV, metrics) = vae_loss(cfg, leaves, img)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    losses = torch.stack([loss.detach(), metrics["rec_loss"].detach(),
                          metrics["vq_loss"].detach()])
    if data_count() > 1:
        *grads, losses = mean_over_data(list(grads) + [losses])
    grads = iter(grads)
    lr_t = torch.tensor(lr, dtype=torch.float32)
    params = tree_map(lambda p: p - lr_t.to(p.device) * next(grads),
                      state.params)
    hits_SV = reduce_data(hits_SV.detach())
    ema = Q.update_vocab_hit_ema(state.ema_hits_SV, hits_SV, state.step)
    B, H = img.shape[0], cfg.patch_nums[-1]
    usage = Q.vocab_usage_per_scale(cfg, ema, batch_tokens=B * H * H,
                                    world_size=data_count())
    metrics = {"loss": losses[0], "rec_loss": losses[1], "vq_loss": losses[2],
               "usage_per_scale": usage}
    return VAETrainState(params, ema, state.step + 1), metrics
