"""Model, tokenizer, sampling, speculative-decoding, mesh and training
configuration.

A copy of the configuration classes of ``sdvar_tpu/config.py`` (the port
imports nothing from the JAX package). Frozen dataclasses, hashable, with
derived fields as properties. ``VQVAEConfig.phi_index`` keeps the float64
numpy tie-breaking of the reference: it decides which phi conv each scale
uses.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# Patch-number presets per output resolution.
PATCH_NUMS_256 = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)
PATCH_NUMS_512 = (1, 2, 3, 4, 6, 9, 13, 18, 24, 32)
PATCH_NUMS_1024 = (1, 2, 3, 4, 5, 7, 9, 12, 16, 21, 27, 36, 48, 64)

PRESETS = {256: PATCH_NUMS_256, 512: PATCH_NUMS_512, 1024: PATCH_NUMS_1024}


def patch_nums_for_reso(reso: int) -> Tuple[int, ...]:
    try:
        return PRESETS[reso]
    except KeyError:
        raise ValueError(f"no patch_nums preset for resolution {reso}") from None


@dataclasses.dataclass(frozen=True)
class VQVAEConfig:
    """Multi-scale residual-VQ tokenizer config (V=4096, Cvae=32, ch=160)."""

    vocab_size: int = 4096
    z_channels: int = 32           # Cvae
    ch: int = 160
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    dropout: float = 0.0
    beta: float = 0.25             # commitment loss weight
    using_znorm: bool = False      # cosine-sim codebook lookup instead of L2
    quant_conv_ks: int = 3
    quant_resi: float = 0.5        # phi(x) = 0.5*conv(x) + 0.5*x
    share_quant_resi: int = 4      # number of shared phi convs (0=per-scale, 1=single)
    default_qresi_counts: int = 0
    patch_nums: Tuple[int, ...] = PATCH_NUMS_256
    using_sa: bool = True
    using_mid_sa: bool = True

    @property
    def Cvae(self) -> int:
        return self.z_channels

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    @property
    def num_scales(self) -> int:
        return len(self.patch_nums)

    @property
    def num_phi(self) -> int:
        """Number of distinct phi convs."""
        if self.share_quant_resi == 0:
            return self.default_qresi_counts or len(self.patch_nums)
        return self.share_quant_resi

    def phi_index(self, si: int) -> int:
        """Which phi conv scale ``si`` uses: ticks are a linspace over
        (0, 1), and the phi whose tick is nearest to si/(SN-1) wins."""
        K = self.num_phi
        if self.share_quant_resi == 1:
            return 0
        # exact np.linspace/np.argmin arithmetic: tick distances can tie in
        # real arithmetic and float64 rounding decides the winner
        if K == 4:
            ticks = np.linspace(1 / 3 / K, 1 - 1 / 3 / K, K)
        else:
            ticks = np.linspace(1 / 2 / K, 1 - 1 / 2 / K, K)
        at = si / (self.num_scales - 1)
        return int(np.argmin(np.abs(ticks - at)))


@dataclasses.dataclass(frozen=True)
class VARConfig:
    """VAR transformer config: width = depth*head_dim, heads = depth,
    L = sum(pn^2)."""

    depth: int = 16
    num_classes: int = 1000
    patch_nums: Tuple[int, ...] = PATCH_NUMS_256
    vocab_size: int = 4096
    Cvae: int = 32
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-6
    shared_aln: bool = False
    attn_l2_norm: bool = True
    cond_drop_rate: float = 0.1
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0     # unsupported: rejected in __post_init__
    drop_path_rate: Optional[float] = None  # None -> 0.1*depth/24
    head_dim: int = 64

    def __post_init__(self):
        if self.attn_drop_rate != 0.0:
            raise NotImplementedError(
                "attn_drop_rate is not supported by the fused attention "
                "path; use drop_rate/drop_path_rate instead"
            )

    @property
    def embed_dim(self) -> int:
        return self.depth * self.head_dim

    @property
    def num_heads(self) -> int:
        return self.depth

    @property
    def cond_dim(self) -> int:
        return self.embed_dim

    @property
    def mlp_hidden(self) -> int:
        return round(self.embed_dim * self.mlp_ratio)

    @property
    def L(self) -> int:
        return sum(pn * pn for pn in self.patch_nums)

    @property
    def first_l(self) -> int:
        return self.patch_nums[0] ** 2

    @property
    def num_scales(self) -> int:
        return len(self.patch_nums)

    @property
    def num_stages_minus_1(self) -> int:
        return len(self.patch_nums) - 1

    @property
    def dpr(self) -> float:
        if self.drop_path_rate is not None:
            return self.drop_path_rate
        return 0.1 * self.depth / 24

    @property
    def begin_ends(self) -> Tuple[Tuple[int, int], ...]:
        out, cur = [], 0
        for pn in self.patch_nums:
            out.append((cur, cur + pn * pn))
            cur += pn * pn
        return tuple(out)

    def scale_of_token(self, t: int) -> int:
        for si, (bg, ed) in enumerate(self.begin_ends):
            if bg <= t < ed:
                return si
        raise IndexError(t)


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Sampling knobs for the decode loop."""

    cfg: float = 1.5
    top_k: int = 0
    top_p: float = 0.0
    more_smooth: bool = False


@dataclasses.dataclass(frozen=True)
class SpeculativeConfig:
    """Speculative-decoding engine knobs (the JAX package's, same defaults)."""

    gamma: int = 2                       # scales drafted per round
    match_threshold: float = 0.5         # top-1 match rate to accept a scale
    similarity_thresh: float = 0.8       # kept for parity with the reference
    entry_num: int = 4                   # static handoff point
    sd_mask: int = 3                     # handoff prefill mask mode 0..5
    dynamic_gamma: bool = True           # shrink gamma on total rejection
    force_accept_at_gamma1: bool = True  # livelock guard
    force_accept_all: bool = False       # accept every drafted scale: the
                                         # pipeline ceiling, for measurement


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Process-mesh layout: data-parallel x model (tensor)-parallel ranks,
    one process per rank (``parallel.mesh.create_mesh``)."""

    data: int = 1
    model: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX package's ``TrainConfig``)."""

    depth: int = 16
    reso: int = 256
    global_batch_size: int = 768
    grad_accum: int = 1
    epochs: int = 200
    base_lr: float = 1e-4          # per-256-batch LR
    lr_schedule: str = "lin0"      # {cos, lin, lin0, lin00, linX, exp}
    warmup_ep: Optional[float] = None   # None -> epochs / 50
    weight_decay: float = 0.05
    weight_decay_end: float = 0.0
    grad_clip: float = 2.0
    label_smooth: float = 0.1
    shared_aln: bool = False
    attn_l2_norm: bool = True
    workers: int = 0
    seed: Optional[int] = None
    bf16: bool = True
    remat: bool = False           # recompute each block in the backward
    tokenize_bf16: bool = False   # the frozen VQVAE's encoder in bf16
    optimizer: str = "adamw"      # "adamw" | "adafactor" (factored RMS)
    dbg_nan: bool = False         # stop at a non-finite loss
    saln_every: int = 10          # eval and checkpoint cadence in epochs
    pg: float = 0.0               # > 0: progressive over [0, pg] of training
    pg0: int = 4                  # the first progressive stage
    pgwp: Optional[float] = None  # per-stage warmup epochs; None -> ep / 300

    @property
    def patch_nums(self) -> Tuple[int, ...]:
        return patch_nums_for_reso(self.reso)

    def peak_lr(self, world_size_unused: int = 1) -> float:
        """lr = grad_accum * base_lr * global_batch / 256."""
        return self.grad_accum * self.base_lr * self.global_batch_size / 256

    def warmup_epochs(self) -> float:
        return self.warmup_ep if self.warmup_ep is not None else self.epochs / 50

    def pgwp_epochs(self) -> float:
        return self.pgwp if self.pgwp is not None else self.epochs / 300

    def prog_si_at(self, g_it: int, wp_it: float, max_it: int,
                   num_scales: int) -> int:
        """The progressive stage at iteration ``g_it`` (-1: off)."""
        if self.pg <= 0:
            return -1
        if g_it <= wp_it:
            return self.pg0
        if g_it >= max_it * self.pg:
            return num_scales - 1
        delta = num_scales - 1 - self.pg0
        progress = min(max((g_it - wp_it) / (max_it * self.pg - wp_it), 0), 1)
        return self.pg0 + round(progress * delta)


def var_config_pair(
    depth_draft: int = 16,
    depth_target: int = 30,
    patch_nums: Tuple[int, ...] = PATCH_NUMS_256,
    **kw,
) -> Tuple[VARConfig, VARConfig]:
    """Draft/target config pair sharing one tokenizer."""
    draft = VARConfig(depth=depth_draft, patch_nums=patch_nums, **kw)
    target = VARConfig(depth=depth_target, patch_nums=patch_nums, **kw)
    return draft, target
