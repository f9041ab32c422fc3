"""LR / WD annealing schedules and the no-decay keys: a copy of
``sdvar_tpu/train/schedule.py`` (pure functions of the iteration counter,
run on the host).
"""

from __future__ import annotations

import math
from typing import Tuple

NOWD_KEYS = (
    # parameters excluded from weight decay
    "cls_token", "start_token", "task_token", "cfg_uncond",
    "pos_embed", "pos_1LC", "pos_start", "start_pos", "lvl_embed",
    "gamma", "beta",
    "ada_gss", "moe_bias",
    "scale_mul",
)


def lr_wd_annealing(
    sche_type: str, peak_lr: float, wd: float, wd_end: float,
    cur_it: int, wp_it: float, max_it: int,
    wp0: float = 0.005, wpe: float = 0.001,
) -> Tuple[float, float]:
    """Return (lr, wd) at iteration ``cur_it``.

    Schedules: cos, lin, lin0, lin00, lin<T>, exp, piecewise as in the
    JAX package.
    """
    wp_it = round(wp_it)
    if cur_it < wp_it:
        cur_lr = wp0 + (1 - wp0) * cur_it / wp_it
    else:
        pasd = (cur_it - wp_it) / (max_it - 1 - wp_it)
        rest = 1 - pasd
        if sche_type == "cos":
            cur_lr = wpe + (1 - wpe) * (0.5 + 0.5 * math.cos(math.pi * pasd))
        elif sche_type == "lin":
            T = 0.15
            max_rest = 1 - T
            cur_lr = 1.0 if pasd < T else wpe + (1 - wpe) * rest / max_rest
        elif sche_type == "lin0":
            T = 0.05
            max_rest = 1 - T
            cur_lr = 1.0 if pasd < T else wpe + (1 - wpe) * rest / max_rest
        elif sche_type == "lin00":
            cur_lr = wpe + (1 - wpe) * rest
        elif sche_type.startswith("lin"):
            T = float(sche_type[3:])
            max_rest = 1 - T
            wpe_mid = wpe + (1 - wpe) * max_rest
            wpe_mid = (1 + wpe_mid) / 2
            if pasd < T:
                cur_lr = 1 + (wpe_mid - 1) * pasd / T
            else:
                cur_lr = wpe + (wpe_mid - wpe) * rest / max_rest
        elif sche_type == "exp":
            T = 0.15
            max_rest = 1 - T
            if pasd < T:
                cur_lr = 1.0
            else:
                expo = (pasd - T) / max_rest * math.log(wpe)
                cur_lr = math.exp(expo)
        else:
            raise NotImplementedError(f"unknown sche_type {sche_type}")

    cur_lr *= peak_lr
    pasd = cur_it / (max_it - 1)
    cur_wd = wd_end + (wd - wd_end) * (0.5 + 0.5 * math.cos(math.pi * pasd))
    return cur_lr, cur_wd
