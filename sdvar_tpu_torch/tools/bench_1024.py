"""VAR decode at the 1024px preset on the card (the counterpart of the
repository's ``tools/bench_1024.py``): the 14-scale schedule up to 64x64
(L=9451), attention at up to Lq=4096 queries over Lk=9451 keys, at the
d16 width by default. No 1024px checkpoint exists; the weights are random
from fixed seeds, as in the JAX tool.

    python -m sdvar_tpu_torch.tools.bench_1024 [depth] [batch] [modes...]

(default: 16 2 bf16 w8a8-int8kv; the modes of ``bench_512``). Each mode
runs as ``bench_512.run_modes`` does, without the ``generate_images``
call: the latent decode through ``decode_all_scales`` (a first decode at
seed 2, ``repeats`` timed ones, seed 2 again), then the channels-last bf16
pixel decoder on the seed-2 latent, (batch, 3, 1024, 1024). The golden f32
pixel decoder is left out: one of its full-resolution activations is
about 0.7 GB an image.
"""

from __future__ import annotations

import sys

from sdvar_tpu_torch.config import PATCH_NUMS_1024, VARConfig, VQVAEConfig
from sdvar_tpu_torch.tools.bench_512 import run_modes
from sdvar_tpu_torch.utils.device import resolve_device


def run(depth: int = 16, batch: int = 2, modes=("bf16", "w8a8-int8kv"),
        repeats: int = 3, device="cuda") -> dict:
    """VAR-d``depth`` at the 1024px preset in each mode, then the bf16
    pixel decoder at 1024px; returns ``run_modes``' figures."""
    return run_modes("1024", VARConfig(depth=depth, patch_nums=PATCH_NUMS_1024),
                     VQVAEConfig(patch_nums=PATCH_NUMS_1024), batch,
                     tuple(modes), repeats, resolve_device(device),
                     entry=False, pixels=("nhwc-bf16",))


if __name__ == "__main__":
    run(int(sys.argv[1]) if len(sys.argv) > 1 else 16,
        int(sys.argv[2]) if len(sys.argv) > 2 else 2,
        tuple(sys.argv[3:]) or ("bf16", "w8a8-int8kv"))
