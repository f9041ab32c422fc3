"""Which f32 products of the VAR-d30 W8A8 decode change their bits when a
mesh splits their columns (1x2: a model rank computes half the outputs) or
their rows (2x1: a data rank computes half the batch), on one card and in
one process. cuBLAS picks its f32 GEMM kernel, and with it the summation
order, by shape, so a column or a row computed in a smaller call may round
otherwise; the port's hand-written kernels tile over outputs and keep
their order. Checked: the AdaLN projection (f32 as cuBLAS sums it, and
f64 rounded once to f32, as ``models/var.py`` computes it), the int8 head
(``int8_matmul``: the CUDA kernel on f32 rows) on two column halves, and the
replicated f32 GEMMs of the head's AdaLN and the word embedding on two row
halves.

    python3 -m sdvar_tpu_torch.tools.probe_split_bits

Prints one line per product: how many elements differ from the unsplit
call. Needs a CUDA card; random weights from a seed, AdaLN biases drawn at
0.3 (as ``chip_smoke.py``'s d30 mesh weights are).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sdvar_tpu_torch.config import VARConfig
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.ops.kernels.matmul_int8 import int8_matmul
from sdvar_tpu_torch.ops.quantization import (
    layer_slice,
    quantize_var_params,
    resolve_weight,
)

B = 16


def _differ(full: torch.Tensor, parts, dim: int) -> int:
    return int((full != torch.cat(parts, dim)).sum().item())


def run(depth: int = 30, device="cuda") -> dict:
    cfg = VARConfig(depth=depth)
    p = init_var_params(cfg, seed=0, device=device, dtype=torch.bfloat16)
    b = p["blocks"]["ada_lin_b"]
    b.copy_(torch.randn(b.shape, device=device, generator=torch.Generator(
        device=device).manual_seed(6)) * 0.3)
    p = quantize_var_params(p, mode="w8a8")
    labels = [i * 61 % 1000 for i in range(B)] + [cfg.num_classes] * B
    cond = p["class_emb"][torch.tensor(labels, device=device)].float()
    c = F.silu(cond)
    n6 = 6 * cfg.embed_dim
    out = {}
    for dtype in (torch.float32, torch.float64):
        cols = rows = 0
        for li in range(cfg.depth):
            w = resolve_weight(layer_slice(p["blocks"]["ada_lin_w"], li), dtype)
            x = c.to(dtype)
            full = (x @ w).float()
            cols += _differ(full, [(x @ w[:, :n6 // 2].contiguous()).float(),
                                   (x @ w[:, n6 // 2:].contiguous()).float()], -1)
            rows += _differ(full, [(x[:B] @ w).float(), (x[B:] @ w).float()], 0)
        out[f"adaln {str(dtype)[6:]}"] = {"column halves": cols,
                                          "row halves": rows,
                                          "of": cfg.depth * 2 * B * n6}
    hw = p["head"]["w"]
    V = hw.q.shape[1]
    x = torch.randn(2 * B * 256, cfg.embed_dim, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    halves = [int8_matmul(x, hw.q[:, s].contiguous(), hw.scale[s].contiguous())
              for s in (slice(0, V // 2), slice(V // 2, V))]
    full = int8_matmul(x, hw.q, hw.scale)
    out["head int8_matmul f32"] = {"column halves": _differ(full, halves, -1),
                                   "of": full.numel()}
    for name, (a, w) in {
            "head AdaLN f32": (c, p["head_nm"]["w"].float()),
            "word embed f32": (torch.randn(2 * B * 256, cfg.Cvae, device=device),
                               p["word_embed"]["w"].float())}.items():
        full = a @ w
        half = a.shape[0] // 2
        out[name] = {"row halves": _differ(full, [a[:half] @ w, a[half:] @ w], 0),
                     "of": full.numel()}
    for name, r in out.items():
        print(f"[split bits] d{depth} {name}: elements differing from the "
              f"unsplit call {r}", flush=True)
    return out


if __name__ == "__main__":
    run()
