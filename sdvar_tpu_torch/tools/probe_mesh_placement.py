"""The mesh's own cost on one card: the same W8A8 + INT8-KV VAR-d30 256px
B=16 latent decode with plain parameters, then with a 1x1 mesh registered
and the parameters cut by ``shard_tree`` (what the server's mesh mode does
on one card). A 1x1 mesh must be a no-op: the two runs launch the same
kernels the same number of times and give the same bits, and any gap in
time is the mesh's bookkeeping. The counterpart of the repository's
``tools/probe_mesh_placement.py``.

    python3 -m sdvar_tpu_torch.tools.probe_mesh_placement

Prints, per run, the best of 4 latent decodes after a warm-up (every run
printed) and the launches of one decode per kernel; raises when the
launches or the bits differ. Needs a CUDA card; random weights from a seed.
"""

from __future__ import annotations

import time

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.kernels.attention import attention_kernel
from sdvar_tpu_torch.ops.kernels.matmul_int8 import int8_matmul_kernel
from sdvar_tpu_torch.ops.kernels.quantize import act_quantize_kernel
from sdvar_tpu_torch.ops.kernels.sampling import sample_kernel
from sdvar_tpu_torch.ops.partition import set_tp_mesh
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.parallel.mesh import shard_tree, single_device_mesh, var_param_specs

B = 16
SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)
COUNTED = {"attention_int8": (attention_kernel, "launches_int8"),
           "attention": (attention_kernel, "launches"),
           "act_quantize": (act_quantize_kernel, "launches"),
           "int8_matmul": (int8_matmul_kernel, "launches"),
           "sampler": (sample_kernel, "launches")}


def _launches():
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTED.items()}


def run(depth: int = 30, device="cuda") -> dict:
    var_cfg, vae_cfg = VARConfig(depth=depth), VQVAEConfig()
    params = quantize_var_params(init_var_params(
        var_cfg, seed=0, device=device, dtype=torch.bfloat16), mode="w8a8")
    quant = init_vqvae_params(vae_cfg, seed=1, device=device, eini=1.0)["quant"]
    labels = torch.arange(B) * 37 % 1000

    def decode(p):
        return decode_all_scales(var_cfg, vae_cfg, p, quant, labels, 0, SAMP,
                                 return_ids=True, kv_mode="int8", device=device)

    out = {}
    for tag in ("plain", "mesh1x1"):
        p = params
        if tag == "mesh1x1":
            mesh = single_device_mesh()
            set_tp_mesh(mesh)
            p = shard_tree(params, var_param_specs(var_cfg, mesh), mesh)
        try:
            decode(p)  # warm-up
            before = _launches()
            f_hat, ids = decode(p)
            counts = {k: v - before[k] for k, v in _launches().items()}
            times = []
            for _ in range(4):
                torch.cuda.synchronize()
                t0 = time.time()
                decode(p)
                torch.cuda.synchronize()
                times.append((time.time() - t0) * 1e3)
        finally:
            set_tp_mesh(None)
        out[tag] = {"best_ms": min(times), "runs_ms": times,
                    "launches": counts, "f_hat": f_hat, "ids": ids}
        print(f"[probe] {tag}: W8A8 + INT8 KV d{depth} B={B} latent best "
              f"{min(times):.1f} ms (runs {', '.join(f'{t:.1f}' for t in times)}"
              f"); launches per decode {counts}", flush=True)
    a, b = out["plain"], out["mesh1x1"]
    if a["launches"] != b["launches"]:
        raise AssertionError(f"a 1x1 mesh changed the launches: "
                             f"{a['launches']} vs {b['launches']}")
    if not (torch.equal(a["ids"], b["ids"]) and torch.equal(a["f_hat"], b["f_hat"])):
        raise AssertionError("a 1x1 mesh changed the decode's bits")
    print(f"[probe] same launches and bits; mesh1x1 / plain latent "
          f"{b['best_ms'] / a['best_ms']:.3f}", flush=True)
    return out


if __name__ == "__main__":
    run()
