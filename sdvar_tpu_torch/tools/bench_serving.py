"""Continuous-batching serving throughput on the card (the counterpart of
the repository's ``tools/bench_serving.py``).

Requests with distinct labels and seeds go into ``GenerationServer``; it
measures delivered images per second with the pixel decode included
(``bench``'s figure is the latent decode alone), latency percentiles and
bucket occupancy, after a warm-up of two full buckets in turn.

    python -m sdvar_tpu_torch.tools.bench_serving [depth] [n_requests] \\
        [max_batch] [mode]

Modes (VAR-d``depth`` 256px, random weights from fixed seeds, bucket =
``max_batch``):
  bf16          bf16 weights and KV cache, channels-last bf16 pixels
  w8a8-int8kv   W8A8 weights + INT8 KV cache (the default)
  spec          draft VAR-d16 + target, both W8A8 + INT8 KV, gamma 3: with
                random weights every window is rejected, the acceptance
                floor
  spec-accept   the same with ``force_accept_all``: the ceiling
  pixq          W8A8 + INT8 KV with the W8A8 pixel decoder calibrated on two
                B=8 decodes (alpha 0.75, min_w 256)
  mesh          W8A8 + INT8 KV on a MeshConfig(data=1, model=world size)
                mesh server: 1x1 in one process, as the JAX tool is on one
                chip; 1x2 under ``torchrun --nproc_per_node 2`` (every rank
                runs the same requests and prints its own figures)
A "-u8" suffix on any mode delivers uint8 images (a quarter of the bytes).

    torchrun --nproc_per_node 2 -m sdvar_tpu_torch.tools.bench_serving \
        30 32 16 mesh-u8
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from sdvar_tpu_torch.config import (
    MeshConfig,
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.engine.serving import GenerationServer
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import calibrate_decoder_w8a8, init_vqvae_params
from sdvar_tpu_torch.ops.quantization import quantize_var_params
from sdvar_tpu_torch.parallel import distributed

MODES = ("bf16", "w8a8-int8kv", "spec", "spec-accept", "pixq", "mesh")
SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)


def run(depth: int = 30, n_req: int = 96, max_batch: int = 16,
        mode: str = "w8a8-int8kv", device="cuda") -> dict:
    """Serve ``n_req`` requests submitted at once after the warm-up; print
    and return delivered img/s, latency p50/p95/max (ms), occupancy,
    batches and, in the spec modes, the ``spec_*`` counters per batch."""
    deliver = "f32"
    if mode.endswith("-u8"):
        deliver, mode = "u8", mode[:-3]
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} ({' | '.join(MODES)}, each with -u8)")
    var_cfg, vae_cfg = VARConfig(depth=depth), VQVAEConfig()
    print(f"[serve] VAR-d{depth} {mode} deliver={deliver} max_batch={max_batch}",
          flush=True)
    t0 = time.time()
    params = init_var_params(var_cfg, seed=0, device=device, dtype=torch.bfloat16)
    vae = init_vqvae_params(vae_cfg, seed=1, device=device)
    kv_mode, extra = "bf16", {}
    if mode != "bf16":
        params, kv_mode = quantize_var_params(params, mode="w8a8"), "int8"
    if mode.startswith("spec"):
        draft_cfg = VARConfig(depth=16)
        extra = dict(
            draft_cfg=draft_cfg,
            draft_params=quantize_var_params(init_var_params(
                draft_cfg, seed=7, device=device, dtype=torch.bfloat16),
                mode="w8a8"),
            spec=SpeculativeConfig(gamma=3, force_accept_all=mode == "spec-accept"))
    elif mode == "mesh":
        extra = dict(mesh_cfg=MeshConfig(
            data=1, model=distributed.get_world_size()))
    elif mode == "pixq":
        cal = [decode_all_scales(var_cfg, vae_cfg, params, vae["quant"],
                                 torch.arange(8) + 100 * i, 40 + i, SAMP,
                                 kv_mode="int8", device=device) for i in range(2)]
        sites = calibrate_decoder_w8a8(vae_cfg, vae, cal, alpha=0.75, min_w=256)
        extra = dict(pixel_sites=sites)
        print(f"[serve] calibrated pixel sites: "
              f"{sum(s is not None for s in sites)} of {len(sites)} quantized",
              flush=True)
    print(f"[serve] init {time.time() - t0:.1f} s", flush=True)

    srv = GenerationServer(var_cfg, vae_cfg, params, vae, samp=SAMP,
                           max_batch=max_batch, buckets=[max_batch],
                           max_wait_ms=20.0, dtype=torch.bfloat16,
                           kv_mode=kv_mode, deliver=deliver, device=device,
                           **extra)
    srv.start()
    try:
        def serve(requests):
            rids = [srv.submit(label=lab, seed=seed) for lab, seed in requests]
            results = [srv.get(rid, timeout=1200) for rid in rids]
            for r in results:
                if not r.ok:
                    raise RuntimeError(f"request {r.id} failed: {r.error}")
            return results

        t0 = time.time()
        for round_ in range(2):  # two full buckets, one after the other
            serve([(i % 1000, round_ * 1000 + i) for i in range(max_batch)])
        print(f"[serve] warm-up (2 batches): {time.time() - t0:.1f} s", flush=True)
        b0, occ0 = srv.stats["batches"], srv.stats["occupancy_sum"]
        spec0 = {k: v for k, v in srv.stats.items() if k.startswith("spec_")}
        t0 = time.time()
        results = serve([((i * 7) % 1000, 10_000 + i) for i in range(n_req)])
        wall = time.time() - t0
    finally:
        srv.stop()

    lat = np.sort([r.latency_s for r in results]) * 1e3
    nb = max(srv.stats["batches"] - b0, 1)
    out = {"mode": mode, "deliver": deliver, "requests": n_req, "wall_s": wall,
           "img_per_s": n_req / wall, "p50_ms": float(lat[len(lat) // 2]),
           "p95_ms": float(lat[int(len(lat) * 0.95)]), "max_ms": float(lat[-1]),
           "occupancy": (srv.stats["occupancy_sum"] - occ0) / nb, "batches": nb}
    print(f"[serve] d{depth} {mode} (deliver={deliver}): {n_req} images in "
          f"{wall:.3f} s = {out['img_per_s']:.2f} img/s end to end (pixel "
          f"decode included)", flush=True)
    print(f"[serve] latency p50 {out['p50_ms']:.1f} ms p95 {out['p95_ms']:.1f} "
          f"ms max {out['max_ms']:.1f} ms; occupancy {out['occupancy']:.3f}, "
          f"{nb} batches", flush=True)
    if mode.startswith("spec"):
        for k, v in srv.stats.items():
            if k.startswith("spec_"):
                out[k + "_per_batch"] = (v - spec0.get(k, 0)) / nb
        print("[serve] spec stats per batch: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out.items() if k.startswith("spec_")),
            flush=True)
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    distributed.initialize()  # a no-op outside torchrun
    try:
        run(int(argv[0]) if len(argv) > 0 else 30,
            int(argv[1]) if len(argv) > 1 else 96,
            int(argv[2]) if len(argv) > 2 else 16,
            argv[3] if len(argv) > 3 else "w8a8-int8kv",
            device=distributed.rank_device() if torch.cuda.is_available()
            else "cuda")
    finally:
        distributed.shutdown()
