"""The decode's CUDA graphs on the card: what a shape's capture costs and
what its replays save (``engine/decode.py``: ``ScaleGraphs``).

    python -m sdvar_tpu_torch.tools.probe_decode_graphs [mode] [batches]

``mode``: ``bf16`` (bf16 weights and KV cache, the default) or ``w8a8``
(W8A8 weights, INT8 KV cache); ``batches``: comma-separated batch sizes,
default 32. VAR-d30 256px, random weights. In one process, for each batch
size in turn: the first decode into a new cache, which captures the
shape's graphs, under ``torch.profiler`` (each capture's seconds, and
within them the end of the capture and the instantiation, from the
decode's ``sdvar.decode.capture`` and ``sdvar.decode.instantiate`` spans;
the profiler's ranges slow the capture's Python somewhat),
then three graphed decodes and three eager ones (no cache passed) in
turns, each synchronised; the graphed decodes' ids and f_hat must equal
the eager decode's of the same labels and seeds. Then three graphed
decodes under the profiler: each scale's mean host and device ms (its
``sdvar.decode.scale`` span). Prints a line a batch size and a JSON line
at the end, with the process's resident host memory.
"""

from __future__ import annotations

import json
import sys
import time

import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.models.var import KVCache, init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache, quantize_var_params
from sdvar_tpu_torch.utils import profiling
from sdvar_tpu_torch.utils.device import card_name, resolve_device

SAMP = SamplingConfig(cfg=1.5, top_k=900, top_p=0.96)


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` -> (its result, the spans it
    recorded)."""
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, profiling.spans()


def _host_rss_gib() -> dict:
    """The process's resident host memory, now and at its peak (Linux)."""
    got = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key in ("VmRSS", "VmHWM"):
                    got[key] = int(val.split()[0]) / 2 ** 20
    except OSError:
        pass
    return got


def run(mode: str = "bf16", batches=(32,), device="cuda") -> dict:
    if mode not in ("bf16", "w8a8"):
        raise ValueError(f"unknown mode {mode!r} (bf16 | w8a8)")
    dev = resolve_device(device)
    var_cfg, vae_cfg = VARConfig(depth=30), VQVAEConfig()
    params = init_var_params(var_cfg, seed=0, device=dev, dtype=torch.bfloat16)
    if mode == "w8a8":
        params = quantize_var_params(params, mode="w8a8")
        torch.cuda.empty_cache()
    quant = init_vqvae_params(vae_cfg, seed=1, device=dev, eini=1.0)["quant"]
    kv = "int8" if mode == "w8a8" else "bf16"

    def decode(labels, seed, cache=None):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        out = D.decode_all_scales(var_cfg, vae_cfg, params, quant, labels,
                                  seed, SAMP, return_ids=True, kv_mode=kv,
                                  cache=cache, device=dev)
        torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t

    report = {"card": card_name(dev), "torch": torch.__version__,
              "cuda": torch.version.cuda, "mode": mode, "batches": {}}
    for B in batches:
        cache = (QuantizedKVCache.create(var_cfg, 2 * B, device=dev)
                 if kv == "int8" else KVCache.create(var_cfg, 2 * B, device=dev))
        mem0 = torch.cuda.memory_allocated(dev)
        labels = torch.arange(B) * 37 % 1000
        (_, first_s), recorded = _profiled(lambda: decode(labels, 1, cache))
        caps = [s for s in recorded if s.name == "sdvar.decode.capture"]
        inst = {s.parent: s.host_ms for s in recorded
                if s.name == "sdvar.decode.instantiate"}
        caps = [(c.host_ms / 1e3, inst[c.index] / 1e3) for c in caps]
        graph_mem = torch.cuda.memory_allocated(dev) - mem0
        graphed, eager, equal = [], [], True
        for i in range(3):
            lab = (labels + 101 * (i + 1)) % 1000
            (g, tg), (e, te) = decode(lab, 2 + i, cache), decode(lab, 2 + i)
            graphed.append(tg)
            eager.append(te)
            equal &= all(torch.equal(a, b) for a, b in zip(g, e))
        _, recorded = _profiled(lambda: [
            decode((labels + 7 * i) % 1000, 10 + i, cache) for i in range(3)])
        per_scale = {}
        for s in recorded:
            if s.name == "sdvar.decode.scale":
                per_scale.setdefault(s.ids["si"], []).append(
                    (s.host_ms, s.device_ms))
        row = {"first_decode_s": first_s, "captures": len(caps),
               "capture_s": sum(c[0] for c in caps),
               "instantiate_s": sum(c[1] for c in caps),
               "per_scale_capture_ms": [round(c[0] * 1e3, 2) for c in caps],
               "per_scale_instantiate_ms": [round(c[1] * 1e3, 2) for c in caps],
               "graphed_decode_s": graphed, "eager_decode_s": eager,
               "bit_equal": bool(equal),
               "graph_memory_gib": graph_mem / 2 ** 30,
               "per_scale_host_device_ms": {
                   si: [round(sum(t[j] for t in v) / len(v), 2) for j in (0, 1)]
                   for si, v in sorted(per_scale.items())}}
        report["batches"][B] = row
        print(f"[graphs] d30 {mode} B={B}: first decode {first_s:.3f} s "
              f"({len(caps)} captures {row['capture_s']:.3f} s, of which "
              f"instantiation {row['instantiate_s']:.3f} s); graphed "
              f"{min(graphed) * 1e3:.1f} ms, eager {min(eager) * 1e3:.1f} ms; "
              f"bit-equal {equal}; graphs' memory {row['graph_memory_gib']:.3f} "
              f"GiB ({report['card']})", flush=True)
        if not equal:
            raise AssertionError(f"B={B}: the graphed decode differs from the "
                                 f"eager one")
    report["host_memory_gib"] = _host_rss_gib()
    print(json.dumps(report), flush=True)
    return report


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "bf16"
    batches = tuple(int(b) for b in argv[1].split(",")) if len(argv) > 1 else (32,)
    return run(mode, batches)


if __name__ == "__main__":
    main()
