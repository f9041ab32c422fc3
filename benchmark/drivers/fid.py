"""Driver ``fid``: bulk class-conditional sampling for FID through the
port's entry point ``sdvar_tpu_torch.sample_fid.sample_batches``.

The window starts ``sample_batches`` over the FID protocol's class-balanced
schedule (``per_class`` images a class, from a class drawn from the seed;
sample i seeded seed0 + i) at the cell's batch, KV-cache mode, weights and
pixel decoder, and consumes the host numpy images it delivers; it ends at
the first delivery at or after ``--seconds``. ``img_per_s`` is the images
delivered over the time from the window's start to the last delivery.

What the decode samples is kept as the decode makes it: a wrapper around
the decode's sampler call holds a reference to each scale's ids, and to
the CFG-mixed logits they were drawn from for a few batches chosen by
reservoir sampling from the seed (no copy, no launch: the timed path is
unchanged). The check hands the reference those images' served tokens
and judges the logits, the ids and the delivered pixels.
"""

from __future__ import annotations

import contextlib
import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import cells, gencheck, traffic, weights
from benchmark.harness.trace import Tracer
from benchmark.harness.window import batch_window, rate


METRIC = "img_per_s"  # the end-to-end metric of its window, beside setup_s


class Run:
    def __init__(self, cell: Dict, seed: int, device):
        from sdvar_tpu_torch.config import SamplingConfig
        from sdvar_tpu_torch.engine import decode as D
        from sdvar_tpu_torch.ops.quantization import quantize_var_params
        from sdvar_tpu_torch import sample_fid

        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.model, self.tr = cell["model"], cell["traffic"]
        self.sample_batches = sample_fid.sample_batches
        self.var_cfg = cells.var_config(self.model)
        self.vae_cfg = cells.vqvae_config(self.model)
        s = self.model["sampling"]
        self.samp = SamplingConfig(cfg=s["cfg"], top_k=s["top_k"],
                                   top_p=s["top_p"])
        self.batch = self.tr["batch"]
        parts, t = {}, time.time()
        self.var_params = weights.var_params(self.model["var"], seed, self.dev,
                                             torch.bfloat16)
        self.vae_params = weights.vqvae_params(self.model["vqvae"], seed,
                                               self.dev)
        self.served = self.var_params
        if self.tr["quant"] != "none":
            self.served = quantize_var_params(self.var_params,
                                              mode=self.tr["quant"])
        self._sync()
        parts["weights_s"] = time.time() - t
        self.rec = gencheck.Recorder(D, self.var_cfg.num_scales,
                                     self.tr["check_batches"], seed)
        t = time.time()
        warm = traffic.balanced_labels(self.tr["warmup_batches"] * self.batch,
                                       self.var_cfg.num_classes,
                                       self.tr["per_class"], seed + 1)
        self._consume(self._batches(warm, 0), None)
        self._sync()
        parts["warmup_s"] = time.time() - t
        self.parts = parts
        self.delivered: List[np.ndarray] = []
        self.labels = None
        self.seed0 = traffic.sample_seed0(seed)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _batches(self, labels, seed0):
        return contextlib.closing(self.sample_batches(
            self.var_cfg, self.vae_cfg, self.served, self.vae_params, labels,
            self.batch, self.samp, kv_mode=self.tr["kv"], seed0=seed0,
            log_every=0, pixels=self.tr["pixels"], device=self.dev))

    @staticmethod
    def _consume(batches, seconds, on_batch=None):
        with batches as it:
            if seconds is None:
                for b in it:
                    if on_batch is not None:
                        on_batch(b)
                return None
            return batch_window(it, seconds, on_batch=on_batch)

    def setup_parts(self) -> Dict[str, float]:
        return self.parts

    def _schedule(self, num: int) -> np.ndarray:
        return traffic.balanced_labels(num, self.var_cfg.num_classes,
                                       self.tr["per_class"], self.seed)

    def window(self, seconds: float) -> Dict:
        self.labels = self._schedule(self.tr["schedule"])
        self.rec.on = True
        got = self._consume(self._batches(self.labels, self.seed0), seconds,
                            self.delivered.append)
        self.rec.on = False
        self._sync()
        self.done = got["units"]
        return {"img_per_s": {"value": rate(got["units"], got["elapsed"]),
                              "unit": "img/s"}}

    def traced_window(self) -> Dict:
        n = self.tr["trace_batches"] * self.batch
        self.labels = self._schedule(n)
        tracer = Tracer(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.rec.on = True
        tracer.start()
        self._consume(self._batches(self.labels, self.seed0), None,
                      self.delivered.append)
        tr = tracer.stop()
        self.rec.on = False
        self.done = sum(len(b) for b in self.delivered)
        return {"trace": tr, "images": self.done, "batch": self.batch,
                "kv": self.tr["kv"],
                "peak_window_bytes": (torch.cuda.max_memory_allocated(self.dev)
                                      if self.dev.type == "cuda" else None)}

    def summary(self) -> Dict[str, int]:
        return {"attempted": self.done, "failed": 0}

    def _sample(self):
        """The images the check compares: ``check_images`` of the delivered
        batches whose logits the recorder kept, rows drawn from the seed;
        with their labels, seeds, served ids, logits and pixels."""
        full = self.done // self.batch
        kept = sorted(b for b in self.rec.logits if b < full)
        if not kept:
            raise RuntimeError("no delivered batch was kept for the check")
        per = -(-self.tr["check_images"] // len(kept))
        rng = random.Random(self.seed + 1)
        picks = [(b, r) for b in kept
                 for r in sorted(rng.sample(range(self.batch), per))]
        scales = self.var_cfg.num_scales
        ids = [torch.stack([self.rec.batch_ids(b)[si][r] for b, r in picks])
               for si in range(scales)]
        logits = [torch.stack([self.rec.logits[b][si][r] for b, r in picks])
                  for si in range(scales)]
        imgs = np.stack([self.delivered[b][r] for b, r in picks])
        idx = [b * self.batch + r for b, r in picks]
        return idx, ids, logits, imgs

    def readings(self, control: bool = False) -> Dict[str, float]:
        idx, ids, logits, imgs = self._sample()
        return gencheck.judge(self.model, self.model["sampling"],
                              self.var_params, self.vae_params,
                              [int(self.labels[i]) for i in idx],
                              [self.seed0 + i for i in idx], ids, logits,
                              imgs, self.dev, control=control,
                              var_control=gencheck.var_control(self.tr))

    def release(self) -> None:
        """Free the program's state (the served weights and the decode's
        caches), once the window has closed."""
        self.rec.restore()
        self.served = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        self.release()
        got = self.readings()
        lim = self.cell["limits"]
        return [(k, got[k], lim[k]) for k in ("logit_err", "sample_gap",
                                             "pixel_err")]


def setup(cell: Dict, seed: int, device) -> Run:
    return Run(cell, seed, device)
