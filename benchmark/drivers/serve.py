"""Driver ``serve``: an image API under an open loop, through the port's
``sdvar_tpu_torch.engine.serving.GenerationServer`` (its buckets, batch
limit, wait, KV-cache mode, pixel decoder and delivery from the cell).

The window submits requests on an open-loop schedule with the gaps of a
Poisson process at the cell's fixed rate (``harness/traffic.py``) for
``--seconds`` (uniform labels, one seed a request, all from the run's
seed), whether or not earlier ones have finished, and collects every
``Result`` with ``get``; a request's latency runs from its due time on the
schedule to ``get`` returning its result. A request that fails, or is not
delivered within ``drain_s`` after the window, counts as missing: its
latency is infinite and it is failed. ``latency_p95_ms`` is the 95th
percentile over every request due in the window.
"""

from __future__ import annotations

import gc
import math
import sys
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import cells, gencheck, traffic, weights
from benchmark.harness.trace import Tracer
from benchmark.harness.window import open_loop_latencies, percentile_with_missing
from benchmark.reference import sampler as RS

METRIC = "latency_p95_ms"  # the end-to-end metric of its window, beside setup_s


class Run:
    def __init__(self, cell: Dict, seed: int, device):
        from sdvar_tpu_torch.config import SamplingConfig
        from sdvar_tpu_torch.engine import decode as D
        from sdvar_tpu_torch.engine.serving import GenerationServer

        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.model, self.tr = cell["model"], cell["traffic"]
        self.var_cfg = cells.var_config(self.model)
        self.vae_cfg = cells.vqvae_config(self.model)
        s = self.model["sampling"]
        parts, t = {}, time.time()
        self.var_params = weights.var_params(self.model["var"], seed, self.dev,
                                             torch.bfloat16)
        self.vae_params = weights.vqvae_params(self.model["vqvae"], seed,
                                               self.dev)
        self._sync()
        parts["weights_s"] = time.time() - t
        t = time.time()
        self.rec = gencheck.Recorder(D, self.var_cfg.num_scales,
                                     self.tr["check_batches"], seed)
        self.srv = GenerationServer(
            self.var_cfg, self.vae_cfg, self.var_params, self.vae_params,
            SamplingConfig(cfg=s["cfg"], top_k=s["top_k"], top_p=s["top_p"]),
            max_batch=self.tr["max_batch"], max_wait_ms=self.tr["max_wait_ms"],
            buckets=self.tr["buckets"], kv_mode=self.tr["kv"],
            deliver=self.tr["deliver"], device=self.dev)
        self.srv.start()
        for b in self.tr["buckets"]:   # each bucket's shapes and cache, once
            ids = [self.srv.submit(i % self.var_cfg.num_classes, 7 * i + b)
                   for i in range(b)]
            for rid in ids:
                if not self.srv.get(rid, timeout=600).ok:
                    raise RuntimeError("a warm-up request failed")
        self._sync()
        parts["warmup_s"] = time.time() - t
        self.parts = parts
        self.done: Dict[int, np.ndarray] = {}
        self.failed = 0
        self.attempted = 0

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup_parts(self) -> Dict[str, float]:
        return self.parts

    def _open_loop(self, seconds: float, rate: float = None) -> Dict:
        """Submit on the schedule, collect every result; returns the due
        times, the latencies, the delivery times, the batches, their
        occupancy and how late the generator ran."""
        rate = rate or self.tr["rate"]
        due = traffic.open_loop_arrivals(rate, seconds, self.seed)
        n = len(due)
        self.labels = traffic.uniform_labels(n, self.var_cfg.num_classes,
                                             self.seed)
        self.req_seeds = traffic.request_seeds(n, self.seed)
        rids: List[int] = [-1] * n
        submitted = threading.Semaphore(0)
        late = [0.0]
        stats0 = dict(self.srv.stats)
        t0 = time.perf_counter()

        def submit():
            for i in range(n):
                wait = t0 + due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                late[0] = max(late[0], time.perf_counter() - t0 - due[i])
                rids[i] = self.srv.submit(int(self.labels[i]),
                                          int(self.req_seeds[i]))
                submitted.release()

        th = threading.Thread(target=submit, daemon=True)
        th.start()
        deadline = t0 + seconds + self.tr["drain_s"]
        got: Dict[int, float] = {}
        bad = []
        for i in range(n):
            submitted.acquire()
            try:
                res = self.srv.get(rids[i], timeout=max(
                    deadline - time.perf_counter(), 0.001))
            except TimeoutError:
                bad.append(i)
                continue
            got[i] = time.perf_counter() - t0
            if res.ok:
                self.done[i] = res.image
            else:
                bad.append(i)
        th.join()
        self.attempted, self.failed = n, len(bad)
        st = self.srv.stats
        batches = st["batches"] - stats0["batches"]
        occ = (st["occupancy_sum"] - stats0["occupancy_sum"]) / max(batches, 1)
        return {"due": due, "latencies": open_loop_latencies(due, got, bad),
                "delivered_at": got,
                "late_s": late[0], "batches": batches, "occupancy": occ,
                "elapsed": time.perf_counter() - t0}

    def window(self, seconds: float) -> Dict:
        self.rec.on = True
        got = self._open_loop(seconds)
        self.rec.on = False
        p95 = percentile_with_missing(got["latencies"], 95)
        # a missing request ranks above every delivered one: report the
        # drain deadline, the most the run could have waited, as its value
        if math.isinf(p95):
            p95 = seconds + self.tr["drain_s"]
        print(f"[serve] {self.attempted} due, {self.failed} missing, "
              f"{got['batches']} batches, occupancy {got['occupancy']:.3f}, "
              f"generator late by at most {got['late_s'] * 1e3:.1f} ms",
              file=sys.stderr, flush=True)
        return {"latency_p95_ms": {"value": 1e3 * p95, "unit": "ms"}}

    def traced_window(self) -> Dict:
        tracer = Tracer(self.dev)
        if self.dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.rec.on = True
        tracer.start()
        got = self._open_loop(self.tr["trace_seconds"])
        tr = tracer.stop()
        self.rec.on = False
        return {"trace": tr, "images": len(self.done),
                "occupancy": got["occupancy"],
                "peak_window_bytes": (torch.cuda.max_memory_allocated(self.dev)
                                      if self.dev.type == "cuda" else None)}

    def summary(self) -> Dict[str, int]:
        return {"attempted": self.attempted, "failed": self.failed}

    def release(self) -> None:
        self.srv.stop()
        self.rec.restore()
        self.srv = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self):
        """The delivered requests the check compares: ``check_images`` of
        those in the batches whose logits the recorder kept, drawn from the
        seed; each found in its batch by its scale-0 row seed."""
        want = {}
        for i in self.done:
            rs = RS.row_seeds(torch.tensor([int(self.req_seeds[i])]), 0, 1)
            want[int(rs.item()) - (1 << 32) * (int(rs.item()) >= 1 << 31)] = i
        picks = []
        for b in sorted(self.rec.logits):
            if len(self.rec.logits[b]) < self.var_cfg.num_scales:
                continue
            for row, s in enumerate(self.rec.first_seeds[b].tolist()):
                if s in want:
                    picks.append((b, row, want[s]))
        rng = np.random.default_rng(self.seed & 0xFFFFFFFF)
        take = sorted(rng.choice(len(picks), min(len(picks),
                                                 self.tr["check_images"]),
                                 replace=False).tolist())
        picks = [picks[j] for j in take]
        if not picks:
            raise RuntimeError("no delivered request in a kept batch")
        S = self.var_cfg.num_scales
        ids = [torch.stack([self.rec.batch_ids(b)[si][r] for b, r, _ in picks])
               for si in range(S)]
        logits = [torch.stack([self.rec.logits[b][si][r] for b, r, _ in picks])
                  for si in range(S)]
        imgs = np.stack([self.done[i] for _, _, i in picks])
        return [i for _, _, i in picks], ids, logits, imgs

    def readings(self, control: bool = False) -> Dict[str, float]:
        idx, ids, logits, imgs = self._sample()
        return gencheck.judge(self.model, self.model["sampling"],
                              self.var_params, self.vae_params,
                              [int(self.labels[i]) for i in idx],
                              [int(self.req_seeds[i]) for i in idx], ids,
                              logits, imgs, self.dev, control=control,
                              pixel="mae",
                              var_control=gencheck.var_control(self.tr))

    def check(self):
        self.release()
        got = self.readings()
        lim = self.cell["limits"]
        return [(k, got[k], lim[k]) for k in ("logit_err", "sample_gap",
                                             "pixel_mae")]


def setup(cell: Dict, seed: int, device) -> Run:
    return Run(cell, seed, device)
