"""Continuous batching of image-generation requests (the counterpart of
``sdvar_tpu/engine/serving.py``).

A scheduler thread coalesces requests that arrive asynchronously into
batches of a fixed bucket size, runs the KV-cached decode on each (one
reused KV cache per bucket) and the pixel decoder, and enqueues the images'
copy to pinned host memory; a delivery thread waits for that copy alone and
hands each request its ``Result``. So batch N's copy and delivery overlap
batch N+1's decode, which the scheduler has already queued on the card.

Determinism: each request carries its own seed, and the decode's sampling
noise for a row depends only on (seed, scale, token), so a request's image
is a function of (label, seed, sampling config), whichever batch of a
bucket size it lands in (the channels-last pixel decoders run their
narrow convs one image per call for this: ``models.vqvae.PER_IMAGE_MAX_W``).
Padding slots run label 0 with seed 0 and are dropped.

Pixel decoders: a bf16 server decodes pixels with the channels-last bf16
decoder, or, given calibrated ``pixel_sites``, the W8A8 one
(``models.vqvae.calibrate_decoder_w8a8``); an f32 server keeps the golden
f32 NCHW decoder.

Speculative mode (``draft_cfg``, ``draft_params``, optional ``spec``): each
batch runs ``SpeculativeEngine.generate_speculative`` on the server's model
as the target, with the batch's per-request seeds, and adds its counters to
``stats`` (``spec_target_calls``, ``spec_draft_calls``,
``spec_accept_count``, ``spec_reject_count``, ``spec_forced_accepts``). Its
acceptance is batch-global, so there a request's image may depend on its
batch companions.

Mesh mode (``mesh_cfg``, one server per rank of a joined process group,
``parallel.distributed.initialize``): each rank cuts its shard of the
parameters (``parallel.mesh.shard_tree``) and registers the mesh. It is
SPMD: every rank is handed the same request stream, rank 0 forms each
batch and broadcasts its request ids, so every rank runs the same batches;
each data group decodes its slice of the batch, and each rank delivers
the requests whose rows it holds, so every request is delivered once per
data group (query a request on a rank that holds its slot:
slot // (bucket / data) == the rank's data index).

Spans (``utils.profiling``), a batch's with its ``batch`` number:
``sdvar.serve.coalesce`` (the first request taken until the batch closes),
``sdvar.serve.dispatch`` (the decode, the pixels ``sdvar.pixels`` and the
queued copy), ``sdvar.serve.handoff`` (blocked on the delivery queue),
``sdvar.serve.device`` (the delivery thread waiting for the batch's copy),
``sdvar.serve.deliver`` (the host copy and the results posted); and a
request's ``sdvar.serve.queue``, from its submit to its batch's dispatch,
with its ``rid`` and ``batch``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from sdvar_tpu_torch.config import (
    MeshConfig,
    SamplingConfig,
    SpeculativeConfig,
    VARConfig,
    VQVAEConfig,
)
from sdvar_tpu_torch.engine import decode as D
from sdvar_tpu_torch.engine.speculative import SpeculativeEngine
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import KVCache
from sdvar_tpu_torch.ops.partition import data_rows, get_tp_mesh, set_tp_mesh
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache
from sdvar_tpu_torch.parallel import distributed as DIST
from sdvar_tpu_torch.parallel.mesh import (
    create_mesh,
    shard_tree,
    var_param_specs,
)
from sdvar_tpu_torch.utils.device import resolve_device
from sdvar_tpu_torch.utils.profiling import mark, span


# what rank 0 broadcasts after each poll of a mesh server's queue
_IDLE, _BATCH, _STOP = 0, 1, 2

# SpecStats counters a speculative server adds up in ``stats["spec_*"]``
SPEC_STATS = ("target_calls", "draft_calls", "accept_count", "reject_count",
              "forced_accepts")


@dataclass
class Request:
    label: int
    seed: int
    id: int = -1
    submit_t: float = field(default_factory=time.perf_counter)


@dataclass
class Result:
    id: int
    image: Optional[np.ndarray]  # (3, H, W) f32 in [0, 1] or uint8; None on failure
    latency_s: float             # submit to delivery, on time.perf_counter
    batch_size: int
    error: Optional[str] = None  # failure payload (exception type: message)

    @property
    def ok(self) -> bool:
        return self.error is None


class GenerationServer:
    """Host-side continuous-batching scheduler over the decode.

    Usage:
        srv = GenerationServer(var_cfg, vae_cfg, var_params, vae_params)
        srv.start()
        rid = srv.submit(label=207, seed=42)
        result = srv.get(rid, timeout=60)
        srv.stop()
    """

    def __init__(
        self,
        var_cfg: VARConfig, vae_cfg: VQVAEConfig,
        var_params, vae_params,
        samp: SamplingConfig = SamplingConfig(),
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        buckets: Optional[List[int]] = None,
        dtype=torch.bfloat16,
        kv_mode: str = "bf16",
        draft_cfg: Optional[VARConfig] = None,
        draft_params=None,
        spec=None,
        mesh_cfg=None,
        pixel_sites=None,
        deliver: str = "f32",
        device="cuda",
    ):
        if (draft_cfg is None) != (draft_params is None) or (
                spec is not None and draft_cfg is None):
            raise ValueError("speculative mode needs draft_cfg and "
                             "draft_params (and takes spec only with them)")
        if mesh_cfg is not None and not isinstance(mesh_cfg, MeshConfig):
            raise ValueError(f"mesh_cfg {mesh_cfg!r} is not a MeshConfig")
        if deliver not in ("f32", "u8"):
            raise ValueError(f"deliver={deliver!r} (f32 | u8)")
        if dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"dtype {dtype} (bfloat16 | float32)")
        if pixel_sites is not None and dtype != torch.bfloat16:
            raise ValueError("pixel_sites need a bf16 server: an f32 server "
                             "decodes pixels with the f32 golden decoder")
        self.buckets = sorted(buckets or [1, 2, 4, 8])
        if max_batch > self.buckets[-1]:
            raise ValueError(f"max_batch {max_batch} exceeds the largest "
                             f"bucket {self.buckets[-1]}")
        self.device = resolve_device(device)
        # mesh mode: this rank's shards, the mesh registered for the model
        self.mesh = None
        if mesh_cfg is not None:
            if any(b % mesh_cfg.data for b in self.buckets):
                raise ValueError(f"buckets {self.buckets} do not divide over "
                                 f"data={mesh_cfg.data}")
            self.mesh = create_mesh(mesh_cfg)
            var_params = shard_tree(
                var_params, var_param_specs(var_cfg, self.mesh), self.mesh)
            if draft_cfg is not None:
                draft_params = shard_tree(
                    draft_params, var_param_specs(draft_cfg, self.mesh),
                    self.mesh)
            set_tp_mesh(self.mesh)
        self._spmd = self.mesh is not None and DIST.get_world_size() > 1
        self.var_cfg, self.vae_cfg = var_cfg, vae_cfg
        self.var_params, self.vae_params = var_params, vae_params
        self.samp = samp
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.dtype = dtype
        self.kv_mode = kv_mode
        self.pixel_sites = None if pixel_sites is None else tuple(pixel_sites)
        # "f32": Result.image is (3, H, W) f32 in [0, 1]; "u8": quantized on
        # the device, (3, H, W) uint8, a quarter of the bytes to copy
        self.deliver = deliver
        # speculative mode: a draft/target pair behind the same scheduler
        self.spec = self.engine = None
        if draft_cfg is not None:
            self.spec = spec or SpeculativeConfig()
            self.engine = SpeculativeEngine(
                vae_cfg, draft_cfg, var_cfg, vae_params, draft_params,
                var_params, dtype=dtype, kv_mode=kv_mode, mesh=self.mesh,
                device=self.device)

        self._caches: Dict[int, object] = {}  # per-bucket reused KV caches
        self._q: "queue.Queue[Request]" = queue.Queue()
        self._results: Dict[int, Result] = {}
        self._results_cv = threading.Condition()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._pending: Dict[int, Request] = {}  # a mesh rank's, by id
        self._stop = threading.Event()
        self._deliver_stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # bounded, so that a slow host cannot pile up batches in flight
        self._deliver_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._deliver_thread: Optional[threading.Thread] = None
        self.stats = {"completed": 0, "batches": 0, "occupancy_sum": 0.0}
        # updated from both threads
        self._stats_lock = threading.Lock()
        self._batches_formed = 0  # the scheduler thread's batch numbers

    # -- public API ---------------------------------------------------------

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._deliver_thread = threading.Thread(target=self._deliver_loop,
                                                daemon=True)
        self._thread.start()
        self._deliver_thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # the delivery loop drains every queued batch before it exits; a
        # thread wedged on the card is abandoned by the bounded join
        self._deliver_stop.set()
        if self._deliver_thread is not None:
            self._deliver_thread.join(timeout=30)
        if self.mesh is not None and get_tp_mesh() is self.mesh:
            set_tp_mesh(None)

    def submit(self, label: int, seed: int) -> int:
        with self._id_lock:
            rid = self._next_id
            self._next_id += 1
        self._q.put(Request(label=label, seed=seed, id=rid))
        return rid

    def get(self, rid: int, timeout: float = 120.0) -> Result:
        deadline = time.time() + timeout
        with self._results_cv:
            while rid not in self._results:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"request {rid}")
                self._results_cv.wait(remaining)
            return self._results.pop(rid)

    # -- scheduler ----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _collect(self) -> List[Request]:
        try:
            first = self._q.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        with span("sdvar.serve.coalesce", batch=self._batches_formed):
            deadline = time.time() + self.max_wait
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=remaining))
                except queue.Empty:
                    break
        return batch

    def _agree(self) -> Optional[List[Request]]:
        """A mesh server's next batch, the same on every rank: rank 0 polls
        its queue and broadcasts the outcome (idle, the batch's request
        ids, or stop) over the host group; the other ranks take the named
        requests from their own queues. None: stop."""
        msg = torch.zeros(2 + self.max_batch, dtype=torch.int64)
        batch: List[Request] = []
        if DIST.get_rank() == 0:
            if self._stop.is_set():
                msg[0] = _STOP
            else:
                batch = self._collect()
                if batch:
                    msg[0], msg[1] = _BATCH, len(batch)
                    msg[2:2 + len(batch)] = torch.tensor([r.id for r in batch])
        dist.broadcast(msg, src=0, group=DIST.host_group())
        if msg[0] == _STOP:
            return None
        if msg[0] == _IDLE or DIST.get_rank() == 0:
            return batch
        return [self._take(rid) for rid in msg[2:2 + int(msg[1])].tolist()]

    def _take(self, rid: int, timeout: float = 60.0) -> Request:
        """Request ``rid`` of this rank's stream, waiting for its submit."""
        deadline = time.time() + timeout
        while rid not in self._pending:
            try:
                r = self._q.get(timeout=max(deadline - time.time(), 0.01))
            except queue.Empty:
                raise RuntimeError(f"request {rid} of rank 0's batch was not "
                                   f"submitted on rank {DIST.get_rank()}"
                                   ) from None
            self._pending[r.id] = r
        return self._pending.pop(rid)

    def _cache(self, bsz: int):
        """The bucket's KV cache (2 * bsz rows under CFG), made on first
        use; the scheduler thread holds the only reference while a batch
        runs."""
        cache = self._caches.pop(bsz, None)
        if cache is not None:
            return cache
        if self.kv_mode == "int8":
            return QuantizedKVCache.create(self.var_cfg, 2 * bsz, device=self.device)
        return KVCache.create(self.var_cfg, 2 * bsz, dtype=self.dtype,
                              device=self.device)

    def _pixels(self, f_hat: torch.Tensor) -> torch.Tensor:
        if self.pixel_sites is not None:
            return VQ.fhat_to_img_nhwc_w8a8_static(
                self.vae_cfg, self.vae_params, f_hat, self.pixel_sites)
        if self.dtype == torch.bfloat16:
            return VQ.fhat_to_img_nhwc(self.vae_cfg, self.vae_params, f_hat)
        return VQ.fhat_to_img(self.vae_cfg, self.vae_params, f_hat)

    def _run_batch(self, batch: List[Request]):
        bid = self._batches_formed
        self._batches_formed += 1
        begin = time.perf_counter_ns()
        for r in batch:
            mark("sdvar.serve.queue", int(r.submit_t * 1e9), begin, rid=r.id,
                 batch=bid)
        with span("sdvar.serve.dispatch", batch=bid):
            item = self._dispatch(batch)
        with span("sdvar.serve.handoff", batch=bid):
            self._deliver_q.put(item + (bid,))

    @torch.inference_mode()
    def _dispatch(self, batch: List[Request]):
        """Queue the batch's decode, pixels and copy on the card; returns
        what the delivery thread needs."""
        bsz = self._bucket_for(len(batch))
        labels = torch.zeros(bsz, dtype=torch.long)
        seeds = torch.zeros(bsz, dtype=torch.long)
        for i, r in enumerate(batch):
            labels[i] = r.label
            seeds[i] = r.seed & 0xFFFFFFFF
        if self.engine is not None:
            f_hat, st = self.engine.generate_speculative(
                labels.to(self.device), seeds.to(self.device), self.spec,
                self.samp)
            with self._stats_lock:
                for k in SPEC_STATS:
                    self.stats["spec_" + k] = (self.stats.get("spec_" + k, 0)
                                               + getattr(st, k))
        else:
            f_hat, cache = D.decode_all_scales(
                self.var_cfg, self.vae_cfg, self.var_params,
                self.vae_params["quant"], labels.to(self.device),
                seeds.to(self.device), self.samp, self.dtype,
                kv_mode=self.kv_mode, cache=self._cache(bsz),
                return_cache=True, device=self.device)
            self._caches[bsz] = cache
        with span("sdvar.pixels"):
            imgs = (self._pixels(f_hat) + 1.0) * 0.5
        if self.deliver == "u8":
            imgs = torch.clamp(imgs * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
        lo = data_rows(bsz).start  # the slot of this rank's first row
        done = None
        if imgs.is_cuda:
            # queue the copy behind this batch's work now and mark its end:
            # the delivery thread waits for this event only, not for the
            # next batch's decode that this thread queues meanwhile
            host = torch.empty(imgs.shape, dtype=imgs.dtype, pin_memory=True)
            host.copy_(imgs, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            imgs = host
        return batch, imgs, done, bsz, lo

    def _deliver(self, batch: List[Request], imgs: torch.Tensor, done, bsz: int,
                 lo: int, bid: int):
        """Hand out the images of the batch's slots [lo, lo + len(imgs)),
        the rows this rank holds (all of them without a mesh)."""
        if done is not None:
            with span("sdvar.serve.device", batch=bid):
                done.synchronize()  # a fault of the batch's device work raises here
        with span("sdvar.serve.deliver", batch=bid):
            arr = imgs.numpy().copy()  # the pinned buffer goes back to its pool
            now = time.perf_counter()
            mine = batch[lo:lo + arr.shape[0]]
            with self._results_cv:
                for i, r in enumerate(mine):
                    self._results[r.id] = Result(
                        id=r.id, image=arr[i], latency_s=now - r.submit_t,
                        batch_size=bsz)
                self._results_cv.notify_all()
            with self._stats_lock:
                self.stats["completed"] += len(mine)
                self.stats["batches"] += 1
                self.stats["occupancy_sum"] += len(batch) / bsz

    def _fail(self, batch: List[Request], err: str):
        now = time.perf_counter()
        with self._results_cv:
            for r in batch:
                self._results[r.id] = Result(
                    id=r.id, image=None, latency_s=now - r.submit_t,
                    batch_size=0, error=err)
            self._results_cv.notify_all()
        with self._stats_lock:
            self.stats["failed"] = self.stats.get("failed", 0) + len(batch)
        print(f"[serving] batch failed: {err}", flush=True)

    def _deliver_loop(self):
        while True:
            try:
                item = self._deliver_q.get(timeout=0.25)
            except queue.Empty:
                if self._deliver_stop.is_set():
                    return  # drained and told to stop
                continue
            batch = item[0]
            try:
                self._deliver(*item)
            except Exception as e:  # a device fault surfaces at the sync
                self._fail(batch, f"{type(e).__name__}: {e}")

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # a new thread starts on cuda:0
        while True:
            if self._spmd:
                batch = self._agree()
                if batch is None:
                    return
            elif self._stop.is_set():
                return
            else:
                batch = self._collect()
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except Exception as e:  # deliver the error payload to waiters
                self._fail(batch, f"{type(e).__name__}: {e}")
