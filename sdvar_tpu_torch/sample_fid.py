"""FID sample generation: the reference's evaluation protocol as a CLI (the
counterpart of ``sdvar_tpu/sample_fid.py``). 50,000 class-balanced images
(50 per class) at cfg=1.5, top_p=0.96, top_k=900, packed into an .npz for
the OpenAI guided-diffusion FID toolkit against
``VIRTUAL_imagenet256_labeled.npz``.

The pipeline: batched KV-cached decodes with one reused cache, per-sample
seeds (``seed + index``, so a sample does not depend on its batch), optional
W8A8 or weight-only INT8 weights and an INT8 KV cache, and the images
packed straight into the npz (or also written as PNGs, the reference's
flow). It runs on the card.

    python -m sdvar_tpu_torch.sample_fid --num 50000 --batch 16 --depth 30 \\
        --quant w8a8 --kv int8 --out samples.npz \\
        [--ckpt-var var_d30.pth --ckpt-vae vae_ch160v4096z32.pth]

Without checkpoints the weights are random (made from ``--seed``): that
exercises the pipeline, and its FID means nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import queue
import resource
import threading
import time
import weakref

import numpy as np
import torch

from sdvar_tpu_torch.config import SamplingConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import KVCache, init_var_params
from sdvar_tpu_torch.ops.quantization import QuantizedKVCache, quantize_var_params
from sdvar_tpu_torch.utils.device import resolve_device
from sdvar_tpu_torch.utils.fid import create_npz_from_arrays, save_sample_pngs
from sdvar_tpu_torch.utils.profiling import span
from sdvar_tpu_torch.utils.torch_port import (
    var_params_from_torch,
    vqvae_params_from_torch,
)

_MASK32 = 0xFFFFFFFF


def balanced_labels(num: int, num_classes: int = 1000) -> np.ndarray:
    """Class-balanced label schedule: floor(num / C) per class, the
    remainder on the first classes."""
    per = num // num_classes
    counts = np.full((num_classes,), per, np.int64)
    counts[: num - per * num_classes] += 1
    return np.repeat(np.arange(num_classes, dtype=np.int32), counts)


def _pixel_decoder(pixels: str):
    if pixels == "f32":
        return VQ.fhat_to_img                   # the golden protocol
    if pixels == "f32-nhwc":
        return lambda cfg, p, f: VQ.fhat_to_img_nhwc(cfg, p, f, dtype=torch.float32)
    if pixels == "bf16":
        return VQ.fhat_to_img_nhwc              # the serving decoder
    raise ValueError(f"pixels={pixels!r} (f32 | f32-nhwc | bf16)")


_spare_lock = threading.RLock()  # also taken by a finalizer, on any thread
_spare = None  # the _Spare the last finished call left


class _Spare:
    """The KV cache a finished call made and left, with the CUDA graphs of
    the decode's scales captured against it, for the next call with the
    same configuration, batch, KV mode, dtype and device. It belongs to
    the weights it decoded with: once any of their tensors is freed, it is
    dropped (its memory freed with it)."""

    def __init__(self, key, cache, var_params):
        self.key, self.cache = key, cache
        token = self.token = object()
        self.finalizers = [weakref.finalize(t, _drop_spare, token)
                           for t in _tensors(var_params)]

    def detach(self) -> None:
        for f in self.finalizers:
            f.detach()


def _tensors(tree):
    """A parameter tree's tensors (dicts, lists and the INT8 leaves'
    NamedTuples walked)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _drop_spare(token) -> None:
    global _spare
    with _spare_lock:
        if _spare is not None and _spare.token is token:
            _spare = None


def _take_cache(var_cfg: VARConfig, batch: int, kv_mode: str, dtype, dev):
    """The KV cache of a call that was passed none: the spare, if it has
    this call's configuration, batch, mode, dtype and device, else a new
    one. -> (key, cache)."""
    global _spare
    key = (var_cfg, batch, kv_mode, dtype, dev)
    with _spare_lock:
        spare, _spare = _spare, None
    if spare is not None:
        spare.detach()
        if spare.key == key:
            return key, spare.cache
    del spare  # another shape's: freed before the new one is made
    if kv_mode == "int8":
        return key, QuantizedKVCache.create(var_cfg, 2 * batch, device=dev)
    return key, KVCache.create(var_cfg, 2 * batch, dtype=dtype, device=dev)


def _leave_cache(key, cache, var_params) -> None:
    global _spare
    spare = _Spare(key, cache, var_params)
    with _spare_lock:
        old, _spare = _spare, spare
    if old is not None:
        old.detach()


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Put ``item``, giving up once ``stop`` is set; True if it was put."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            pass
    return False


def sample_batches(var_cfg: VARConfig, vae_cfg: VQVAEConfig, var_params,
                   vae_params, labels, batch: int, samp: SamplingConfig,
                   dtype=torch.bfloat16, kv_mode: str = "bf16", seed0: int = 0,
                   log_every: int = 50, pixels: str = "f32", device="cuda",
                   cache=None):
    """Yield (B, 3, H, W) f32 numpy image batches in [0, 1] covering
    ``labels`` in order (the last batch cut to what is left).

    Two batches in flight: a dispatcher thread queues each batch's decode
    and pixel decode on the card and, behind them, the images' copy into
    pinned host memory with a CUDA event after it; a materializer thread
    waits on that event alone and hands the host array over, so the
    consumer's packing (npz, PNG) overlaps both the next batch's decode and
    this batch's copy. Sample ``i`` runs with seed ``seed0 + i``. An
    exception in either thread is raised to the consumer. Spans a batch
    (``batch``: its offset): ``sdvar.fid.dispatch`` (the decode, the pixel
    decode ``sdvar.pixels`` and the queued copy), ``sdvar.fid.backpressure``
    (the dispatcher blocked on a full queue), ``sdvar.fid.materialize``
    (the wait for the copy's event and the host copy).

    On a card, each batch's decode replays its scales' block stacks from
    CUDA graphs captured against the call's KV cache at its first batch
    (``engine.decode.ScaleGraphs``); the first capture in a process sets
    glibc's malloc top pad to 64 MiB for the whole process
    (``decode._keep_host_heaps``). ``cache``: a KV cache of ``2 * batch``
    rows and ``kv_mode``'s kind that the caller keeps, graphs and all, for
    its next calls. Without one the call takes up the cache that the last
    finished call with the same configuration, batch, KV mode, dtype and
    device left, and leaves its own for the next: so a warm-up call and the
    call after it capture once. That spare belongs to ``var_params``: it
    is freed once any of their tensors is (VAR-d30 at batch 32: 9.34 GiB
    bf16, 4.68 GiB INT8, and the graphs' pool)."""
    dev = resolve_device(device)
    keep = cache is None
    if keep:
        cache_key, cache = _take_cache(var_cfg, batch, kv_mode, dtype, dev)
    to_img = _pixel_decoder(pixels)
    labels = np.asarray(labels, np.int64)
    n = len(labels)
    device_q: "queue.Queue" = queue.Queue(maxsize=2)  # (host, event, keep, done)
    host_q: "queue.Queue" = queue.Queue(maxsize=2)    # (array, done)
    stop = threading.Event()

    @torch.inference_mode()
    def dispatch():
        try:
            run_batches()
        finally:
            if keep:
                _leave_cache(cache_key, cache, var_params)

    def run_batches():
        nonlocal cache
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # a new thread starts on cuda:0
        for off in range(0, n, batch):
            chunk = labels[off:off + batch]
            keep = len(chunk)
            chunk = np.concatenate([chunk, np.zeros(batch - keep, np.int64)])
            seeds = (seed0 + off + torch.arange(batch, dtype=torch.int64)) & _MASK32
            with span("sdvar.fid.dispatch", batch=off):
                f_hat, cache = decode_all_scales(
                    var_cfg, vae_cfg, var_params, vae_params["quant"],
                    torch.from_numpy(chunk), seeds, samp, dtype,
                    kv_mode=kv_mode, cache=cache, return_cache=True,
                    device=dev)
                with span("sdvar.pixels", batch=off):
                    img = (to_img(vae_cfg, vae_params, f_hat) + 1.0) * 0.5
                event = None
                if img.is_cuda:
                    host = torch.empty(img.shape, dtype=img.dtype,
                                       pin_memory=True)
                    host.copy_(img, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    img = host
            with span("sdvar.fid.backpressure", batch=off):
                put = _put(device_q, (img, event, keep, off + keep), stop)
            if not put:
                return
        _put(device_q, None, stop)

    def materialize():
        while not stop.is_set():
            try:
                item = device_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None or isinstance(item, BaseException):
                _put(host_q, item, stop)
                return
            img, event, keep, done = item
            with span("sdvar.fid.materialize", batch=done - keep):
                if event is not None:
                    event.synchronize()  # a fault of the batch's work raises here
                arr = img.numpy()[:keep].copy()
            _put(host_q, (arr, done), stop)

    def guarded(fn, out_q):
        def run():
            try:
                fn()
            except BaseException as e:  # raised again in the consumer
                _put(out_q, e, stop)
        return run

    threads = [threading.Thread(target=guarded(dispatch, device_q), daemon=True),
               threading.Thread(target=guarded(materialize, host_q), daemon=True)]
    for t in threads:
        t.start()
    t0, bi = time.time(), 0
    try:
        while True:
            item = host_q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            img, done = item
            if log_every and bi % log_every == 0:
                print(f"[fid-sample] {done}/{n} "
                      f"({done / max(time.time() - t0, 1e-9):.1f} img/s)",
                      flush=True)
            bi += 1
            yield img
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num", type=int, default=50_000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--depth", type=int, default=30)
    ap.add_argument("--patch-nums", type=str, default="1_2_3_4_5_6_8_10_13_16")
    ap.add_argument("--cfg", type=float, default=1.5)       # FID protocol
    ap.add_argument("--top-k", type=int, default=900)
    ap.add_argument("--top-p", type=float, default=0.96)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", choices=["none", "w8", "w8a8"], default="none")
    ap.add_argument("--kv", choices=["bf16", "int8"], default="bf16")
    ap.add_argument("--pixels", choices=["f32", "f32-nhwc", "bf16"],
                    default="f32",
                    help="pixel decoder: f32 = the golden NCHW decoder (the "
                         "FID protocol); f32-nhwc = channels-last f32; bf16 "
                         "= the channels-last serving decoder (pipeline "
                         "checks; keep f32 for a reported FID)")
    ap.add_argument("--out", type=str, default="sdvar_samples.npz")
    ap.add_argument("--png-dir", type=str, default=None,
                    help="also write PNGs (the reference's flow; needs PIL)")
    ap.add_argument("--ckpt-var", type=str, default=None)
    ap.add_argument("--ckpt-vae", type=str, default=None)
    args = ap.parse_args(argv)
    if bool(args.ckpt_var) != bool(args.ckpt_vae):
        ap.error("--ckpt-var and --ckpt-vae go together")

    pns = tuple(int(p) for p in args.patch_nums.split("_"))
    var_cfg = VARConfig(depth=args.depth, patch_nums=pns)
    vae_cfg = VQVAEConfig(patch_nums=pns)
    samp = SamplingConfig(cfg=args.cfg, top_k=args.top_k, top_p=args.top_p)
    if args.ckpt_var:
        var_params = var_params_from_torch(
            var_cfg, torch.load(args.ckpt_var, map_location="cpu"))
        vae_params = vqvae_params_from_torch(
            vae_cfg, torch.load(args.ckpt_vae, map_location="cpu"))
    else:
        print("[fid-sample] no checkpoints: random weights (a pipeline "
              "exercise; FID numbers meaningless)", flush=True)
        var_params = init_var_params(var_cfg, seed=args.seed, dtype=torch.bfloat16)
        vae_params = VQ.init_vqvae_params(vae_cfg, seed=args.seed + 1, eini=1.0)
    if args.quant != "none":
        var_params = quantize_var_params(var_params, mode=args.quant)

    def tee(batches):
        idx = 0
        for b in batches:
            save_sample_pngs(b, args.png_dir, start_idx=idx)
            idx += b.shape[0]
            yield b

    t0 = time.time()
    with contextlib.closing(sample_batches(
            var_cfg, vae_cfg, var_params, vae_params, balanced_labels(args.num),
            args.batch, samp, kv_mode=args.kv, seed0=args.seed,
            pixels=args.pixels)) as batches:
        create_npz_from_arrays(tee(batches) if args.png_dir else batches,
                               args.out, num=args.num)
    wall = time.time() - t0
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"[fid-sample] DONE: {args.num} samples in {wall / 60:.1f} min "
          f"({args.num / wall:.1f} img/s end to end, pixel decode and npz "
          f"packing included); peak host RSS {rss_gib:.1f} GiB -> {args.out}",
          flush=True)


if __name__ == "__main__":
    main()
