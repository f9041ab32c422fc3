"""Training-step benchmark on the card (the counterpart of the repository's
``tools/bench_train.py``).

    python -m sdvar_tpu_torch.tools.bench_train step  [depth] [B] [iters] [flags...]
    python -m sdvar_tpu_torch.tools.bench_train accum [depth] [B_global]
    python -m sdvar_tpu_torch.tools.bench_train loader [n_images]
    python -m sdvar_tpu_torch.tools.bench_train tokenize [B] [bf16|nhwc]
    python -m sdvar_tpu_torch.tools.bench_train varonly [depth] [B] [remat]
    flags: remat, bf16params, sgd, reso512 (with shared AdaLN), tok16,
           adafactor, tokens;  --device cpu anywhere runs on the CPU

``step`` times the port's whole ``train.trainer.train_step``: the frozen
VQVAE's tokenize (f32, the bf16 channels-last encoder with ``tok16``, or
stored ids with ``tokens``), the VAR forward and backward (kernel row 1 in
the forward, bf16 compute), clipping and AdamW (or the factored RMS with
``adafactor``); ``sgd`` replaces the optimizer by ``p - lr * g`` after the
same forward (no moments: the optimizer state's memory apart from the
backward's); ``bf16params`` makes and steps the VAR parameters in bf16;
``reso512`` trains at the 512px preset with shared AdaLN (the d36-s
recipe). ``accum`` runs grad_accum 1, 2 and 4 with remat at one global
batch. MFU = 6 * N * B * L / step time / 989 TFLOP/s, the H100 SXM
data-sheet bf16 dense peak: the transformer's forward and backward matmul
FLOPs only (the tokenize and the optimizer are in the time, not in the
FLOPs, so the figure is conservative). ``loader`` times the PIL path
against the native C++ loader on the same JPEGs (or says why the native
library did not build); ``tokenize`` the frozen encoder alone; ``varonly``
the VAR step on given inputs and ids through the port's optimizer. Times:
the host clock around work that ends in a synchronisation, best of the
measured steps after one untimed step; memory: the allocator's peak
(``utils.profiling.memory_stats``). Every timing line follows a line with
the card's name and power limit.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from sdvar_tpu_torch.config import TrainConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.models import quantizer as Q
from sdvar_tpu_torch.models import vqvae as VQ
from sdvar_tpu_torch.models.var import count_params, init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.train import trainer as T
from sdvar_tpu_torch.utils.device import (
    card_name,
    full_f32,
    resolve_device,
    synchronize,
)
from sdvar_tpu_torch.utils.profiling import memory_stats

H100_BF16_PEAK = 989e12  # FLOP/s, H100 SXM data sheet, bf16 dense
PEAK_NAME = "the H100 SXM bf16 dense peak, 989 TFLOP/s"


def log(*a):
    print(*a, flush=True)


def mem_stats(tag: str, dev) -> dict:
    st = memory_stats(dev)
    if st:
        log(f"[mem:{tag}] peak={st['peak_bytes_in_use'] / 2 ** 30:.2f} GiB "
            f"in_use={st['bytes_in_use'] / 2 ** 30:.2f} GiB")
    return st


def image_side(vae_cfg: VQVAEConfig) -> int:
    """The side of the images the tokenizer takes: its downsampling times
    the last scale's side (256 at the 256px preset, 512 at the 512px)."""
    return vae_cfg.downsample * vae_cfg.patch_nums[-1]


def _card(tag: str, dev) -> str:
    card = card_name(dev)
    log(f"[{tag}] card: {card}")
    return card


def _sgd_step(var_cfg, vae_cfg, vae_params, remat, tokenize_bf16,
              pretokenized, lr=1e-4):
    """``p - lr * g`` after train_step's forward (label smoothing 0, bf16
    compute), no optimizer state; written into the parameters, as the JAX
    tool's donated ``sgd_step``; returns (params, loss): the same tree."""
    def step(params, img, label, gen):
        leaves = T.tree_map(lambda t: t.detach().requires_grad_(), params)
        _, gt, x_in = T.tokenize(var_cfg, vae_cfg, vae_params, img,
                                 tokenize_bf16, pretokenized)
        loss, _ = T.loss_and_metrics(var_cfg, leaves, label, x_in, gt, gen,
                                     0.0, dtype=torch.bfloat16, remat=remat)
        grads = iter(torch.autograd.grad(
            loss, [t for _, t in T.tree_leaves(leaves)], allow_unused=True,
            materialize_grads=True))
        with torch.no_grad():
            T.tree_map(lambda p: p.sub_(lr * next(grads)), params)
        return params, loss.detach()
    return step


def bench_step(depth: int, B: int, iters: int = 5, remat: bool = False,
               bf16_params: bool = False, sgd: bool = False, reso: int = 256,
               grad_accum: int = 1, shared_aln: bool = False,
               tokenize_bf16: bool = False, optimizer: str = "adamw",
               pretokenized: bool = False, device="cuda") -> dict:
    """Time ``iters`` train steps after one untimed step; returns the
    figures (ms, img/s, MFU, peak memory, losses, the card)."""
    dev = resolve_device(device)
    card = _card("train-bench", dev)
    tc = TrainConfig(depth=depth, reso=reso)
    var_cfg = VARConfig(depth=depth, patch_nums=tc.patch_nums,
                        shared_aln=shared_aln)
    vae_cfg = VQVAEConfig(patch_nums=tc.patch_nums)
    pdtype = torch.bfloat16 if bf16_params else torch.float32
    t0 = time.time()
    params = init_var_params(var_cfg, seed=0, device=dev, dtype=pdtype)
    vae_params = init_vqvae_params(vae_cfg, seed=1, device=dev)
    synchronize(dev)
    N = count_params(params)
    log(f"[train-bench] d{depth} reso={reso} B={B} ac={grad_accum} "
        f"params={N / 1e6:.0f}M ({'bf16' if bf16_params else 'f32'}) "
        f"remat={remat} opt={'sgd' if sgd else optimizer} "
        f"(init {time.time() - t0:.0f}s)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    rng = np.random.default_rng(0)
    if pretokenized:  # stored ids: their values do not change the time
        img = torch.from_numpy(rng.integers(0, var_cfg.vocab_size,
                                            (B, var_cfg.L))).to(dev)
    else:
        side = image_side(vae_cfg)
        img = torch.from_numpy(rng.uniform(-1, 1, (B, 3, side, side))
                               .astype(np.float32)).to(dev)
    label = torch.from_numpy(rng.integers(0, 1000, (B,))).to(dev)

    if sgd:
        step = _sgd_step(var_cfg, vae_cfg, vae_params, remat, tokenize_bf16,
                         pretokenized)
        box = [params]

        def run(i):
            box[0], loss = step(box[0], img, label,
                                T.step_generator(0, i, dev))
            return float(loss)
    else:
        box = [T.init_train_state(params, optimizer=optimizer)]
        del params

        def run(i):
            box[0], m = T.train_step(
                var_cfg, vae_cfg, box[0], vae_params, img, label, 1e-4, 0.05,
                T.step_generator(0, i, dev), clip=tc.grad_clip,
                label_smooth=0.1, grad_accum=grad_accum,
                dtype=torch.bfloat16, remat=remat,
                tokenize_bf16=tokenize_bf16, optimizer=optimizer,
                pretokenized=pretokenized)
            return float(m["loss"])

    t0 = time.time()
    loss = run(0)
    synchronize(dev)
    log(f"[train-bench] first step (kernel load) {time.time() - t0:.1f}s "
        f"loss={loss:.4f}")
    mem_stats("first-step", dev)
    times, losses = [], []
    for i in range(1, iters + 1):
        synchronize(dev)
        t0 = time.perf_counter()
        losses.append(run(i))  # float() synchronises
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    best = min(times)
    L = var_cfg.L
    mfu = 6.0 * N * B * L / best / H100_BF16_PEAK
    log(f"[train-bench] d{depth} B={B}: {best * 1e3:.0f} ms/step, "
        f"{B / best:.2f} imgs/s, MFU~{mfu * 100:.1f}% of {PEAK_NAME} "
        f"(times={['%.3f' % t for t in times]}, loss={losses[-1]:.4f})")
    st = mem_stats("steady", dev)
    return {"card": card, "ms": best * 1e3, "img_per_s": B / best, "mfu": mfu,
            "params": N, "L": L, "times_s": times, "losses": losses,
            "peak_gib": st.get("peak_bytes_in_use", 0) / 2 ** 30}


def bench_loader(n: int = 512, reso: int = 256) -> dict:
    """The Python/PIL path against the native C++ loader on the same ``n``
    JPEGs (320x320, four classes) in a temporary directory."""
    from PIL import Image

    from sdvar_tpu_torch.train.data import FolderImageNet, batch_arrays
    from sdvar_tpu_torch.train.native_loader import (
        NativeImageLoader,
        build_error,
        native_available,
    )

    root = tempfile.mkdtemp(prefix="sdvar_loader_bench_")
    out = {}
    try:
        rng = np.random.default_rng(0)
        for c in range(4):
            d = os.path.join(root, f"class{c:02d}")
            os.makedirs(d, exist_ok=True)
            for i in range(n // 4):
                arr = rng.integers(0, 255, (320, 320, 3), np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"{i:04d}.jpg"),
                                          quality=90)
        ds = FolderImageNet(root, reso=reso, train=True)
        idxs = list(range(len(ds)))
        t0 = time.time()
        for i0 in range(0, len(idxs), 64):
            batch_arrays(ds, idxs[i0:i0 + 64])
        t_py = time.time() - t0
        out["python_img_per_s"] = len(idxs) / t_py
        log(f"[loader] python/PIL: {len(idxs)} imgs in {t_py:.2f}s = "
            f"{len(idxs) / t_py:.1f} img/s")
        if not native_available():
            out["native_error"] = build_error()
            log(f"[loader] native loader unavailable ({build_error()})")
            return out
        nl = NativeImageLoader([p for p, _ in ds.samples],
                               [lab for _, lab in ds.samples], reso=reso,
                               train=True, seed=0,
                               num_threads=min(8, os.cpu_count() or 4))
        try:
            nl.enqueue(idxs[:64])
            nl.next_batch(len(idxs[:64]))  # warm-up
            t0 = time.time()
            for i0 in range(0, len(idxs), 64):
                part = idxs[i0:i0 + 64]
                nl.enqueue(part)
                nl.next_batch(len(part))
            t_nat = time.time() - t0
        finally:
            nl.close()
        out["native_img_per_s"] = len(idxs) / t_nat
        log(f"[loader] native C++: {len(idxs)} imgs in {t_nat:.2f}s = "
            f"{len(idxs) / t_nat:.1f} img/s ({t_py / t_nat:.1f}x python)")
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def bench_tokenize(B: int = 32, iters: int = 5, reso: int = 256,
                   bf16: bool = False, nhwc: bool = False,
                   device="cuda") -> dict:
    """The frozen VQVAE's tokenize alone (ids + the teacher-forcing input,
    ``img_to_idxBl`` + ``idx_to_var_input``)."""
    dev = resolve_device(device)
    card = _card("tokenize", dev)
    vae_cfg = VQVAEConfig(patch_nums=TrainConfig(reso=reso).patch_nums)
    vae_params = init_vqvae_params(vae_cfg, seed=1, device=dev)
    if nhwc:
        encode = VQ.img_to_idxBl_nhwc  # channels-last bf16 encoder
    else:
        encode = VQ.img_to_idxBl_bf16 if bf16 else VQ.img_to_idxBl
    name = "nhwc-bf16" if nhwc else ("bf16" if bf16 else "f32 (TF32 off)")
    log(f"[tokenize] encoder: {name}")

    @torch.no_grad()
    def tok():
        with full_f32():
            gt_idx = encode(vae_cfg, vae_params, img)
            x_in = Q.idx_to_var_input(vae_cfg, vae_params["quant"], gt_idx)
        return torch.cat(gt_idx, dim=1), x_in

    rng = np.random.default_rng(0)
    side = image_side(vae_cfg)
    img = torch.from_numpy(rng.uniform(-1, 1, (B, 3, side, side))
                           .astype(np.float32)).to(dev)
    t0 = time.time()
    tok()
    synchronize(dev)
    log(f"[tokenize] first call {time.time() - t0:.1f}s")
    times = []
    for _ in range(iters):
        synchronize(dev)
        t0 = time.perf_counter()
        gt, x_in = tok()
        float(gt.sum() + x_in.sum())  # synchronises
        times.append(time.perf_counter() - t0)
    best = min(times)
    log(f"[tokenize] B={B} reso={reso}: {best * 1e3:.0f} ms "
        f"({B / best:.1f} imgs/s) times={['%.4f' % t for t in times]}")
    return {"card": card, "encoder": name, "ms": best * 1e3,
            "img_per_s": B / best}


def bench_varonly(depth: int, B: int, iters: int = 5, remat: bool = False,
                  reso: int = 256, device="cuda") -> dict:
    """VAR forward + backward + clip + AdamW on given teacher-forcing
    inputs and ids (no tokenize): the transformer's share of a step."""
    dev = resolve_device(device)
    card = _card("var-only", dev)
    tc = TrainConfig(depth=depth, reso=reso)
    var_cfg = VARConfig(depth=depth, patch_nums=tc.patch_nums)
    params = init_var_params(var_cfg, seed=0, device=dev)
    N = count_params(params)
    opt_state = T.init_opt_state(params)
    L = var_cfg.L
    rng = np.random.default_rng(0)
    x_in = torch.from_numpy(rng.standard_normal((B, L - 1, var_cfg.Cvae))
                            .astype(np.float32)).to(dev)
    gt = torch.from_numpy(rng.integers(0, var_cfg.vocab_size, (B, L))).to(dev)
    label = torch.from_numpy(rng.integers(0, 1000, (B,))).to(dev)
    box = [params, opt_state]

    def step(i):
        leaves = T.tree_map(lambda t: t.detach().requires_grad_(), box[0])
        loss, _ = T.loss_and_metrics(var_cfg, leaves, label, x_in, gt,
                                     T.step_generator(0, i, dev), 0.1,
                                     dtype=torch.bfloat16, remat=remat)
        flat = [t for _, t in T.tree_leaves(leaves)]
        it = iter(T.owned_grads(torch.autograd.grad(
            loss, flat, allow_unused=True, materialize_grads=True)))
        grads = T.tree_map(lambda _: next(it), box[0])
        gnorm = T.global_norm(grads)
        T.apply_optimizer(box[0], grads, box[1], 1e-4, 0.05, clip=2.0,
                          norm=gnorm)
        return float(loss.detach()), float(gnorm)

    t0 = time.time()
    step(0)
    synchronize(dev)
    log(f"[var-only] first step {time.time() - t0:.1f}s")
    times = []
    for i in range(iters):
        synchronize(dev)
        t0 = time.perf_counter()
        loss, gnorm = step(i + 1)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    best = min(times)
    mfu = 6.0 * N * B * L / best / H100_BF16_PEAK
    log(f"[var-only] d{depth} B={B} remat={remat}: {best * 1e3:.0f} ms/step, "
        f"{B / best:.2f} imgs/s, transformer MFU~{mfu * 100:.1f}% of "
        f"{PEAK_NAME} times={['%.3f' % t for t in times]}")
    return {"card": card, "ms": best * 1e3, "img_per_s": B / best, "mfu": mfu,
            "loss": loss, "grad_norm": gnorm}


def _int(args, i: int, default: int) -> int:
    return int(args[i]) if len(args) > i else default


def run(argv, device="cuda"):
    """The tool on ``argv`` (the JAX tool's: mode, numbers, flags);
    returns the mode's figures (a list for ``accum``)."""
    mode = argv[0] if argv else "step"
    if mode == "loader":
        return bench_loader(_int(argv, 1, 512))
    if mode == "tokenize":
        return bench_tokenize(_int(argv, 1, 32), bf16="bf16" in argv[2:],
                              nhwc="nhwc" in argv[2:], device=device)
    if mode == "varonly":
        return bench_varonly(_int(argv, 1, 16), _int(argv, 2, 32),
                             remat="remat" in argv[3:], device=device)
    if mode == "accum":
        depth, Bg = _int(argv, 1, 16), _int(argv, 2, 64)
        return [bench_step(depth, Bg, iters=4, grad_accum=ac, remat=True,
                           device=device) for ac in (1, 2, 4)]
    if mode != "step":
        raise ValueError(f"unknown mode {mode!r} "
                         f"(step | accum | loader | tokenize | varonly)")
    flags = argv[4:]
    return bench_step(
        _int(argv, 1, 16), _int(argv, 2, 32), iters=_int(argv, 3, 5),
        remat="remat" in flags, bf16_params="bf16params" in flags,
        sgd="sgd" in flags, reso=512 if "reso512" in flags else 256,
        shared_aln="reso512" in flags,  # the d36-s recipe: shared AdaLN
        tokenize_bf16="tok16" in flags,
        optimizer="adafactor" if "adafactor" in flags else "adamw",
        pretokenized="tokens" in flags, device=device)


def split_device(argv) -> tuple:
    """(argv without ``--device X``, X or "cuda")."""
    argv, device = list(argv), "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    return argv, device


def main(argv: Optional[list] = None) -> None:
    args, device = split_device(sys.argv[1:] if argv is None else argv)
    run(args, device=device)


if __name__ == "__main__":
    main()
