"""Training entry point (the counterpart of ``sdvar_tpu/train/train_loop.py``).

Builds data, models and optimizer state, runs the epoch loop with eval and
a checkpoint at each ``saln_every``-th epoch end and where ``max_iters``
stops the run, resumes from the newest checkpoint of ``out``, and has a
``--smoke`` mode (two steps of a tiny model on random images and a
checkpoint round trip) that needs no data. On the card unless
``--device cpu``. Step ``g_it``'s training draws (cond drop, drop path)
come from ``train.trainer.step_generator(seed, g_it)``, so a run stopped
and resumed is, bit for bit, the run that went straight through.

On a (data, model) mesh of processes (``mesh_cfg``, ``--mesh-data`` /
``--mesh-model``; the process group joined first, under ``torchrun`` or
``parallel/launch.py``) each rank holds its shard of the parameters and
of the optimizer state (``train.trainer.shard_train_state``) and reads
its rows of each global batch: the sampler splits over "data" (world size
``mesh.data``, rank ``mesh.data_index``), so the ranks of one model group
read the same rows. Eval sums go through ``allreduce_host``; prints, logs
and the checkpoint file come from rank 0 (the checkpoint is the whole
tree, gathered from the shards: a mesh run resumes on one device and
back).

Run:  python -m sdvar_tpu_torch.train.train_loop --smoke [--device cpu]
      python -m sdvar_tpu_torch.train.train_loop --depth 16 --bs 32 \\
          --max-iters 10 --out local_output
      torchrun --nproc_per_node 2 -m sdvar_tpu_torch.train.train_loop \\
          --mesh-data 2 --mesh-model 1 --depth 16 --bs 32 --max-iters 10
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from sdvar_tpu_torch.config import MeshConfig, TrainConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.var import count_params, init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.ops.partition import get_tp_mesh, set_tp_mesh
from sdvar_tpu_torch.parallel import distributed as D
from sdvar_tpu_torch.parallel.mesh import create_mesh
from sdvar_tpu_torch.train import checkpoint as ckpt
from sdvar_tpu_torch.train.data import (
    DistInfiniteBatchSampler,
    EvalDistributedSampler,
    batch_arrays,
    build_dataset,
)
from sdvar_tpu_torch.train.schedule import lr_wd_annealing
from sdvar_tpu_torch.train.trainer import (
    TrainState,
    eval_step,
    init_train_state,
    shard_train_state,
    step_generator,
    train_state_specs,
    train_step,
    tree_leaves,
)
from sdvar_tpu_torch.utils import debug as dbg
from sdvar_tpu_torch.utils.device import resolve_device
from sdvar_tpu_torch.utils.logging import JsonlLogger, MetricLogger, TensorboardSink

EVAL_STATS = ("L_mean", "L_tail", "acc_mean", "acc_tail", "tot")


def build_everything(tc: TrainConfig, seed: int = 0,
                     var_cfg: Optional[VARConfig] = None,
                     vae_cfg: Optional[VQVAEConfig] = None, device="cuda",
                     mesh=None):
    """Configs, seeded random VQVAE parameters and the VAR train state (f32
    master weights, zero optimizer state) on ``device``; with ``mesh`` the
    whole state is made (the same on every rank) and this rank's shard of
    it returned."""
    dev = resolve_device(device)
    if vae_cfg is None:
        vae_cfg = VQVAEConfig(patch_nums=tc.patch_nums)
    if var_cfg is None:
        var_cfg = VARConfig(depth=tc.depth, patch_nums=tc.patch_nums,
                            shared_aln=tc.shared_aln,
                            attn_l2_norm=tc.attn_l2_norm)
    vae_params = init_vqvae_params(vae_cfg, seed=seed, device=dev)
    var_params = init_var_params(var_cfg, seed=seed + 1, device=dev)
    state = init_train_state(var_params, optimizer=tc.optimizer)
    if mesh is not None:
        state = shard_train_state(state, var_cfg, mesh, tc.optimizer)
    return vae_cfg, var_cfg, vae_params, state


def _evaluate(var_cfg, vae_cfg, state, vae_params, val_set, dtype, dev,
              mesh=None):
    """Mean eval metrics over up to 64 held-out images, 16 a batch; on a
    mesh each data index evaluates its contiguous share and the sums meet
    in ``allreduce_host`` (the model ranks of a data index add the same
    sums, which scale every total and ``tot`` alike)."""
    n = min(len(val_set), 64)
    shard = list(EvalDistributedSampler(n, mesh.data, mesh.data_index)
                 if mesh is not None else EvalDistributedSampler(n, 1, 0))
    stats = dict.fromkeys(EVAL_STATS, 0.0)
    for i0 in range(0, len(shard), 16):
        img, label = batch_arrays(val_set, shard[i0:i0 + 16])
        out = eval_step(var_cfg, vae_cfg, state.params, vae_params,
                        torch.from_numpy(img).to(dev),
                        torch.from_numpy(label).to(dev), dtype=dtype)
        for k in stats:
            stats[k] += float(out[k])
    red = D.allreduce_host(np.asarray([stats[k] for k in EVAL_STATS],
                                      np.float64))
    stats = dict(zip(EVAL_STATS, red.tolist()))
    tot = max(stats.pop("tot"), 1.0)
    return {k: v / tot for k, v in stats.items()}


def _native_loader(train_set, tc: TrainConfig, seed: int):
    """The native C++ decode pipeline over a folder dataset, or None (no
    folder, or the library did not build: the reason is printed and the
    Python path reads)."""
    if not hasattr(train_set, "samples"):
        return None
    from sdvar_tpu_torch.train.native_loader import (
        NativeImageLoader,
        build_error,
        native_available,
    )

    if not native_available():
        print(f"[data] native loader unavailable ({build_error()}); "
              f"using the Python path")
        return None
    paths = [p for p, _ in train_set.samples]
    labels = [lab for _, lab in train_set.samples]
    print(f"[data] native C++ loader over {len(paths)} files")
    return NativeImageLoader(paths, labels, reso=tc.reso, train=True,
                             seed=seed, num_threads=min(8, os.cpu_count() or 4))


def run_training(
    tc: TrainConfig,
    data_root: Optional[str] = None,
    out_dir: str = "local_output",
    seed: int = 0,
    max_iters: Optional[int] = None,
    batch_override: Optional[int] = None,
    dtype=None,
    mesh_cfg: Optional[MeshConfig] = None,
    var_cfg: Optional[VARConfig] = None,
    vae_cfg: Optional[VQVAEConfig] = None,
    token_root: Optional[str] = None,
    val_root: Optional[str] = None,
    device="cuda",
):
    """The epoch loop, on one device or (``mesh_cfg``) on a mesh of the
    joined process group. ``dtype``: the forward's compute dtype (None:
    bf16 when ``tc.bf16``, else f32). ``token_root``: train off a
    pre-tokenized dataset (``train/pretokenize.py``). Without a data
    folder the data is ``SyntheticImageNet``; a folder is read by the
    native loader where it builds. Returns (state, history of
    per-iteration metrics as floats); on a mesh the state is this rank's
    shard and the metrics are the global batch's."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if tc.bf16 else torch.float32
    mesh = create_mesh(mesh_cfg) if mesh_cfg is not None else None
    registered = get_tp_mesh()
    set_tp_mesh(mesh)
    try:
        return _run(tc, data_root, out_dir, seed, max_iters, batch_override,
                    dtype, mesh, var_cfg, vae_cfg, token_root, val_root, dev)
    finally:
        set_tp_mesh(registered)


def _run(tc, data_root, out_dir, seed, max_iters, batch_override, dtype,
         mesh, var_cfg, vae_cfg, token_root, val_root, dev):
    master = D.is_master()
    vae_cfg, var_cfg, vae_params, state = build_everything(
        tc, seed, var_cfg=var_cfg, vae_cfg=vae_cfg, device=dev, mesh=mesh)
    specs = (train_state_specs(state.params, var_cfg, mesh, tc.optimizer)
             if mesh is not None else None)
    if master:
        print(f"[init] VAR params: {count_params(state.params) / 1e6:.2f}M "
              f"{'a rank ' if mesh is not None else ''}on {dev}, compute "
              f"{str(dtype)[6:]}"
              + (f", mesh data={mesh.data} x model={mesh.model}"
                 if mesh is not None else ""))

    bs = batch_override or tc.global_batch_size
    data, data_index = (mesh.data, mesh.data_index) if mesh is not None else (1, 0)
    if bs % data:
        raise ValueError(f"global batch {bs} does not divide over data={data}")
    pretokenized = token_root is not None
    if pretokenized:
        from sdvar_tpu_torch.train.pretokenize import TokenDataset

        train_set = TokenDataset(token_root)
        if master:
            print(f"[data] token dataset: {len(train_set)} samples x "
                  f"{train_set.passes} passes (L={train_set.L})")
    else:
        train_set = build_dataset(data_root, reso=tc.reso, train=True)
    val_set = build_dataset(val_root if val_root is not None else data_root,
                            reso=tc.reso, train=False, synthetic_len=64)
    native = _native_loader(train_set, tc, seed)

    sampler = DistInfiniteBatchSampler(len(train_set), bs, world_size=data,
                                       rank=data_index, seed=seed)
    iters_per_ep = sampler.iters_per_ep
    max_it = tc.epochs * iters_per_ep
    wp_it = tc.warmup_epochs() * iters_per_ep

    os.makedirs(out_dir, exist_ok=True)
    jlog = JsonlLogger(os.path.join(out_dir, "log.txt")) if master else None
    tb = TensorboardSink(os.path.join(out_dir, "tb"))  # rank 0 only
    mlog = MetricLogger()

    resumed, meta = ckpt.auto_resume(out_dir, state, specs, mesh)
    if resumed is not None:
        state = resumed
        if master:
            print(f"[resume] from step {meta['step']}")
    g_it = int(meta.get("step", 0))
    sampler.epoch = g_it // iters_per_ep
    sampler.start_it = g_it % iters_per_ep

    it_stream = iter(sampler)
    t0 = time.time()
    S = len(var_cfg.patch_nums)
    prog_wp_it = max(tc.pgwp_epochs() * iters_per_ep, 1)
    prog_it, last_prog_si, first_prog = 0, -1, True
    history, pending = [], []  # pending: device scalars until the next sync

    def drain():
        history.extend({k: (v if isinstance(v, (int, float)) else float(v))
                        for k, v in h.items()} for h in pending)
        pending.clear()

    def evaluate_and_save(ep):
        stats = _evaluate(var_cfg, vae_cfg, state, vae_params, val_set,
                          dtype, dev, mesh)
        if master:
            print(f"[eval ep{ep}] {stats}")
            jlog.write(epoch=ep, it=g_it, **stats)
        ckpt.save_checkpoint(out_dir, g_it, state,
                             meta={"epoch": ep, "config": dict(tc.__dict__)},
                             specs=specs, mesh=mesh)

    try:
        while g_it < max_it:
            if max_iters is not None and g_it >= max_iters:
                break
            if pretokenized:
                train_set.set_epoch(g_it // iters_per_ep)
            idxs = next(it_stream)
            if native is not None:
                img, label = native.batch(idxs)
            else:
                img, label = batch_arrays(train_set, idxs)
            lr, wd = lr_wd_annealing(tc.lr_schedule, tc.peak_lr(),
                                     tc.weight_decay, tc.weight_decay_end,
                                     g_it, wp_it, max_it, wpe=0.01)
            prog_si = tc.prog_si_at(g_it, wp_it, max_it, S)
            if last_prog_si != prog_si:
                if last_prog_si != -1:
                    first_prog = False
                last_prog_si, prog_it = prog_si, 0
            prog_it += 1
            prog_wp = 1.0 if first_prog else max(min(prog_it / prog_wp_it, 1),
                                                 0.01)
            if prog_si == S - 1:
                prog_si = -1
            state, metrics = train_step(
                var_cfg, vae_cfg, state, vae_params,
                torch.from_numpy(np.asarray(img)).to(dev),
                torch.from_numpy(np.asarray(label)).to(dev), lr, wd,
                step_generator(seed, g_it, dev),
                clip=tc.grad_clip, label_smooth=tc.label_smooth,
                grad_accum=tc.grad_accum, dtype=dtype, prog_si=prog_si,
                prog_wp=prog_wp, remat=tc.remat,
                tokenize_bf16=tc.tokenize_bf16, optimizer=tc.optimizer,
                pretokenized=pretokenized,
            )
            g_it += 1
            if tc.dbg_nan and not np.isfinite(float(metrics["loss"])):
                report = dbg.nan_report(state.params, "params")
                raise FloatingPointError(
                    f"[dbg_nan] non-finite loss at it {g_it} "
                    f"(loss={float(metrics['loss'])}); bad param leaves:\n"
                    + ("\n".join(report[:20]) or "  (params clean: a "
                       "transient activation; use utils.debug."
                       "checked_grad_probe)"))
            pending.append(dict(metrics, it=g_it))
            if g_it % 10 == 0 or g_it == 1:
                m = {k: float(v) for k, v in metrics.items()}
                drain()
                mlog.update(**{k: m[k] for k in ("Lm", "Lt", "Accm", "Acct")})
                if master:
                    print(f"[it {g_it}/{max_it}] loss={m['loss']:.4f} "
                          f"Lm={m['Lm']:.4f} Accm={m['Accm']:.2f} "
                          f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}")
                    tb.update("AR_iter_loss", g_it, force=True, **{
                        k: m[k] for k in ("Lm", "Lt", "Accm", "Acct",
                                          "grad_norm", "z_voc_usage")})
            ep = g_it // iters_per_ep
            if g_it % iters_per_ep == 0 and ep % tc.saln_every == 0:
                evaluate_and_save(ep)
        if max_iters is not None and g_it == max_iters and g_it % iters_per_ep:
            evaluate_and_save(g_it // iters_per_ep)  # the run stops mid-epoch
    finally:
        if native is not None:
            native.close()
    if master:
        print(f"[done] {g_it} iters in {time.time() - t0:.1f}s")
    tb.close()
    drain()
    return state, history


def smoke_test(device="cuda") -> bool:
    """Two steps of a tiny model on random 48px images (f32, head_dim 32)
    and a checkpoint round trip; raises on failure."""
    dev = resolve_device(device)
    patch_nums = (1, 2, 3)
    vae_cfg = VQVAEConfig(vocab_size=64, z_channels=8, ch=32,
                          patch_nums=patch_nums)
    var_cfg = VARConfig(depth=2, patch_nums=patch_nums, vocab_size=64,
                        Cvae=8, head_dim=32, num_classes=10)
    vae_params = init_vqvae_params(vae_cfg, seed=0, device=dev)
    state = init_train_state(init_var_params(var_cfg, seed=0, device=dev))
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 48, 48)).astype(np.float32)
                           ).to(dev)
    label = torch.tensor([1, 2], device=dev)
    losses = []
    for i in range(2):
        state, metrics = train_step(var_cfg, vae_cfg, state, vae_params, img,
                                    label, 1e-4, 0.05, step_generator(0, i, dev),
                                    label_smooth=0.0,
                                    dtype=torch.float32)
        losses.append(float(metrics["loss"]))
    if not all(np.isfinite(losses)):
        raise FloatingPointError(f"[smoke] losses {losses}")
    with tempfile.TemporaryDirectory() as d:
        ckpt.save_checkpoint(d, state.step, state)
        loaded, meta = ckpt.auto_resume(d, state)
        if loaded is None or meta["step"] != state.step:
            raise AssertionError(f"[smoke] resume: {meta}")
        for (pa, a), (_, b) in zip(_leaves(state), _leaves(loaded)):
            if not torch.equal(a, b):
                raise AssertionError(f"[smoke] {pa} changed in the round trip")
    print(f"[smoke] losses={losses} on {dev} OK")
    return True


def _leaves(state: TrainState):
    yield from tree_leaves({"params": state.params,
                            "opt_state": state.opt_state})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--data", type=str, default=None)
    ap.add_argument("--val-data", type=str, default=None,
                    help="held-out eval folder (defaults to --data)")
    ap.add_argument("--tokens", type=str, default=None,
                    help="pre-tokenized dataset dir (train/pretokenize.py); "
                         "skips the per-step VQVAE encode")
    ap.add_argument("--depth", type=int, default=16)
    ap.add_argument("--bs", type=int, default=32)
    ap.add_argument("--ep", type=int, default=1)
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--out", type=str, default="local_output")
    ap.add_argument("--pg", type=float, default=0.0,
                    help="progressive training fraction")
    ap.add_argument("--pg0", type=int, default=4)
    ap.add_argument("--dbg-nan", action="store_true",
                    help="stop at a non-finite loss, naming the bad leaves")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--mesh-data", type=int, default=0,
                    help="ranks that split the batch; 0: one device")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="ranks that split the model (tensor parallel)")
    args = ap.parse_args(argv)
    if args.smoke:
        smoke_test(args.device)
        return
    D.initialize()  # torchrun's variables; a no-op with one process
    if args.device == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(D.rank_device())
    from sdvar_tpu_torch.utils.logging import patch_print, tee_streams

    if D.is_master():
        tee_streams(args.out)
    patch_print()
    mesh_cfg = (MeshConfig(data=args.mesh_data, model=args.mesh_model)
                if args.mesh_data > 0 else None)
    tc = TrainConfig(depth=args.depth, global_batch_size=args.bs,
                     epochs=args.ep, pg=args.pg, pg0=args.pg0,
                     dbg_nan=args.dbg_nan)
    try:
        run_training(tc, data_root=args.data, out_dir=args.out,
                     max_iters=args.max_iters, batch_override=args.bs,
                     mesh_cfg=mesh_cfg, token_root=args.tokens,
                     val_root=args.val_data, device=args.device)
    finally:
        D.shutdown()


if __name__ == "__main__":
    main()
