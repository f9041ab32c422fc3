"""Train a draft/target VAR pair on the card and drive the speculative
engine in the regime of partial acceptance (the counterpart of the
repository's ``tools/train_pair.py``).

Random weights match at about 0% a scale and ``force_accept_all`` at
100%; two small VARs trained over one shared (frozen, seed-fixed) VQVAE
on a structured learnable dataset (``train.data.StructuredSynthImages``)
give per-scale draft/target top-1 match rates inside (0, 1) that vary by
scale, which is what speculative decoding is about.

    python -m sdvar_tpu_torch.tools.train_pair [--work DIR] [--device cpu] \\
        [--classes 16 --per-class 128 --per-class-val 16] <command> ...

Commands (state under ``--work``, default ``sdvar_pair`` in the working
directory):
  prep   write the PNG dataset (train + val) and pretokenize the train
         split (``--passes``, hflip)
  train  --role target|draft|drill: ``run_training`` (bf16 compute, the
         stored ids, the LR schedule, eval on the held-out split), then
         the final checkpoint and ``history.jsonl``
  sweep  load both checkpoints; a target-only decode as the time
         baseline, the two per-scale match profiles (gamma 1: the draft's
         context with ``force_accept_at_gamma1``, the target's with
         ``resample_on_reject``), then gamma x threshold rows (calls,
         accepts, ``vs_target_only``), written to ``sweep.json``
  drill  a control run to 2.5 epochs, then the same run started as a child
         process (``python -m sdvar_tpu_torch.tools.train_pair ... train
         --role drill``), SIGKILLed by its PID mid-epoch 2 at its ``[it N/``
         line, relaunched (it must print ``[resume] from step``): the two
         epoch-2 checkpoints must be equal leaf by leaf, bit for bit

``--classes``, ``--per-class`` and ``--per-class-val`` cut the dataset
(16 x 128 + 16 x 16 by default); the drill passes them to its children.
The VQVAE is built as ``train.train_loop.build_everything`` builds it
(``init_vqvae_params(seed=SEED)``) and a checkpoint's template is
``init_var_params(seed=SEED + 1)``, so the tokens, the eval and the sweep
see one tokenizer. Times are the host clock around a synchronisation and
follow the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from sdvar_tpu_torch.config import (
    SamplingConfig,
    SpeculativeConfig,
    TrainConfig,
    VARConfig,
    VQVAEConfig,
    patch_nums_for_reso,
)
from sdvar_tpu_torch.engine.decode import decode_all_scales
from sdvar_tpu_torch.engine.speculative import SpeculativeEngine
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.train import checkpoint as ckpt
from sdvar_tpu_torch.train.data import write_structured_folder
from sdvar_tpu_torch.train.pretokenize import (
    build_token_datasets_for_passes,
    pretokenize_dataset,
)
from sdvar_tpu_torch.train.train_loop import run_training
from sdvar_tpu_torch.train.trainer import init_train_state, tree_leaves
from sdvar_tpu_torch.utils.device import card_name, resolve_device, synchronize

# dataset geometry: 16 classes x 128 train (+16 val) images, masters 9/8 of
# the training resolution (FolderImageNet's crop margin)
NUM_CLASSES, PER_CLASS, PER_CLASS_VAL = 16, 128, 16
SEED = 0
RESO = 256
PATCH_NUMS = patch_nums_for_reso(RESO)
DEPTHS = {"target": 8, "draft": 4, "drill": 4}
EPOCHS = {"target": 96, "draft": 64, "drill": 4}
SALN_EVERY = {"target": 12, "draft": 8, "drill": 1}


def _dirs(work: str) -> dict:
    return {k: os.path.join(work, *p) for k, p in {
        "train": ("data", "train"), "val": ("data", "val"),
        "tokens": ("tokens",), "target": ("target",), "draft": ("draft",),
        "drill": ("drill",)}.items()}


def _vae_cfg() -> VQVAEConfig:
    return VQVAEConfig(patch_nums=PATCH_NUMS)


def _vae(device, seed: int = SEED):
    """build_everything's VQVAE: the same configuration and seed."""
    cfg = _vae_cfg()
    return cfg, init_vqvae_params(cfg, seed=seed, device=device)


def _var_cfg(depth: int) -> VARConfig:
    return VARConfig(depth=depth, patch_nums=PATCH_NUMS)


def cmd_prep(args) -> dict:
    d = _dirs(args.work)
    n_tr = write_structured_folder(d["train"], args.classes, args.per_class,
                                   reso=RESO * 9 // 8, seed=SEED)
    n_va = write_structured_folder(d["val"], args.classes, args.per_class_val,
                                   reso=RESO * 9 // 8, seed=SEED + 777)
    print(f"[prep] dataset: {n_tr} train / {n_va} val PNGs", flush=True)
    vae_cfg, vae_params = _vae(args.dev)
    datasets = build_token_datasets_for_passes(d["train"], RESO, args.passes,
                                               seed=SEED, hflip=True)
    m = pretokenize_dataset(vae_cfg, vae_params, datasets, d["tokens"],
                            batch=32, log_every=0)
    print(f"[prep] tokens: {m['num_samples']} x {m['passes']} passes "
          f"(L={m['L']})", flush=True)
    return m


def _train_cfg(role: str, args) -> TrainConfig:
    return TrainConfig(
        depth=args.depth or DEPTHS[role], reso=RESO, global_batch_size=args.bs,
        epochs=args.epochs or EPOCHS[role], base_lr=args.base_lr,
        saln_every=args.saln_every or SALN_EVERY[role])


def cmd_train(args) -> dict:
    d = _dirs(args.work)
    role = args.role
    out = args.out or d[role]
    tc = _train_cfg(role, args)
    t0 = time.time()
    state, history = run_training(
        tc, data_root=d["train"], out_dir=out, seed=SEED,
        max_iters=args.max_iters, batch_override=args.bs,
        dtype=torch.bfloat16, var_cfg=_var_cfg(tc.depth), vae_cfg=_vae_cfg(),
        token_root=d["tokens"], val_root=d["val"], device=args.dev)
    synchronize(args.dev)
    dt = time.time() - t0
    # the final checkpoint (run_training saves at its eval epochs and where
    # max_iters stops it)
    ckpt.save_checkpoint(out, int(state.step), state,
                         meta={"role": role, "depth": tc.depth, "final": True})
    with open(os.path.join(out, "history.jsonl"), "w") as f:
        for h in history:
            f.write(json.dumps(h) + "\n")
    res = {"steps": len(history), "seconds": dt}
    if history:
        n = len(history)
        res["loss_first"] = float(np.mean([h["loss"] for h in history[:20]]))
        res["loss_last"] = float(np.mean([h["loss"] for h in history[-20:]]))
        res["ms_per_step"] = dt / max(n, 1) * 1e3
        print(f"[train:{role}] d{tc.depth} {n} steps in {dt / 60:.1f} min "
              f"({res['ms_per_step']:.0f} ms/step): loss "
              f"{res['loss_first']:.3f} -> {res['loss_last']:.3f} "
              f"({card_name(args.dev)})", flush=True)
    return res


def _load_role(work: str, role: str, depth: int, dev):
    """A trained VAR's parameters from its run directory's newest
    checkpoint."""
    cfg = _var_cfg(depth)
    template = init_train_state(init_var_params(cfg, seed=SEED + 1, device=dev))
    loaded, meta = ckpt.auto_resume(_dirs(work)[role], template)
    if loaded is None:
        raise FileNotFoundError(f"no checkpoint for {role} in {work}")
    print(f"[load:{role}] d{depth} step {meta['step']}", flush=True)
    return cfg, loaded.params


def cmd_sweep(args) -> list:
    dev = args.dev
    print(f"[sweep] card: {card_name(dev)}", flush=True)
    vae_cfg, vae_params = _vae(dev)
    t_cfg, t_params = _load_role(args.work, "target", args.target_depth, dev)
    d_cfg, d_params = _load_role(args.work, "draft", args.draft_depth, dev)
    eng = SpeculativeEngine(vae_cfg, d_cfg, t_cfg, vae_params, d_params,
                            t_params, dtype=torch.bfloat16, device=dev)
    B = args.batch
    label = torch.from_numpy(np.random.default_rng(1).integers(
        0, args.classes, B)).to(dev)
    samp = SamplingConfig(cfg=1.5, top_k=args.top_k, top_p=0.96)
    rows = []

    for i in range(3):  # the target-only decode: the time baseline
        synchronize(dev)
        t0 = time.perf_counter()
        decode_all_scales(t_cfg, vae_cfg, t_params, vae_params["quant"], label,
                          50 + i, samp, torch.bfloat16, device=dev)
        synchronize(dev)
        base_ms = (time.perf_counter() - t0) * 1e3
    print(f"[sweep] target-only decode: {base_ms:.1f} ms/batch B={B}",
          flush=True)
    rows.append({"kind": "target_only", "ms_per_batch": base_ms})

    # per-scale match profiles: gamma-1 windows visit the scales in order
    for tag, thr, resample in (("draft-ctx", -1.0, False),
                               ("target-ctx", 2.0, True)):
        spec = SpeculativeConfig(gamma=1, match_threshold=thr,
                                 dynamic_gamma=False,
                                 force_accept_at_gamma1=not resample)
        _, st = eng.generate_speculative(label, 7, spec, samp,
                                         resample_on_reject=resample)
        prof = [round(float(r), 4) for r in st.match_rates]
        print(f"[sweep] per-scale match ({tag}): {prof}", flush=True)
        rows.append({"kind": f"profile_{tag}", "match_rates": prof})

    for gamma in args.gammas:
        for thr in args.thresholds:
            spec = SpeculativeConfig(gamma=gamma, match_threshold=thr)
            for i in range(args.iters):
                synchronize(dev)
                t0 = time.perf_counter()
                _, st = eng.generate_speculative(
                    label, 100 + i, spec, samp,
                    resample_on_reject=args.resample)
                synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
            s = st.as_dict()
            row = {"kind": "sweep", "gamma": gamma, "threshold": thr,
                   "resample": args.resample, "ms_per_batch": round(ms, 1),
                   "vs_target_only": round(base_ms / ms, 3),
                   **{k: s[k] for k in ("draft_calls", "target_calls",
                                        "accept_count", "reject_count",
                                        "forced_accepts", "resampled_scales")},
                   "mean_match": round(float(np.mean(s["match_rates"])), 4)}
            rows.append(row)
            print("[sweep] " + json.dumps(row), flush=True)
    out = os.path.join(args.work, "sweep.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"[sweep] wrote {out}", flush=True)
    return rows


def _geometry(args) -> list:
    return ["--classes", str(args.classes), "--per-class", str(args.per_class),
            "--per-class-val", str(args.per_class_val)]


def cmd_drill(args) -> dict:
    """A control run to 2.5 epochs; the victim, the same run, SIGKILLed
    mid-epoch 2 (after the epoch-1 checkpoint) and relaunched from it
    (``auto_resume``): their epoch-2 checkpoints must be equal bit for
    bit (each step's draws keyed by the step, a deterministic backward,
    the checkpoint round trip exact)."""
    d = _dirs(args.work)
    ipe = (args.classes * args.per_class) // args.bs  # iterations an epoch
    max_iters = ipe * 2 + ipe // 2
    env = dict(os.environ, PYTHONUNBUFFERED="1")

    def launch(out, max_it):
        cmd = [sys.executable, "-m", "sdvar_tpu_torch.tools.train_pair",
               "--work", args.work, "--device", str(args.dev), *_geometry(args),
               "train", "--role", "drill", "--bs", str(args.bs), "--out", out]
        if args.depth:
            cmd += ["--depth", str(args.depth)]
        if max_it:
            cmd += ["--max-iters", str(max_it)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True, env=env)

    ctrl = os.path.join(d["drill"], "ctrl")
    vict = os.path.join(d["drill"], "vict")
    for dd in (ctrl, vict):  # stale checkpoints would steer auto_resume
        shutil.rmtree(dd, ignore_errors=True)
    t0 = time.time()
    p = launch(ctrl, max_iters)
    text, _ = p.communicate(timeout=1800)
    if p.returncode != 0:
        raise RuntimeError(f"[drill] control run failed:\n{text[-3000:]}")
    print(f"[drill] control run done ({max_iters} iters, "
          f"{time.time() - t0:.1f} s)", flush=True)

    # the victim: killed by its PID mid-epoch 2 (after the epoch-1
    # checkpoint), at a line of the 10-iteration console cadence
    trig = ipe + ipe // 2 - (ipe + ipe // 2) % 10
    p = launch(vict, None)
    killed = False
    try:
        t0 = time.time()
        while time.time() - t0 < 1800:
            line = p.stdout.readline()
            if not line:
                break
            print("  [victim] " + line.rstrip(), flush=True)
            if f"[it {trig}/" in line:
                os.kill(p.pid, signal.SIGKILL)
                killed = True
                break
        p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    if not killed:
        raise RuntimeError("[drill] the victim never reached the kill point")
    print(f"[drill] SIGKILLed the victim at it {trig} (rc={p.returncode})",
          flush=True)
    p = launch(vict, max_iters)
    text, _ = p.communicate(timeout=1800)
    if p.returncode != 0 or "[resume] from step" not in text:
        raise RuntimeError(f"[drill] the relaunch failed or did not resume:\n"
                           f"{text[-3000:]}")
    resumed = int(text.split("[resume] from step")[1].split()[0])
    print(f"[drill] victim resumed from step {resumed} and finished", flush=True)

    step = ipe * 2
    template = init_train_state(init_var_params(
        _var_cfg(args.depth or DEPTHS["drill"]), seed=SEED + 1, device="cpu"))
    a, _ = ckpt.load_checkpoint(os.path.join(ctrl, f"ckpt-{step:08d}"), template)
    b, _ = ckpt.load_checkpoint(os.path.join(vict, f"ckpt-{step:08d}"), template)
    la = list(tree_leaves({"params": a.params, "opt_state": a.opt_state}))
    lb = list(tree_leaves({"params": b.params, "opt_state": b.opt_state}))
    bad = [pa for (pa, x), (pb, y) in zip(la, lb) if pa != pb or not torch.equal(x, y)]
    ok = len(la) == len(lb) and not bad and a.step == b.step == step \
        and resumed < step
    if not ok:
        raise AssertionError(f"[drill] {len(bad)} mismatched leaves at step "
                             f"{step} (resumed from {resumed}): {bad[:10]}")
    print(f"[drill] PASS: resume continuation bitwise-equal at step {step} "
          f"({len(la)} leaves)", flush=True)
    return {"step": step, "leaves": len(la), "resumed_from": resumed,
            "killed_at": trig}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--work", type=str, default="sdvar_pair")
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--classes", type=int, default=NUM_CLASSES)
    ap.add_argument("--per-class", type=int, default=PER_CLASS)
    ap.add_argument("--per-class-val", type=int, default=PER_CLASS_VAL)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("prep")
    sp.add_argument("--passes", type=int, default=2)

    st = sub.add_parser("train")
    st.add_argument("--role", choices=("target", "draft", "drill"),
                    required=True)
    st.add_argument("--depth", type=int, default=0)
    st.add_argument("--epochs", type=int, default=0)
    st.add_argument("--bs", type=int, default=32)
    st.add_argument("--base-lr", type=float, default=1.6e-3)
    st.add_argument("--saln-every", type=int, default=0)
    st.add_argument("--max-iters", type=int, default=None)
    st.add_argument("--out", type=str, default=None)

    sw = sub.add_parser("sweep")
    sw.add_argument("--batch", type=int, default=16)
    sw.add_argument("--target-depth", type=int, default=DEPTHS["target"])
    sw.add_argument("--draft-depth", type=int, default=DEPTHS["draft"])
    sw.add_argument("--gammas", type=int, nargs="+", default=[1, 2, 3, 4])
    sw.add_argument("--thresholds", type=float, nargs="+",
                    default=[0.3, 0.5, 0.7, 0.9])
    sw.add_argument("--top-k", type=int, default=900)
    sw.add_argument("--iters", type=int, default=3)
    sw.add_argument("--resample", action="store_true")

    dr = sub.add_parser("drill")
    dr.add_argument("--bs", type=int, default=32)
    dr.add_argument("--depth", type=int, default=0)
    return ap


def run(argv):
    """Parse ``argv`` (the command line without the program) and run the
    command; returns its result."""
    args = parser().parse_args(argv)
    args.dev = resolve_device(args.device)
    return {"prep": cmd_prep, "train": cmd_train, "sweep": cmd_sweep,
            "drill": cmd_drill}[args.cmd](args)


def main(argv: Optional[list] = None) -> None:
    run(sys.argv[1:] if argv is None else argv)


if __name__ == "__main__":
    main()
