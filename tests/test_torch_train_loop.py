"""The port's training entry points on the CPU: ``python -m
sdvar_tpu_torch.train.train_loop --smoke --device cpu`` exits 0 with finite
losses; ``run_training`` on synthetic data (a tiny VAR and VQVAE, 48px)
writes its JSON-lines log and a checkpoint where ``max_iters`` stops it,
and resumes from that checkpoint; a run stopped at step 2 and resumed to
step 4 is, in every leaf of the parameters and the optimizer state, the
run that went straight to step 4 (each step's draws keyed by the step,
``trainer.step_generator``). Mesh training through ``run_training`` is
held in ``test_torch_train_mesh.py``."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from sdvar_tpu_torch.config import TrainConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.train import train_loop as TL
from sdvar_tpu_torch.train import trainer as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNS = (1, 2, 3)


def test_smoke_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "sdvar_tpu_torch.train.train_loop", "--smoke",
         "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    m = re.search(r"\[smoke\] losses=\[([^\]]*)\] on cpu OK", out.stdout)
    assert m, out.stdout
    losses = [float(x) for x in m.group(1).split(",")]
    assert len(losses) == 2 and all(np.isfinite(losses))


def _cfgs():
    return (VARConfig(depth=2, num_classes=1000, patch_nums=PNS,
                      vocab_size=64, Cvae=8, head_dim=32),
            VQVAEConfig(vocab_size=64, z_channels=8, ch=32, patch_nums=PNS))


def test_run_training_logs_checkpoints_and_resumes(tmp_path):
    out = str(tmp_path / "run")
    tc = TrainConfig(depth=2, reso=48, global_batch_size=4, epochs=1,
                     label_smooth=0.0)
    var_cfg, vae_cfg = _cfgs()
    kw = dict(out_dir=out, var_cfg=var_cfg, vae_cfg=vae_cfg, device="cpu",
              dtype=torch.float32)
    state, hist = TL.run_training(tc, max_iters=2, **kw)
    assert state.step == 2 and [h["it"] for h in hist] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert os.path.isdir(os.path.join(out, "ckpt-00000002"))
    with open(os.path.join(out, "log.txt")) as f:
        rec = [json.loads(line) for line in f]
    assert rec[-1]["it"] == 2 and np.isfinite(rec[-1]["L_mean"])
    state, hist = TL.run_training(tc, max_iters=3, **kw)  # resumes at 2
    assert state.step == 3 and [h["it"] for h in hist] == [3]
    assert os.path.isdir(os.path.join(out, "ckpt-00000003"))



def test_resumed_run_is_bit_equal_to_the_straight_run(tmp_path):
    """The d2 config above draws cond drop (0.1) and drop path: a resume
    that restarted one generator from its seed drew other masks (13 of 22
    parameter leaves differed)."""
    tc = TrainConfig(depth=2, reso=48, global_batch_size=4, epochs=1)
    var_cfg, vae_cfg = _cfgs()
    assert var_cfg.cond_drop_rate > 0 and var_cfg.dpr > 0

    def run(out, iters):
        return TL.run_training(tc, out_dir=str(out), max_iters=iters,
                               var_cfg=var_cfg, vae_cfg=vae_cfg, device="cpu",
                               dtype=torch.float32)

    straight, _ = run(tmp_path / "straight", 4)
    run(tmp_path / "resumed", 2)
    resumed, hist = run(tmp_path / "resumed", 4)
    assert [h["it"] for h in hist] == [3, 4]
    assert straight.step == resumed.step == 4
    a = list(T.tree_leaves({"params": straight.params, "opt": straight.opt_state}))
    b = list(T.tree_leaves({"params": resumed.params, "opt": resumed.opt_state}))
    assert [p for p, _ in a] == [p for p, _ in b] and len(a) > 22
    differ = [p for (p, x), (_, y) in zip(a, b) if not torch.equal(x, y)]
    assert not differ, differ


def test_step_generator_is_keyed_by_seed_and_step():
    def draw(seed, it):
        return torch.rand(4, generator=T.step_generator(seed, it, "cpu"))

    assert torch.equal(draw(0, 5), draw(0, 5))
    assert not torch.equal(draw(0, 5), draw(0, 6))
    assert not torch.equal(draw(0, 5), draw(1, 5))
