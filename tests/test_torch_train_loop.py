"""The port's training entry points on the CPU: ``python -m
sdvar_tpu_torch.train.train_loop --smoke --device cpu`` exits 0 with finite
losses; ``run_training`` on synthetic data (a tiny VAR and VQVAE, 48px)
writes its JSON-lines log and a checkpoint where ``max_iters`` stops it,
and resumes from that checkpoint. Mesh training through ``run_training``
is held in ``test_torch_train_mesh.py``."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from sdvar_tpu_torch.config import TrainConfig, VARConfig, VQVAEConfig
from sdvar_tpu_torch.train import train_loop as TL

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

