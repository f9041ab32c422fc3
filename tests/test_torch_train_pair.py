"""``tools/train_pair`` on the CPU at tiny size, in one process: ``prep``
(the structured PNG folders and one pass of pretokenized ids), ``train``
for both roles a few iterations (the final checkpoint and
``history.jsonl``), then ``sweep`` with one gamma and one threshold (the
target-only decode, both per-scale match profiles, one row). The module's
configuration names are swapped for small ones (VAR depth 2, 32 per
head, V=64; a two-level VQVAE of 32 channels; 12px images at the scales
1-2-3; 4 classes of 8 images), so its own code runs as it is. The drill's
kill and relaunch run on the card, in ``chip_smoke.py``. Also
``probe_train_determinism`` at the same size."""

import json
import os

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.tools import probe_train_determinism
from sdvar_tpu_torch.tools import train_pair as TP
from sdvar_tpu_torch.train import train_loop as TL


class _NoSink:
    def __init__(self, *a, **k):
        pass

    def update(self, *a, **k):
        pass

    def close(self):
        pass


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(TP, "RESO", 6)
    monkeypatch.setattr(TP, "PATCH_NUMS", (1, 2, 3))
    monkeypatch.setattr(TP, "VARConfig", lambda depth, patch_nums: VARConfig(
        depth=min(depth, 2), patch_nums=patch_nums, vocab_size=64, Cvae=8,
        head_dim=32))
    monkeypatch.setattr(TP, "VQVAEConfig", lambda patch_nums: VQVAEConfig(
        patch_nums=patch_nums, vocab_size=64, z_channels=8, ch=32, ch_mult=(1, 1)))
    monkeypatch.setattr(TL, "TensorboardSink", _NoSink)


def test_train_pair_prep_train_sweep_on_the_cpu(tiny, tmp_path, capsys):
    work = str(tmp_path / "pair")
    geo = ["--work", work, "--device", "cpu", "--classes", "4", "--per-class",
           "8", "--per-class-val", "2"]
    m = TP.run(geo + ["prep", "--passes", "1"])
    assert m["num_samples"] == 32 and m["passes"] == 1 and m["L"] == 14
    for role in ("target", "draft"):
        r = TP.run(geo + ["train", "--role", role, "--bs", "8", "--max-iters",
                          "3"])
        assert r["steps"] == 3 and np.isfinite(r["loss_last"])
        d = os.path.join(work, role)
        assert os.path.isdir(os.path.join(d, "ckpt-00000003"))
        with open(os.path.join(d, "ckpt-00000003", "meta.json")) as f:
            assert json.load(f)["role"] == role
        with open(os.path.join(d, "history.jsonl")) as f:
            assert [json.loads(x)["it"] for x in f] == [1, 2, 3]
    rows = TP.run(geo + ["sweep", "--batch", "2", "--gammas", "2",
                         "--thresholds", "0.5", "--iters", "1", "--top-k", "8"])
    assert [r["kind"] for r in rows] == ["target_only", "profile_draft-ctx",
                                         "profile_target-ctx", "sweep"]
    for r in rows[1:3]:
        assert len(r["match_rates"]) == 3
        assert all(0.0 <= x <= 1.0 for x in r["match_rates"])
    row = rows[3]
    assert row["gamma"] == 2 and row["threshold"] == 0.5 and row["target_calls"] > 0
    assert row["vs_target_only"] > 0 and 0 <= row["mean_match"] <= 1
    with open(os.path.join(work, "sweep.json")) as f:
        assert json.load(f) == rows
    out = capsys.readouterr().out
    assert "[load:target] d8 step 3" in out and "[load:draft] d4 step 3" in out
    assert "[sweep] per-scale match (draft-ctx)" in out


def test_probe_train_determinism_on_the_cpu(monkeypatch):
    """Two tiny token-path runs in one process: every leaf equal, no op
    flagged, and the deterministic switch off again after."""
    monkeypatch.setattr(TL, "TensorboardSink", _NoSink)
    r = probe_train_determinism.run(
        depth=2, iters=3, device="cpu", reso=6,
        var_cfg=VARConfig(depth=2, patch_nums=(1, 2, 3), vocab_size=64, Cvae=8,
                          head_dim=32),
        vae_cfg=VQVAEConfig(patch_nums=(1, 2, 3), vocab_size=64, z_channels=8,
                            ch=32, ch_mult=(1, 1)))
    assert r["leaves"] > 22 and r["differ"] == [] and r["flagged"] == []
    assert not torch.are_deterministic_algorithms_enabled()
