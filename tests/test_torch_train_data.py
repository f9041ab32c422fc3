"""The port's training data, schedule, checkpoints, pretokenized datasets
and logging against the JAX package's: the schedule's (lr, wd), the
samplers' index sequences and the synthetic and folder datasets' samples
exactly equal; the checkpoint round trip bit-equal, ``auto_resume`` taking
the newest; token files written by either package read by the other, with
the same ids."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from sdvar_tpu.config import VQVAEConfig as JVQVAEConfig
from sdvar_tpu.train import data as JD
from sdvar_tpu.train import pretokenize as JP
from sdvar_tpu.train import schedule as JS
from sdvar_tpu_torch.config import VARConfig, VQVAEConfig
from sdvar_tpu_torch.models.var import init_var_params
from sdvar_tpu_torch.models.vqvae import init_vqvae_params
from sdvar_tpu_torch.train import checkpoint as CK
from sdvar_tpu_torch.train import data as D
from sdvar_tpu_torch.train import pretokenize as P
from sdvar_tpu_torch.train import schedule as S
from sdvar_tpu_torch.train.trainer import TrainState, init_train_state, tree_leaves
from sdvar_tpu_torch.utils import logging as LG

VAE_KW = dict(vocab_size=64, z_channels=8, ch=32, patch_nums=(1, 2, 3))


@pytest.mark.parametrize("sche", ["cos", "lin", "lin0", "lin00", "lin0.3", "exp"])
def test_lr_wd_annealing_equal(sche):
    assert S.NOWD_KEYS == JS.NOWD_KEYS
    for it in (0, 1, 3, 10, 57, 99):
        args = (sche, 3e-4, 0.05, 0.01, it, 7.4, 100)
        assert S.lr_wd_annealing(*args, wpe=0.01) == JS.lr_wd_annealing(*args, wpe=0.01)


@pytest.mark.parametrize("world,rank,fill,start", [(1, 0, True, 0), (2, 1, True, 3),
                                                   (4, 2, False, 1)])
def test_samplers_equal(world, rank, fill, start):
    kw = dict(world_size=world, rank=rank, seed=5, fill_last=fill,
              start_ep=1, start_it=start)
    a = iter(D.DistInfiniteBatchSampler(103, 8 * world, **kw))
    b = iter(JD.DistInfiniteBatchSampler(103, 8 * world, **kw))
    for _ in range(40):  # across epoch boundaries
        assert next(a) == next(b)
    for n, w in ((10, 3), (64, 4), (5, 8)):
        for r in range(w):
            assert list(D.EvalDistributedSampler(n, w, r)) == list(
                JD.EvalDistributedSampler(n, w, r))


def test_synthetic_datasets_equal():
    for a, b in ((D.SyntheticImageNet(reso=32, length=8, seed=3),
                  JD.SyntheticImageNet(reso=32, length=8, seed=3)),
                 (D.StructuredSynthImages(reso=40, num_classes=8, length=16, seed=2),
                  JD.StructuredSynthImages(reso=40, num_classes=8, length=16, seed=2))):
        assert len(a) == len(b)
        for i in range(len(a)):
            (xa, la), (xb, lb) = a[i], b[i]
            assert la == lb and xa.dtype == xb.dtype
            np.testing.assert_array_equal(xa, xb)
        ia, la = D.batch_arrays(a, [0, 3, 5])
        ib, lb = JD.batch_arrays(b, [0, 3, 5])
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(la, lb)


def test_folder_dataset_equal(tmp_path):
    root = str(tmp_path / "folder")
    n = D.write_structured_folder(root, num_classes=3, per_class=2, reso=36)
    assert n == 6
    for train in (True, False):
        a = D.build_dataset(root, reso=32, train=train, hflip=True)
        b = JD.build_dataset(root, reso=32, train=train, hflip=True)
        assert isinstance(a, D.FolderImageNet) and len(a) == len(b) == 6
        assert a.samples == b.samples
        for i in range(6):
            np.testing.assert_array_equal(a[i][0], b[i][0])
    assert isinstance(D.build_dataset(None, reso=32), D.SyntheticImageNet)


def _state(seed=0):
    cfg = VARConfig(depth=2, num_classes=10, patch_nums=(1, 2, 3),
                    vocab_size=64, Cvae=8, head_dim=32)
    return init_train_state(init_var_params(cfg, seed=seed, device="cpu"))


def test_checkpoint_round_trip_and_auto_resume(tmp_path):
    d = str(tmp_path / "ck")
    s1, s2 = _state(0), _state(1)
    s1.step, s2.step = 10, 20
    s2.opt_state["count"] += 20
    CK.save_checkpoint(d, s1.step, s1, meta={"epoch": 0})
    p2 = CK.save_checkpoint(d, s2.step, s2, meta={"epoch": 1})
    os.utime(os.path.join(d, "ckpt-00000010"), (1, 1))  # the older one
    assert os.path.basename(p2) == "ckpt-00000020"
    assert sorted(os.listdir(d)) == ["ckpt-00000010", "ckpt-00000020"]
    with open(os.path.join(p2, "meta.json")) as f:
        assert json.load(f) == {"step": 20, "epoch": 1}
    got, meta = CK.auto_resume(d, _state(2))
    assert isinstance(got, TrainState) and meta["step"] == 20 == got.step
    for (pa, a), (pb, b) in zip(tree_leaves({"p": got.params, "o": got.opt_state}),
                                tree_leaves({"p": s2.params, "o": s2.opt_state})):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    bad = init_train_state(init_var_params(VARConfig(
        depth=2, num_classes=10, patch_nums=(1, 2, 3), vocab_size=32, Cvae=8,
        head_dim=32), seed=0, device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        CK.load_checkpoint(p2, bad)
    assert CK.auto_resume(str(tmp_path / "none"), s1) == (None, {"step": 0})


def test_token_files_read_both_ways(tmp_path):
    """JAX and the port tokenize the same images (f32, the same numpy VQVAE
    weights) into token shards; each package's TokenDataset reads the
    other's files, and the ids agree."""
    tcfg = VQVAEConfig(**VAE_KW)
    vae = init_vqvae_params(tcfg, seed=0, device="cpu", eini=1.0)
    vnp = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), vae)
    passes_t = P.build_token_datasets_for_passes(None, 48, 2, synthetic_len=6)
    passes_j = JP.build_token_datasets_for_passes(None, 48, 2, synthetic_len=6)
    dt, dj = str(tmp_path / "port"), str(tmp_path / "jax")
    mt = P.pretokenize_dataset(tcfg, vae, passes_t, dt, batch=4, shard_size=4,
                               log_every=0)
    mj = JP.pretokenize_dataset(JVQVAEConfig(**VAE_KW), vnp, passes_j, dj,
                                batch=4, shard_size=4, log_every=0)
    assert mt == mj and mt["num_shards"] == 2 and mt["L"] == 14
    for root in (dt, dj):
        a, b = P.TokenDataset(root), JP.TokenDataset(root)
        for ep in (0, 1):
            a.set_epoch(ep)
            b.set_epoch(ep)
            for i in range(6):
                (ta, la), (tb, lb) = a[i], b[i]
                assert la == lb and ta.dtype == tb.dtype == np.int32
                np.testing.assert_array_equal(ta, tb)
    a, b = P.TokenDataset(dt), P.TokenDataset(dj)
    for i in range(6):
        np.testing.assert_array_equal(a[i][0], b[i][0])


def test_logging_helpers(tmp_path):
    sv = LG.SmoothedValue(window_size=3)
    for v in (1.0, 5.0, 3.0, 4.0):
        sv.update(v)
    assert (sv.median, sv.avg, sv.global_avg) == (4.0, 4.0, 13.0 / 4)
    ml = LG.MetricLogger()
    ml.update(loss=2.0, acc=None)
    assert ml.loss.global_avg == 2.0 and "acc" not in ml.meters
    seen = list(ml.log_every(range(3), print_freq=1, header="t"))
    assert seen == [(0, 0), (1, 1), (2, 2)]
    path = str(tmp_path / "log.txt")
    LG.JsonlLogger(path).write(it=1, loss=0.5)
    rec = json.loads(open(path).read())
    assert rec["it"] == 1 and rec["loss"] == 0.5 and "time" in rec
    tb = LG.TensorboardSink(None)
    tb.update("x", 0, force=True, a=1.0)
    tb.close()
    assert LG.is_master()
