"""The port's native loader bindings (``train/native_loader.py``) against
the JAX package's on the same files and seed (the counterpart of
``tests/test_native_loader.py``): both load a library built from the one
``csrc/dataloader.cpp``, the port's into ``build/native/``. Skipped where
either cannot build it. The port never writes the tracked
``csrc/libsdvar_data.so``.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from sdvar_tpu_torch.train import native_loader as NL

pytestmark = pytest.mark.skipif(
    not NL.native_available(),
    reason=f"native loader unavailable: {NL.build_error()}")

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACKED = os.path.join(REPO, "csrc", "libsdvar_data.so")


def _jax_loader(monkeypatch):
    """The JAX package's bindings over the library the port built: its own
    ``build_native`` compiles into the tracked csrc/libsdvar_data.so
    whenever that file is older than the source, so it is kept out of the
    test."""
    from sdvar_tpu.train import native_loader as JNL

    monkeypatch.setattr(JNL, "_lib_path", NL.lib_path)
    monkeypatch.setattr(JNL, "build_native",
                        lambda force=False: NL.build_error())
    monkeypatch.setattr(JNL, "_LIB", None)
    monkeypatch.setattr(JNL, "_BUILD_ERR", None)
    if not JNL.native_available():
        pytest.skip(f"the JAX package's loader: {JNL.build_error()}")
    return JNL


def _images(d, n=6, size=(80, 64)):
    rng = np.random.default_rng(0)
    paths, labels = [], []
    for i in range(n):
        arr = rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
        p = os.path.join(d, f"img{i}.png" if i % 2 else f"img{i}.jpg")
        Image.fromarray(arr).save(p)
        paths.append(p)
        labels.append(i % 3)
    return paths, labels


@pytest.mark.parametrize("train", [True, False])
def test_batches_bit_equal_to_jax(tmp_path, monkeypatch, train):
    before = _digest(TRACKED)
    JNL = _jax_loader(monkeypatch)
    paths, labels = _images(str(tmp_path))
    idx = [3, 0, 5, 1, 4, 2, 0, 3]
    out = []
    for mod in (NL, JNL):
        loader = mod.NativeImageLoader(paths, labels, reso=48, train=train,
                                       seed=5, num_threads=2)
        loader.enqueue(idx)
        imgs, labs, got = loader.next_batch(len(idx))
        loader.close()
        order = np.argsort(got, kind="stable")
        out.append((imgs[order], labs[order], got[order]))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert out[0][0].shape == (8, 3, 48, 48)
    assert out[0][0].min() >= -1.0 and out[0][0].max() <= 1.0
    assert _digest(TRACKED) == before


def test_batch_keeps_the_order_of_its_indices(tmp_path):
    paths, labels = _images(str(tmp_path))
    idx = [5, 2, 2, 0]
    loader = NL.NativeImageLoader(paths, labels, reso=32, train=True, seed=1,
                                  num_threads=3)
    imgs, labs = loader.batch(idx)
    single = [loader.batch([i])[0][0] for i in idx]
    loader.close()
    np.testing.assert_array_equal(labs, [labels[i] for i in idx])
    np.testing.assert_array_equal(imgs, np.stack(single))


def test_bad_file_counts_an_error(tmp_path):
    p = os.path.join(str(tmp_path), "junk.jpg")
    with open(p, "wb") as f:
        f.write(b"not an image at all")
    loader = NL.NativeImageLoader([p], [5], reso=16, num_threads=1)
    imgs, labs = loader.batch([0])
    errs = loader.errors
    loader.close()
    assert errs == 1 and labs[0] == -1 and np.all(imgs == 0)


def test_png_writer_roundtrip(tmp_path):
    imgs = np.random.default_rng(5).integers(0, 255, (6, 20, 24, 3), dtype=np.uint8)
    assert NL.write_pngs_native(str(tmp_path), imgs, start_idx=10,
                                num_threads=3) == 6
    back = np.asarray(Image.open(os.path.join(str(tmp_path), "000012.png")))
    np.testing.assert_array_equal(back, imgs[2])


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest(), os.stat(path).st_mtime_ns


def test_the_tracked_library_is_not_written():
    """A forced rebuild goes to build/native/, keyed by the source's hash;
    csrc/libsdvar_data.so keeps its bytes and its time."""
    before = _digest(TRACKED)
    assert NL.build_native(force=True) is None
    assert os.path.dirname(NL.lib_path()) == os.path.join(REPO, "build", "native")
    assert os.path.exists(NL.lib_path())
    assert _digest(TRACKED) == before


def test_run_training_reads_a_folder_through_the_native_loader(tmp_path, capsys):
    """One iteration of a tiny VAR on a folder of PIL-written JPEGs: the
    native loader is taken and the loss is finite."""
    from sdvar_tpu_torch.config import TrainConfig, VARConfig, VQVAEConfig
    from sdvar_tpu_torch.train import train_loop as TL

    root = tmp_path / "data"
    rng = np.random.default_rng(2)
    for c in range(2):
        (root / f"c{c}").mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (40, 52, 3), dtype=np.uint8)
                            ).save(root / f"c{c}" / f"{i}.jpg")
    pns = (1, 2)
    tc = TrainConfig(depth=2, reso=32, global_batch_size=2, epochs=1)
    _, hist = TL.run_training(
        tc, data_root=str(root), out_dir=str(tmp_path / "out"), max_iters=1,
        dtype=torch.float32, device="cpu",
        var_cfg=VARConfig(depth=2, patch_nums=pns, vocab_size=32, Cvae=8,
                          head_dim=32, num_classes=2),
        vae_cfg=VQVAEConfig(vocab_size=32, z_channels=8, ch=32, patch_nums=pns))
    assert "[data] native C++ loader over 6 files" in capsys.readouterr().out
    assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
