"""ctypes bindings for the native data-loader runtime ``csrc/dataloader.cpp``
(the counterpart of ``sdvar_tpu/train/native_loader.py``): multithreaded
JPEG/PNG decode, Lanczos resize, crop and normalisation behind a bounded
prefetch queue, and a threaded PNG writer.

The library is built from the unchanged source with ``g++`` at first use,
into ``build/native/libsdvar_data-<hash of the source>.so`` beside the
checkout (``build/`` is not tracked); the tracked ``csrc/libsdvar_data.so``
of the JAX package is never written. Where the toolchain or libjpeg /
libpng are missing (at build or at load time), ``native_available()`` is
False, ``build_error()`` says why, and callers read through the Python
path (this is the data pipeline, not a kernel of the model).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERR: Optional[str] = None


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def source_path() -> str:
    return os.path.join(_repo_root(), "csrc", "dataloader.cpp")


def lib_path() -> str:
    """Where the library of this source is built: keyed by the source's
    hash, so an edited source builds anew."""
    with open(source_path(), "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_repo_root(), "build", "native",
                        f"libsdvar_data-{key}.so")


def build_native(force: bool = False) -> Optional[str]:
    """Compile ``csrc/dataloader.cpp`` into ``lib_path()`` (into a temporary
    file renamed into place, so a concurrent build never loads half a
    library). Returns an error string, or None on success."""
    try:
        out = lib_path()
    except OSError as e:
        return f"{type(e).__name__}: {e}"
    if not force and os.path.exists(out):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", source_path(),
           "-o", tmp, "-ljpeg", "-lpng", "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            return r.stderr[-2000:] or f"g++ exited {r.returncode}"
        os.replace(tmp, out)
        return None
    except Exception as e:
        return f"{type(e).__name__}: {e}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_ERR
    if _LIB is not None:
        return _LIB
    err = build_native()
    if err is not None:
        _BUILD_ERR = err
        return None
    try:  # built, yet its libjpeg / libpng may be missing at run time
        lib = ctypes.CDLL(lib_path())
    except OSError as e:
        _BUILD_ERR = f"built, but does not load: {e}"
        return None
    lib.sdvar_loader_create.restype = ctypes.c_void_p
    lib.sdvar_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
    ]
    lib.sdvar_loader_enqueue.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.sdvar_loader_next.restype = ctypes.c_int64
    lib.sdvar_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.sdvar_loader_errors.restype = ctypes.c_int64
    lib.sdvar_loader_errors.argtypes = [ctypes.c_void_p]
    lib.sdvar_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.sdvar_write_pngs.restype = ctypes.c_int64
    lib.sdvar_write_pngs.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
    ]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _BUILD_ERR


class NativeImageLoader:
    """Multithreaded decode and augmentation over a file list.

        loader = NativeImageLoader(paths, labels, reso=256, train=True)
        loader.enqueue(indices)            # a batch of DistInfiniteBatchSampler
        imgs, labels, idxs = loader.next_batch(len(indices))

    Images come back (B, 3, reso, reso) f32 in [-1, 1]; a file that does not
    decode gives zeros and label -1 and counts in ``errors``."""

    def __init__(self, paths: Sequence[str], labels: Sequence[int],
                 reso: int = 256, mid_reso: float = 1.125, train: bool = True,
                 hflip: bool = False, seed: int = 0,
                 num_threads: int = 8, queue_cap: int = 128):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_BUILD_ERR}")
        self._lib = lib
        self.reso = reso
        n = len(paths)
        self._path_bufs = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * n)(*self._path_bufs)
        lab = np.asarray(labels, dtype=np.int32)
        self._h = lib.sdvar_loader_create(
            arr, lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, reso, round(mid_reso * reso), int(train), int(hflip),
            seed, num_threads, queue_cap,
        )

    def enqueue(self, indices: Sequence[int]) -> None:
        idx = np.asarray(indices, dtype=np.int64)
        self._lib.sdvar_loader_enqueue(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx))

    def next_batch(self, batch: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        imgs = np.empty((batch, 3, self.reso, self.reso), np.float32)
        labels = np.empty((batch,), np.int32)
        idxs = np.empty((batch,), np.int64)
        got = self._lib.sdvar_loader_next(
            self._h, imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), batch)
        if got != batch:
            raise RuntimeError(f"native loader: {got} of {batch} images")
        return imgs, labels, idxs

    def batch(self, indices: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """The images and labels of ``indices``, in their order (the queue
        hands them back in the order the threads finish)."""
        self.enqueue(indices)
        imgs, labels, idxs = self.next_batch(len(indices))
        pos = {}
        for j, i in enumerate(idxs.tolist()):
            pos.setdefault(i, []).append(j)
        order = [pos[i].pop() for i in indices]
        return imgs[order], labels[order]

    @property
    def errors(self) -> int:
        return int(self._lib.sdvar_loader_errors(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.sdvar_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_pngs_native(out_dir: str, images_u8_nhwc: np.ndarray,
                      start_idx: int = 0, num_threads: int = 8) -> int:
    """Threaded PNG writer (``<out_dir>/<index, 6 digits>.png``); returns
    the number written."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_BUILD_ERR}")
    os.makedirs(out_dir, exist_ok=True)
    x = np.ascontiguousarray(images_u8_nhwc, dtype=np.uint8)
    n, h, w, c = x.shape
    if c != 3:
        raise ValueError(f"write_pngs_native: (N, H, W, 3) uint8, got {x.shape}")
    return int(lib.sdvar_write_pngs(
        out_dir.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, start_idx, num_threads))
