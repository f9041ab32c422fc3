"""Observability: smoothed metrics, an iteration logger with ETA, the
JSON-lines run log, an optional TensorBoard sink, stream tee and a
master-gated print (a copy of ``sdvar_tpu/utils/logging.py``). The master
is rank 0 of the ``torch.distributed`` group, or the only process.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, Iterator, Optional


def is_master() -> bool:
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


class TeeStream:
    """Tee a live stream into a file with a restart banner."""

    def __init__(self, stream, path: str):
        self.stream = stream
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a", buffering=1)
        self.f.write(
            f"\n{'=' * 27} program is restarted at "
            f"{datetime.datetime.now():%Y-%m-%d %H:%M:%S} {'=' * 27}\n"
        )

    def write(self, s: str):
        self.stream.write(s)
        self.f.write(s)
        return len(s)

    def flush(self):
        self.stream.flush()
        self.f.flush()

    def isatty(self):
        return getattr(self.stream, "isatty", lambda: False)()

    def close(self):
        self.f.close()


def tee_streams(out_dir: str):
    """Mirror stdout/stderr into ``out_dir/std{out,err}.txt``; returns the
    two TeeStream objects."""
    so = TeeStream(sys.stdout, os.path.join(out_dir, "stdout.txt"))
    se = TeeStream(sys.stderr, os.path.join(out_dir, "stderr.txt"))
    sys.stdout, sys.stderr = so, se
    return so, se


def patch_print():
    """Replace builtins.print with a master-gated variant that prefixes a
    timestamp and the caller's file:line, with a ``force=True`` override on
    non-master processes. Returns a restore() callable."""
    import builtins

    orig = builtins.print

    def tagged_print(*args, force: bool = False, **kwargs):
        if not (is_master() or force):
            return
        fr = sys._getframe(1)
        caller = f"{os.path.basename(fr.f_code.co_filename)}:{fr.f_lineno}"
        ts = datetime.datetime.now().strftime("%m-%d %H:%M:%S")
        orig(f"[{ts}] ({caller})", *args, **kwargs)

    builtins.print = tagged_print

    def restore():
        builtins.print = orig

    return restore


class SmoothedValue:
    """Track a series and provide median/avg/global-avg over a window."""

    def __init__(self, window_size: int = 30, fmt: str = "{median:.4f}"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        if not self.deque:
            return 0.0
        s = sorted(self.deque)
        return s[len(s) // 2]

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg
        )


class MetricLogger:
    """Iteration logger with ETA."""

    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.log_iters: set = set()

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if v is None:
                continue
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def log_every(self, iterable: Iterable, print_freq: int = 50,
                  header: str = "", total: Optional[int] = None,
                  file=sys.stdout) -> Iterator:
        total = total if total is not None else len(iterable)  # type: ignore
        self.log_iters = set(range(0, total, max(print_freq, 1))) | {total - 1}
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        last = time.time()
        for i, obj in enumerate(iterable):
            yield i, obj
            iter_time.update(time.time() - last)
            last = time.time()
            if i in self.log_iters and is_master():
                eta = iter_time.avg * (total - i - 1)
                eta_str = str(datetime.timedelta(seconds=int(eta)))
                meters = self.delimiter.join(
                    f"{k}: {v}" for k, v in self.meters.items()
                )
                print(
                    f"{header} [{i:>4d}/{total}] eta: {eta_str} {meters} "
                    f"iter_t: {iter_time}",
                    file=file, flush=True,
                )
        if is_master():
            elapsed = str(datetime.timedelta(seconds=int(time.time() - start)))
            print(f"{header} Total time: {elapsed}", file=file, flush=True)


class JsonlLogger:
    """Append-per-epoch JSON lines run log."""

    def __init__(self, path: str):
        self.path = path

    def write(self, **kv):
        if not is_master():
            return
        kv.setdefault("time", datetime.datetime.now().isoformat())
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(kv) + "\n")


class TensorboardSink:
    """Throttled TensorBoard scalars; a no-op when tensorboard is
    unavailable."""

    def __init__(self, log_dir: Optional[str], every: int = 500):
        self.every = every
        self.writer = None
        if log_dir and is_master():
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir=log_dir)
            except Exception:
                self.writer = None

    def update(self, head: str, step: int, force: bool = False, **scalars):
        if self.writer is None:
            return
        if not force and step % self.every != 0:
            return
        for k, v in scalars.items():
            self.writer.add_scalar(f"{head}/{k}", float(v), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()
