"""Tracing and timing helpers (the counterpart of
``sdvar_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace of a block and writes it as a
Chrome trace (open it in Perfetto or ``chrome://tracing``); ``annotate``
names a region inside such a trace (``record_function``, and an NVTX range
where a card is present); ``SpanTimer`` adds up named spans, timed with
CUDA events on the card (device time between the span's two events on the
current stream) and with the host clock on the CPU; ``memory_stats`` reads
the allocator's live and peak bytes of a card.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace(dir): run()`` records the block (CPU ops, and the
    card's kernels where there is one) and writes ``dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region on the trace's timeline (and an NVTX range on the
    card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


class SpanTimer:
    """Named spans, added up.

        t = SpanTimer(device)
        with t.span("forward"):
            ...
        t.report()   # {"forward": {"total_s", "count", "mean_ms"}, ...}

    On a CUDA device a span records an event on the current stream at
    each end, and ``report`` waits for the last event and sums the
    device time between each pair (no synchronisation inside the timed
    work); on the CPU a span reads the host clock at each end."""

    def __init__(self, device=None):
        dev = torch.device(device) if device is not None else torch.device("cpu")
        self.cuda = dev.type == "cuda"
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._events: List[Tuple[str, object, object]] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._events.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def _collect(self) -> None:
        if self._events:
            self._events[-1][2].synchronize()
            for name, start, end in self._events:
                self._add(name, start.elapsed_time(end) / 1e3)
            self._events.clear()

    def report(self) -> Dict[str, Dict[str, float]]:
        """Per span: the total seconds, the count and the mean ms, the
        longest total first."""
        self._collect()
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_ms": 1e3 * v / max(self.counts[k], 1)}
                for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])}


def memory_stats(device: Optional[object] = None) -> Dict[str, int]:
    """Live and peak bytes the caching allocator holds for tensors on a
    card, and the card's size: {"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit"}; {} for the CPU, which keeps no such statistics."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory)}
