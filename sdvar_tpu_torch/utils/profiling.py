"""Tracing and timing helpers (the counterpart of
``sdvar_tpu/utils/profiling.py``).

``span``, ``launch`` and ``mark`` record the program's spans while a
``torch.profiler`` records, in any thread: each span's name, its host
start and end (``time.perf_counter_ns``, with the recording's
``(time.time_ns, perf_counter_ns)`` pair to map them onto the profiler's
clock), its thread, the span that encloses it and its ids (``batch``,
``rid``, ``si``). A
recorded ``span`` also opens a record-function range of its name, so that
it sits among the profiler's host events on that trace's own clock, and
on a card an NVTX range and two timing CUDA events on the current stream,
whose device milliseconds are read when ``spans()`` is called (``launch``,
around one launch of the port's own kernels, makes no events). The range
is the profiler's fast one (function scope, as an operator's): the user
scope of ``torch.profiler.record_function`` also makes the profiler add a
device-side annotation over the range's kernels, which a reader of the
device trace would count as device work. With no profiler recording,
``span`` reads one flag and returns a shared no-op context.
``spans()`` returns the latest recording's spans, held in memory; a
recording ends once ``spans()`` or ``trace`` finds the profiler stopped,
and the next span recorded starts a new one.

``trace`` records a ``torch.profiler`` trace of a block and writes it as a
Chrome trace (open it in Perfetto or ``chrome://tracing``); ``SpanTimer``
adds up named spans, timed with CUDA events on the card (device time
between the span's two events on the current stream) and with the host
clock on the CPU; ``memory_stats`` reads the allocator's live and peak
bytes of a card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"


@dataclasses.dataclass
class Span:
    """One recorded span. ``start_ns`` / ``end_ns``: ``perf_counter_ns``;
    ``parent``: the ``index`` of the span that enclosed it on its thread;
    ``device_ms``: the device time between its CUDA events on a card, its
    host time where it ran on no card, None for a ``mark`` and for a
    ``launch`` on a card."""

    name: str
    index: int
    start_ns: int
    end_ns: Optional[int]
    thread: int
    parent: Optional[int]
    ids: Dict[str, int]
    clock: Tuple[int, int]   # the recording's (time_ns, perf_counter_ns)
    device_ms: Optional[float] = None
    events: Optional[Tuple[object, object]] = dataclasses.field(
        default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def unix_start_ns(self) -> int:
        """The start on the Unix epoch clock, the profiler's."""
        return self.start_ns - self.clock[1] + self.clock[0]


class _Recording:
    def __init__(self):
        self.clock = (time.time_ns(), time.perf_counter_ns())
        self.spans: List[Span] = []
        self.count = itertools.count()
        self.over = False


_latest: Optional[_Recording] = None
_latest_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.stack: List[Span] = []   # this thread's open spans


_local = _Local()


def _recording() -> _Recording:
    global _latest
    rec = _latest
    if rec is None or rec.over:
        with _latest_lock:
            if _latest is None or _latest.over:
                _latest = _Recording()
            rec = _latest
    return rec


def _end_recording() -> None:
    """The profiler has stopped: the next span recorded starts anew."""
    rec = _latest
    if rec is not None and not _autograd_profiler._is_profiler_enabled:
        rec.over = True


def _parent(rec: _Recording) -> Optional[int]:
    stack = _local.stack
    if stack and stack[-1].clock is rec.clock:   # the same recording
        return stack[-1].index
    return None


class _SpanContext:
    """A span while the profiler records (see the module's docstring)."""

    __slots__ = ("name", "ids", "timed", "span", "fn", "card", "stream")

    def __init__(self, name: str, ids: Dict[str, int], timed: bool = True):
        self.name, self.ids, self.timed = name, ids, timed

    def __enter__(self) -> Span:
        rec = _recording()
        start = time.perf_counter_ns()   # the host span holds the range's
        self.fn = torch._C._profiler._RecordFunctionFast(self.name)
        self.fn.__enter__()
        self.card = torch.cuda.is_initialized()
        events = None
        if self.card:
            torch.cuda.nvtx.range_push(self.name)
            if self.timed:
                # one stream look-up a span: it costs as much as a record
                self.stream = torch.cuda.current_stream()
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(self.stream)
        s = self.span = Span(self.name, next(rec.count), start, None,
                             threading.get_ident(), _parent(rec), self.ids,
                             rec.clock, events=events)
        _local.stack.append(s)
        rec.spans.append(s)
        return s

    def __exit__(self, *exc) -> None:
        s = self.span
        _local.stack.pop()
        if self.card:
            if s.events is not None:
                s.events[1].record(self.stream)
            torch.cuda.nvtx.range_pop()
        self.fn.__exit__(*exc)
        end = time.perf_counter_ns()
        if not self.card:
            s.device_ms = (end - s.start_ns) / 1e6
        s.end_ns = end   # last: ``spans()`` reads closed spans only


_OFF = contextlib.nullcontext()


def span(name: str, **ids: int):
    """``with span("sdvar.decode.scale", si=3): ...``: a span of the
    enclosed work, recorded while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _SpanContext(name, ids)


def launch(name: str):
    """``with launch("sdvar.launch.<kernel>"): <one ctypes launch>``: a
    span with no CUDA events (``device_ms`` None on a card): the kernel's
    device time is in the device trace under its own name, and two events
    cost the host more than twice the launch."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _SpanContext(name, {}, timed=False)


def mark(name: str, start_ns: int, end_ns: int, **ids: int) -> None:
    """A span that started on one thread and ends on another, from its two
    ``perf_counter_ns`` readings; recorded while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    rec = _recording()
    rec.spans.append(Span(name, next(rec.count), start_ns, end_ns,
                          threading.get_ident(), _parent(rec), ids,
                          rec.clock))


def spans() -> List[Span]:
    """The latest recording's closed spans, in the order they started on
    each thread, their device milliseconds read (waiting for their CUDA
    events)."""
    _end_recording()
    rec = _latest
    if rec is None:
        return []
    out = [s for s in rec.spans if s.end_ns is not None]
    for s in out:
        if s.events is not None:
            s.events[1].synchronize()
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    return out


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace(dir): run()`` records the block (CPU ops, and the
    card's kernels where there is one) and writes ``dir/trace.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    _end_recording()
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
