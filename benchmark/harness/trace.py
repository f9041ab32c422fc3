"""The device trace of a traced run, from ``torch.profiler`` (CUPTI), reduced
in memory to what the per-layer metrics read: every device operation with
its name and length in time order, the busy seconds (the union of
the operations' intervals), the traced window's length, the device
operations that took most time, and the idle gaps named by what the host
was doing when each began."""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

_NOT_LAUNCHES = ("Memcpy", "Memset")
_RUNTIME = ("cuda", "cu")  # runtime and driver API calls on the host


@dataclass
class DeviceTrace:
    names: List[str]                 # each device operation, in start order
    durs: List[float]                # seconds
    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def launches(self) -> int:
        """Kernel launches (copies and memsets left out)."""
        return sum(n for name, (_, n) in self.by_name.items()
                   if not name.startswith(_NOT_LAUNCHES))

    def seconds_where(self, pred) -> float:
        return sum(t for name, (t, _) in self.by_name.items() if pred(name))

    def durations_of(self, pred) -> List[float]:
        """Each matching operation's length, in launch order."""
        return [d for n, d in zip(self.names, self.durs) if pred(n)]

    def device_ops(self, top: int = 10) -> List[List]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:top]
        return [[name[:160], t] for name, (t, _) in ops]


class Tracer:
    """``start()`` / ``stop()`` around the traced work; ``stop`` waits
    for the card and reduces the trace."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = 0.0

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:  # also the threads started before the trace (a server's)
            cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        except TypeError:
            cfg = None
        self.prof = torch.profiler.profile(activities=acts,
                                           experimental_config=cfg)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        events = self.prof.profiler.kineto_results.events()
        self.prof = None
        return reduce_events(events, window_s)


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def reduce_events(events, window_s: float) -> DeviceTrace:
    dev, host = [], []
    for e in events:
        if _is_device(e):
            name = e.name()
            if "Sync" in name:  # CUPTI's synchronisation markers
                continue
            dev.append((e.start_ns(), e.duration_ns(), name,
                        e.correlation_id()))
        else:
            host.append(e)
    dev.sort()
    if not dev:
        return DeviceTrace([], [], window_s, 0.0)
    names = [d[2] for d in dev]
    starts = [(d[0] - dev[0][0]) * 1e-9 for d in dev]
    durs = [d[1] * 1e-9 for d in dev]
    busy, cur_s, cur_e = 0.0, None, None
    for s, d in zip(starts, durs):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, s + d
        else:
            cur_e = max(cur_e, s + d)
    busy += cur_e - cur_s
    by_name: Dict[str, Tuple[float, int]] = {}
    for n, d in zip(names, durs):
        t, c = by_name.get(n, (0.0, 0))
        by_name[n] = (t + d, c + 1)
    gaps = _idle_gaps(dev, host)
    return DeviceTrace(names, durs, window_s, busy, by_name, gaps)


def _idle_gaps(dev, host, top: int = 10, min_ns: int = 2000
               ) -> List[Tuple[str, float]]:
    """Idle time between device operations, summed by what the host was
    doing: the innermost host operation around the launch of the device
    operation that ends the gap; where the profiler recorded no operation
    around that launch (a kernel called through ctypes, or a thread that
    was started before the profiler), the launch call and the device
    operation it launched."""
    launch = {}
    ops_by_thread: Dict[int, List] = {}
    for e in host:
        name = e.name()
        if name.startswith(_RUNTIME):
            launch[e.correlation_id()] = (e.start_thread_id(), e.start_ns(),
                                          name)
            continue
        ops_by_thread.setdefault(e.start_thread_id(), []).append(
            (e.start_ns(), e.start_ns() + e.duration_ns(), name))
    starts_by_thread = {}
    for tid, ops in ops_by_thread.items():
        ops.sort()
        starts_by_thread[tid] = [o[0] for o in ops]

    def innermost(corr, kernel: str) -> str:
        if corr not in launch:
            return "(no launch recorded)"
        tid, t, api = launch[corr]
        ops = ops_by_thread.get(tid, [])
        i = bisect.bisect_right(starts_by_thread.get(tid, []), t) - 1
        for j in range(i, max(i - 4000, -1), -1):
            if ops[j][0] <= t < ops[j][1]:
                return ops[j][2]
        return f"{api} of {kernel[:100]}"

    sums: Dict[str, float] = {}
    end = dev[0][0] + dev[0][1]
    for s, d, kernel, corr in dev[1:]:
        if s - end >= min_ns:
            name = innermost(corr, kernel)
            sums[name] = sums.get(name, 0.0) + (s - end) * 1e-9
        end = max(end, s + d)
    return sorted(sums.items(), key=lambda kv: -kv[1])[:top]
