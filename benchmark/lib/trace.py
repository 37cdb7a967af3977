"""A bounded slice of a run under `torch.profiler` (CUPTI on the card):
the device operations with their times, the host operations beside them,
and the host clock mapped onto the trace's.

Host spans are taken with `time.time_ns()`. The profile starts with the
device idle and then launches one short marker kernel at a known host
time: its record gives the offset from the host clock to the trace's
(within a launch's latency, some microseconds). The marker is found by
its name, since a trace can lose records (a process's third and later
profiles lost the marker every time); without it the first device
operation stands in, which moves the slice later.
"""
from __future__ import annotations

import time
from bisect import bisect_left
from dataclasses import dataclass, field

MARKER = "spin_kernel"          # the kernel of torch.cuda._sleep


@dataclass
class Slice:
    t0: int                      # trace clock, ns
    t1: int
    device: list                 # (start, end, name), sorted by start
    host: list                   # (start, end, name)
    offset: int = 0              # trace clock - host clock, ns
    spans: list = field(default_factory=list)   # the clients' own

    def __post_init__(self):
        self._starts = [d[0] for d in self.device]

    def host_ns(self, t_host: int) -> int:
        return t_host + self.offset

    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def ops_between(self, a: int, b: int) -> list:
        """Device operations starting in [a, b) (trace clock)."""
        return self.device[bisect_left(self._starts, a):
                           bisect_left(self._starts, b)]

    def busy_s(self, a: int | None = None, b: int | None = None) -> float:
        """Seconds in [a, b) in which some device operation ran."""
        a = self.t0 if a is None else a
        b = self.t1 if b is None else b
        busy, end = 0, a
        for s, e, _ in self.device:
            s, e = max(s, end), min(e, b)
            if e > s:
                busy += e - s
                end = e
        return busy / 1e9

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for s, e, name in self.device:
            if s >= self.t0 and s < self.t1:
                key = name[:160]
                total[key] = total.get(key, 0) + (e - s)
        return [[k, v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest gaps with no device operation, each named by the
        innermost host operation or span running at its middle."""
        gaps, end = [], self.t0
        for s, e, _ in self.device:
            if s > end:
                gaps.append((s - end, end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((self.t1 - end, end, self.t1))
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:n]:
            mid = (a + b) // 2
            around = [(e - s, name) for s, e, name in
                      self.host + [(self.host_ns(s), self.host_ns(e), nm)
                                   for s, e, nm in self.spans]
                      if s <= mid < e]
            label = min(around)[1] if around else "no host operation traced"
            out.append([label[:160], length / 1e9])
        return out


class Profiler:
    """Start and stop a profile of `device` (the host alone on the CPU);
    `stop()` returns the Slice. Where other threads run the program,
    start and stop it while they are held still (a profile stopped while
    the serving loop's thread launched work hung once in three runs)."""

    def __init__(self, device, host_ops: bool = True):
        self._prof = None
        self._cuda = device.type == "cuda"
        self._host_ops = host_ops

    def _sync(self) -> None:
        import torch

        if self._cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        """Enable the profiler through the calls `torch.profiler` makes,
        so that stopping it hands back the raw events without building
        Python event objects (seconds for a slice of serving)."""
        import torch
        from torch.autograd import profiler as ap

        self._sync()
        self._prof = ap.profile(use_device="cuda" if self._cuda else None,
                                use_kineto=True)
        acts = set(self._prof.kineto_activities)
        if self._cuda and not self._host_ops:
            acts.discard(torch.autograd.ProfilerActivity.CPU)
        cfg = self._prof.config()
        ap._prepare_profiler(cfg, acts)
        ap._enable_profiler(cfg, acts)
        self._clock = time.time_ns()
        if self._cuda:
            torch.cuda._sleep(1000)         # the clock's marker
            self._sync()
        self._t0 = time.time_ns()

    def stop(self) -> Slice:
        import torch

        from torch.autograd import profiler as ap

        self._sync()
        t1 = time.time_ns()
        result = ap._disable_profiler()
        device, host = [], []
        for ev in result.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type() == torch.autograd.DeviceType.CUDA:
                device.append((s, e, ev.name()))
            else:
                host.append((s, e, ev.name()))
        device.sort()
        marker = next((d for d in device if MARKER in d[2]),
                      device[0] if device else None)
        offset = marker[0] - self._clock if marker else 0
        self._prof = None
        return Slice(t0=self._t0 + offset, t1=t1 + offset, device=device,
                     host=host, offset=offset)
