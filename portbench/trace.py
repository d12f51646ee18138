"""Spans and the device trace of a traced run (``--trace 1``).

Spans are placed from the benchmark's side, around the calls it makes
into the program's layers (the session's step, an admission's prefill,
a decode wave, the benchmark's own client work): each records the host
clock, a pair of CUDA events (the device time of the work it enqueued,
read once the window has closed, so no span synchronises), and a
``record_function`` range, so that the profiler's timeline shows what
the host was doing when the device sat idle.

``Profile`` runs ``torch.profiler`` over a part of the window and reduces
it to the device's busy time (the union of its operations), the time of
each operation by name, and the longest idle gaps, each named by the
innermost span the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
import time

import torch

SPANS = ("step", "admit/prefill", "wave", "client")


class Spans:
    """Host-clock and CUDA-event spans, kept in memory."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.records: dict[str, list] = {name: [] for name in SPANS}

    @contextlib.contextmanager
    def span(self, name: str, info=None):
        with torch.profiler.record_function(name):
            ev = None
            if self.cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t0 = time.perf_counter()
            try:
                yield
            finally:
                t1 = time.perf_counter()
                if ev is not None:
                    ev[1].record()
                self.records[name].append((t0, t1, ev, info))

    def wrap(self, name: str, fn, info=None):
        """``fn`` with a span around each call; ``info(*args)`` is kept
        with it."""
        def wrapped(*args, **kwargs):
            with self.span(name, info(*args) if info else None):
                return fn(*args, **kwargs)
        return wrapped

    def between(self, name: str, t0: float, t1: float) -> list:
        """``(device seconds, info)`` of the spans that began in
        ``[t0, t1)`` (device seconds None off the card)."""
        out = []
        for a, _, ev, info in self.records[name]:
            if t0 <= a < t1:
                sec = ev[0].elapsed_time(ev[1]) / 1e3 if ev else None
                out.append((sec, info))
        return out


class Profile:
    """``torch.profiler`` over ``[start, stop]`` of the host clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.t0 = self.t1 = None

    @staticmethod
    def warm() -> None:
        """Start and stop a profile once, so that the profiler's own
        set-up (tens of seconds the first time in a process) falls
        outside the window."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def _events(self):
        """``(start, end, name, on_device)`` of every event, in ns: the
        profiler's raw records where it offers them (building its event
        objects takes about 90 us an event, minutes for a traced serving
        window), else its event list."""
        from torch.autograd import DeviceType
        raw = getattr(self.prof.profiler, "kineto_results", None)
        if raw is not None:
            for e in raw.events():
                yield (e.start_ns(), e.start_ns() + e.duration_ns(),
                       e.name(), e.device_type() == DeviceType.CUDA)
            return
        for e in self.prof.events():
            yield (e.time_range.start * 1e3, e.time_range.end * 1e3,
                   e.name, e.device_type == DeviceType.CUDA)

    def reduce(self, top: int = 10) -> dict:
        """Busy seconds, seconds and calls by operation, longest idle
        gaps."""
        ops, hosts = [], []
        for a, b, name, on_device in self._events():
            if name in SPANS:
                # the spans' ranges show on the device's timeline too
                if not on_device:
                    hosts.append((a, b, name))
            elif on_device:
                ops.append((a, b, name))
        ops.sort()
        by_name: dict[str, float] = {}
        calls: dict[str, int] = {}
        for a, b, name in ops:
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
            calls[name] = calls.get(name, 0) + 1
        busy, gaps, end = 0.0, [], None
        for a, b, _ in ops:
            if end is None or a > end:
                if end is not None:
                    gaps.append((end, a))
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[_host_at(hosts, a), (b - a) / 1e9] for a, b in gaps[:top]]
        return dict(window_s=self.t1 - self.t0, busy_s=busy / 1e9,
                    ops=by_name, calls=calls, n_ops=len(ops),
                    device_ops=[[n[:120], s] for n, s in sorted(
                        by_name.items(), key=lambda kv: -kv[1])[:top]],
                    idle_gaps=named)


def _host_at(hosts: list, t: float) -> str:
    """The innermost span covering ``t`` ("none" outside every span)."""
    inside = [(b - a, name) for a, b, name in hosts if a <= t <= b]
    return min(inside)[1] if inside else "none"
