"""The traced run: torch.profiler on the card and the program's spans.

`Tracer` wraps the measured window when `--trace 1` is given: it turns on
the program's span recorder (observe/spans.py) and a torch.profiler of
CUDA activity, and marks the window's start on both clocks with a tiny
`spin_kernel` launched right after a synchronise, so that a device
timestamp maps to the host's perf_counter.  `summary` reduces both to
what the per-layer readers take: the card's busy seconds (the union of
its kernels and copies inside the window), device seconds by kernel
name, the spans' seconds by name, and the breakdown the result carries:
the ten device operations that took most time and the ten longest idle
gaps, each named by the host span that was open at its middle.
"""
from __future__ import annotations

import time
from collections import defaultdict

DRAINS = ("pipeline.drain", "window.drain")


class Tracer:
    def __init__(self, on: bool, cuda: bool):
        self.on = on
        self.cuda = cuda
        self.prof = None
        self.roots: list = []
        self.t_mark = None

    def __enter__(self):
        if not self.on:
            return self
        from ouroboros_tpu_torch.observe import spans
        self._spans = spans
        spans.RECORDER.drain()
        spans.RECORDER.enable()
        if self.cuda:
            import torch
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        if self.prof is not None:
            import torch
            torch.cuda.synchronize()
            self.prof.__exit__(*exc)
        self.roots = self._spans.RECORDER.drain()
        self._spans.RECORDER.disable()
        return False

    def _device_events(self) -> list:
        """[(name, t0, t1)] of the card's activity on the host clock.
        Read from the profiler's raw records: building its Python event
        tree takes minutes for a window of a million launches."""
        from torch.autograd import DeviceType
        evs = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        marks = [t0 for name, t0, _t1 in evs if "spin_kernel" in name]
        if not marks:
            return []
        mark = min(marks)
        return [(name, self.t_mark + (t0 - mark) / 1e9,
                 self.t_mark + (t1 - mark) / 1e9)
                for name, t0, t1 in evs if "spin_kernel" not in name]

    def summary(self, t0: float, t1: float) -> dict:
        """The traced window [t0, t1] (host perf_counter) reduced."""
        spans = defaultdict(float)
        flat = []
        for root in self.roots:
            for sp in root.walk():
                if sp.t1 is None:
                    continue
                spans[sp.name] += sp.duration
                flat.append(sp)
        out = {"spans": dict(spans), "busy_s": None, "kernel_s": {}, "device_ops": [],
               "idle_gaps": []}
        if self.prof is None:
            return out
        evs = [(n, max(a, t0), min(b, t1)) for n, a, b
               in self._device_events() if b > t0 and a < t1]
        if not evs:
            return out
        by_name = defaultdict(float)
        for name, a, b in evs:
            by_name[name] += b - a
        busy = []
        for _n, a, b in sorted(evs, key=lambda e: e[1]):
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        gaps = [(b0[1], b1[0]) for b0, b1 in zip(busy, busy[1:])]
        if busy:
            gaps = [(t0, busy[0][0])] + gaps + [(busy[-1][1], t1)]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        out["busy_s"] = sum(b - a for a, b in busy)
        out["kernel_s"] = dict(by_name)
        out["device_ops"] = [[name[:64], s] for name, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        out["idle_gaps"] = [[_host_span_at((a + b) / 2, flat), b - a]
                            for a, b in gaps if b > a]
        return out


def _host_span_at(t: float, flat: list) -> str:
    """The innermost span open at t, drains (the consumer's wait) last."""
    open_ = [sp for sp in flat if sp.t0 <= t <= sp.t1]
    work = [sp for sp in open_ if sp.name not in DRAINS]
    pick = max(work or open_, key=lambda sp: sp.t0, default=None)
    return pick.name if pick is not None else "no span (between passes)"
