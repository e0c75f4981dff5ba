"""Device choice for the port's entry points, and device timing.

The port runs on the CUDA card by default.  There is no silent fallback:
without a card, `default_device()` raises, and only an explicit
`device="cpu"` runs the plain PyTorch versions on the host.

`kernel_ms` times one kernel's launches on the card (torch.profiler's
CUDA activity); `event_ms` times a call between two CUDA events, which
also holds the host time of its launches (argument checks, allocation,
the ctypes call); `host_us` times that host part alone; `profiled`
traces a whole call and gives the card's busy seconds in it.
"""
from __future__ import annotations

import statistics
import time

import torch


def default_device() -> torch.device:
    """The CUDA card; raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain PyTorch "
            "versions on the host")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for, but none is present")
    return dev


def device_kind(device=None) -> str:
    """Name of the device the port runs on (the card's marketing name)."""
    dev = resolve(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def stage(arrays, device: torch.device) -> list:
    """Host numpy arrays -> tensors on `device`, in order."""
    return [torch.from_numpy(a).to(device) for a in arrays]


def event_ms(fn, reps: int = 7, warm: int = 1) -> float:
    """Median milliseconds of fn() between two CUDA events recorded on the
    current stream before and after it, over `reps` calls after `warm`
    untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps: int = 200, warm: int = 2) -> float:
    """Median host microseconds of one fn() call (time.perf_counter_ns
    around the call alone), over `reps` calls after `warm` untimed ones.
    The card is synchronised after each call, outside the timed span, so
    every call starts on an idle queue: what is timed is the host's own
    work of the call (for a wrapper: checks, allocation, the launch)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
    return statistics.median(times) / 1e3


def kernel_ms(fn, kernel: str, reps: int = 7, warm: int = 2,
              traces: int = 5) -> tuple[float, str]:
    """Median device milliseconds of the CUDA kernel whose name holds
    `kernel` (a `__global__` function's name), over `reps` calls of fn()
    that launch it once each, after `warm` untimed calls: its durations
    from torch.profiler's CUDA activity (the JAX probe's discipline, on
    device time).

    A trace should hold the kernel's `reps` launches and no other device
    activity.  CUPTI can hand a trace's records over late, so that a
    trace holds none or some of them; such a trace is taken again, up to
    `traces` times.  Returns (ms, "profiler"), the label naming the trace
    that was clean where it was not the first; where none was, the first
    that held launches of the kernel, labelled with its counts (other
    device activity left out); where none held any, (event_ms(fn),
    "events"), which holds host time too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    partial = None
    for trace in range(1, traces + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        mine = [(e.time_range.end - e.time_range.start) / 1e3
                for e in dev if kernel in e.name]
        if len(mine) == reps == len(dev):
            src = "profiler" if trace == 1 else \
                f"profiler (trace {trace} of {traces})"
            return statistics.median(mine), src
        if mine and partial is None:
            partial = (statistics.median(mine),
                       f"profiler ({len(mine)} launches in {reps} calls, "
                       f"{len(dev) - len(mine)} other device events left "
                       f"out; no clean trace in {traces})")
    return partial or (event_ms(fn, reps, warm=0), "events")


def profiled(fn, cuda: bool, top: int = 12):
    """fn() under torch.profiler, tracing the card's activity only (CUDA
    kernels and copies; the host's on the CPU).  Returns (fn's result,
    the card's busy seconds: the union of the traced device intervals,
    and the `top` names by total device milliseconds as [name, ms,
    count])."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        out = fn()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name = [[e.key[:90], e.self_device_time_total / 1e3, e.count]
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    by_name.sort(key=lambda r: -r[1])
    return out, busy_us / 1e6, by_name[:top]
