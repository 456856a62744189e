"""Kernel timing on a CUDA card, by CUDA events.

`device_ms` is a kernel's device time: events around a burst of
back-to-back launches queued behind a sleep kernel, so the host's
launch cost is hidden.  `call_ms` is the time of one call on an idle
device, the wrapper's host work included.  Used by chip_smoke.py; needs
a card.
"""

from __future__ import annotations

import time

import torch


def call_ms(fn, reps=20):
    """Median milliseconds of one call of `fn`, CUDA events around it on
    an idle device: the wrapper's host work is counted too."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


_SLEEP = {}


def sleep_cycles_per_ms():
    """Cycles of torch.cuda._sleep that take one millisecond of device
    time on this card (measured once)."""
    if "rate" not in _SLEEP:
        torch.cuda._sleep(1_000_000)  # warm-up
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(20_000_000)
        e1.record()
        e1.synchronize()
        _SLEEP["rate"] = 20_000_000 / e0.elapsed_time(e1)
    return _SLEEP["rate"]


def device_ms(fn, n=40, bursts=5):
    """(device ms per call, host us per call) of `fn`.

    CUDA events around a burst of `n` back-to-back calls, divided by n,
    median over `bursts`.  Each burst is queued behind a sleep kernel
    twice as long as its host enqueue time, so the device runs the n
    calls without waiting for the host: the time is the device's alone.
    The host time is the enqueue time per call (wrapper included).  A
    call that synchronises with the host (the plain versions may)
    drains the queue, and its time then includes the host's.  Operands
    stay warm in L2 between calls, as they are on the main path, where
    the producing stage has just written them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    cycles = int(2 * host_s * 1e3 * sleep_cycles_per_ms()) + 100_000
    dev, host = [], []
    for _ in range(bursts):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        host.append((time.perf_counter() - t) / n * 1e6)
        e1.record()
        e1.synchronize()
        dev.append(e0.elapsed_time(e1) / n)
    dev.sort()
    host.sort()
    return dev[bursts // 2], host[bursts // 2]
