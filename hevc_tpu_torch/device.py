"""Device resolution for the port.

The port runs its frame program on a CUDA device.  The CPU device exists
so that the tests can run the plain PyTorch versions of the kernels; it
is never chosen implicitly.
"""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """Return the torch device the port runs on.

    ``None`` means ``cuda``.  A CUDA device without a visible card raises;
    ``"cpu"`` must be asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hevc_tpu_torch: CUDA is not available; pass device='cpu' "
                "to run the plain PyTorch versions of the kernels")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"hevc_tpu_torch: unsupported device {dev}")
    return dev


def max_sm_clock_mhz() -> float:
    """The first card's highest SM clock in MHz, as ``nvidia-smi`` reads
    it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def profiler_ms(fn, name=None, iters: int = 20, warmup: int = 3):
    """Mean device time in ms of the kernels whose name contains ``name``
    (of every kernel and copy, when ``name`` is None) per call of fn(),
    over ``iters`` calls traced by ``torch.profiler`` after ``warmup``
    calls; None when the trace holds no device time for such a kernel."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) or 0
             for e in prof.key_averages() if name is None or name in e.key)
    return us / 1e3 / iters if us > 0 else None


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over ``iters`` calls, from CUDA
    events on the current stream, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters
