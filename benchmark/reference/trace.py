"""Lightweight section tracer / profiler.

The reference exposes only gprof (-pg) and the CLI fps line
(/root/reference/CMakeLists.txt:193-199, ohplay.c:377); this module is
the integrated replacement: named wall-clock accumulators around the
decode pipeline's stages (native stage A, host pack, device launch,
fetch), cheap enough to stay compiled in.

Usage:
    from hevc_tpu import trace
    with trace.span("stage_a"):
        ...
    trace.report()   # {"stage_a": {"calls": N, "total_s": ...}, ...}

Enabled by default (overhead is two perf_counter calls per span);
`trace.reset()` clears accumulators.  `HEVC_TPU_TRACE=1` additionally
prints a per-span line on every report() call.

Frozen copy of ``hevc_tpu_torch/trace.py`` at ee5ffe9.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

_acc = defaultdict(lambda: [0, 0.0])  # name -> [calls, total_s]


@contextmanager
def span(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        a = _acc[name]
        a[0] += 1
        a[1] += time.perf_counter() - t0


def add(name: str, seconds: float, calls: int = 1) -> None:
    a = _acc[name]
    a[0] += calls
    a[1] += seconds


def reset() -> None:
    _acc.clear()


def report() -> dict:
    out = {k: {"calls": v[0], "total_s": round(v[1], 6)}
           for k, v in sorted(_acc.items())}
    if os.environ.get("HEVC_TPU_TRACE"):
        for k, v in out.items():
            per = v["total_s"] / max(v["calls"], 1) * 1e3
            print(f"[trace] {k}: {v['calls']} calls, "
                  f"{v['total_s']:.3f}s total, {per:.2f} ms/call")
    return out
