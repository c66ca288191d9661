"""Reduction of a ``torch.profiler`` chrome trace of a slice of the window:
device-busy time, the device operations that took most time, and the
longest idle gaps of the device named by the host events that cover them.

``busy_s`` is the union of the device's activity intervals (kernels,
copies, sets), the arithmetic of ``hevc_tpu_torch.bench.busy_ms`` copied
here.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import List, Tuple

# the kinds of device activity in a torch.profiler trace that keep the
# card busy
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host-side events that can say what the host was doing during a gap
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")
TOP = 10


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(trace_path: str) -> dict:
    """{"busy_s", "device_ops", "idle_gaps"} of the trace; "busy_s" is
    None when the trace holds no device activity."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if not dev:
        return {"busy_s": None, "device_ops": [], "idle_gaps": []}
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev])
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in events)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]),
                  key=lambda g: g[0] - g[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_host_doing(host, a, b), (b - a) / 1e6]
                          for a, b in gaps]}


def _host_doing(host: list, a: float, b: float) -> str:
    """The innermost host event of each thread that covers the gap's
    middle, joined."""
    mid = (a + b) / 2
    inner = {}
    for e in host:
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        if t0 <= mid <= t1:
            tid = e.get("tid")
            if tid not in inner or float(e["dur"]) < float(inner[tid]["dur"]):
                inner[tid] = e
    if not inner:
        return "no host event"
    return " | ".join(inner[t]["name"] for t in sorted(inner, key=str))
