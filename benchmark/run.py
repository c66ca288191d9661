"""The benchmark of ``hevc_tpu_torch``: one cell, one run.

    python -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

A cell (``BENCHMARK.json``'s ``workloads``) is a configuration under a
traffic mix.  The run reads the cell's bank of encoded segments, draws from
the seed the order in which it decodes them, and sets up: the program's
builds (nvcc, g++) on a checkout's first run, the bank's first segment
decoded once through a handle of its own, the caching allocator emptied,
then the window's handle.  The window is closed loop, one client: the
next access unit is handed to ``decode`` as soon as the last call
returned, looping over the drawn sequence, for ``--seconds``.  Every picture returned is
copied to host memory.

With ``--trace 0`` the result carries the cell's end-to-end metrics:
``decode_fps`` (pictures of the target layer returned and on the host in
the window, over its seconds), ``picture_latency_p95_ms`` (over every
picture of the window: from the ``decode`` call that handed in its access
unit to the return that delivered its planes) and ``setup_s`` (process
start to window start).  With ``--trace 1`` it carries the per-layer
metrics: the program's spans from the window's start, per access unit
handed in, until a segment boundary past 40% of the window; then one whole
segment under ``torch.profiler``, where the window ends.

After the window the handle is drained and closed, the program's state
freed, and every plane of every picture it delivered is compared with the
plain reference's (``check.py``, ``refcache.py``).  The last line of
standard output is the result as JSON; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last key.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from . import bank, check, devtrace, refcache

# the fixed cache directories of everything the run builds or compiles
CACHE_ENV = {
    "TRITON_CACHE_DIR": os.path.join(bank.BUILD, "triton"),
    "TORCH_EXTENSIONS_DIR": os.path.join(bank.BUILD, "torch_extensions"),
    "CUDA_CACHE_PATH": os.path.join(bank.BUILD, "cuda_cache"),
}
FORBIDDEN = ("jax", "jaxlib", "flax", "hevc_tpu")
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PROFILE_AFTER = 0.4  # share of the window before the profiled segment


def process_age() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class Cell:
    name: str
    layers: int
    segments: List[bank.Segment]
    mix: dict
    end_to_end: List[str]
    per_layer: List[str]
    chips: int = 1
    out_bytes: int = 0  # one output picture's planes, in bytes


def load_cell(name: str) -> Cell:
    m = bank.manifest()
    w = bank.workload(name)
    cfg = bank.config(w["config"])

    def reports(metric):
        return name in metric.get("workloads", [name])

    top = cfg["encoder"]["layers"][-1] if cfg["layers"] > 1 \
        else cfg["encoder"]
    sample = 1 if top["bit_depth"] <= 8 else 2
    return Cell(name=name, layers=cfg["layers"],
                segments=bank.load_bank(w["config"], w["traffic"]),
                mix=bank.traffic(w["traffic"]),
                end_to_end=[x["name"] for x in m["end_to_end"]
                            if reports(x)],
                per_layer=[x["name"] for x in m["per_layer"] if reports(x)],
                chips=w["chips"],
                out_bytes=top["width"] * top["height"] * 3 // 2 * sample)


@dataclass
class Window:
    fed: list = field(default_factory=list)        # (segment, au) by pts
    pictures: list = field(default_factory=list)   # (pts, planes, bd)
    latency_s: list = field(default_factory=list)
    seconds: float = 0.0
    spans: Optional[dict] = None    # the program's spans before profiling
    span_aus: int = 0               # access units handed in meanwhile
    profile: Optional[dict] = None


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def drive(prog, cell: Cell, sequence: List[int], seconds: float,
          trace: bool, device) -> Window:
    """The timed window: closed loop over ``sequence``'s access units."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import program as P
    win = Window()
    t_in: List[float] = []
    prof = prof_seg = None
    P.spans_reset()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    for k, i, au in bank.feed(cell.segments, sequence):
        now = time.perf_counter()
        if i == 0 and trace:
            if prof is not None:  # the profiled segment is whole
                _sync(device)
                t1 = time.perf_counter()
                prof.stop()
                win.profile = {"prof": prof, "window_s": t1 - tp,
                               "segment": prof_seg}
                break
            if now - t0 >= PROFILE_AFTER * seconds:
                win.spans, win.span_aus = P.spans(), len(win.fed)
                acts = [ProfilerActivity.CPU]
                if torch.device(device).type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                prof_seg = k
                tp = time.perf_counter()
        elif now >= deadline + (2 * seconds if trace else 0):
            break  # a traced run stops here only if it never profiled
        pts = len(win.fed)
        win.fed.append((k, i))
        t_in.append(time.perf_counter())
        if prof is not None:
            with record_function("decode_au"):
                out = prog.decode(au, pts)
        else:
            out = prog.decode(au, pts)
        if out:
            done = time.perf_counter()
            for pic in out:
                win.latency_s.append(done - t_in[pic[0]])
            win.pictures += out
    win.seconds = time.perf_counter() - t0
    return win


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def per_layer_metrics(cell: Cell, win: Window, device,
                      trace_dir: str) -> tuple:
    """(metrics, device additions, breakdown) of a traced run."""
    least_s = busy = None
    extra, breakdown = {}, None
    if win.profile is not None:
        path = os.path.join(trace_dir, f"{cell.name}.json")
        os.makedirs(trace_dir, exist_ok=True)
        win.profile["prof"].export_chrome_trace(path)
        red = devtrace.reduce(path)
        busy = red["busy_s"]
        seg = cell.segments[win.profile["segment"]]
        least_s = (sum(len(a) for a in seg.aus)
                   + len(seg.aus) * cell.out_bytes) / PEAK_BYTES_PER_S
        extra = {"busy_s": busy, "window_s": win.profile["window_s"]}
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
    ctx = {"spans": win.spans or {}, "pictures": win.span_aus,
           "busy_s": busy,
           "window_s": win.profile["window_s"] if win.profile else None,
           "least_s": least_s}
    readers = bank.metric_readers(cell.per_layer)
    units = {m["name"]: m["unit"] for m in bank.manifest()["per_layer"]}
    metrics = {}
    for name, read in readers.items():
        v = read(ctx)
        if v is not None:
            metrics[name] = {"value": v, "unit": units.get(name, "")}
    return metrics, extra, breakdown


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device="cuda",
             make_program: Optional[Callable] = None) -> dict:
    """One run of a cell; returns the result (without printing it)."""
    if make_program is None:
        from .program import Program as make_program
    import torch
    phases = {"start": process_age()}  # imports, the bank, the card check
    sequence = bank.draw_sequence(cell.mix, len(cell.segments), seed)
    torch.zeros(1, device=device)
    _sync(device)
    phases["context"] = process_age()
    # set-up: builds on a checkout's first run, then one segment through a
    # handle of its own (every segment of a bank has the same picture size
    # and the same picture types, so one warms every shape the window
    # uses); then the caching allocator is emptied, so that the window
    # starts with the device memory a fresh process has (the handle's
    # device memory grows with every picture it decodes, and whatever the
    # warm-up left cached made the number of cudaMalloc calls in the window
    # differ from run to run)
    if getattr(make_program, "warm_up", True):
        warm = make_program(cell.layers, device)
        for pts, au in enumerate(cell.segments[0].aus):
            warm.decode(au, pts)
            if pts == 0:  # the program's builds, on a first run
                phases["first_picture"] = process_age()
        warm.close()
        del warm
    _sync(device)
    if torch.device(device).type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
    phases["warm_up"] = process_age()
    prog = make_program(cell.layers, device)
    setup_s = process_age()
    print("setup: " + ", ".join(f"{k} at {v:.2f} s"
                                for k, v in phases.items())
          + f", window at {setup_s:.2f} s", file=sys.stderr, flush=True)
    win = drive(prog, cell, sequence, seconds, trace, device)
    peak = 0
    if torch.device(device).type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(device))
    tail = prog.close()  # drain: the pictures still in flight
    del prog
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    result = {"correct": False, "attempted": len(win.fed), "failed": 0}
    if trace:
        metrics, extra, breakdown = per_layer_metrics(
            cell, win, device, os.path.join(bank.BUILD, "trace"))
    else:
        n = len(win.latency_s)
        metrics = {
            "decode_fps": {"value": n / win.seconds, "unit": "pictures/s"},
            "picture_latency_p95_ms": {
                "value": _percentile(win.latency_s, 95) * 1e3 if n else None,
                "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items()
                   if k in cell.end_to_end and v["value"] is not None}
        extra, breakdown = {}, None

    # the comparison, after the window and with the program's state freed
    pics = win.pictures + tail
    with ThreadPoolExecutor(8) as pool:
        digests = list(pool.map(lambda p: check.plane_digests(p[1], p[2]),
                                pics))
    delivered: Dict[int, list] = {}
    for (pts, _, _), d in zip(pics, digests):
        delivered.setdefault(pts, []).append(d)
    used = sorted({k for k, _ in win.fed})
    ref = refcache.digests([cell.segments[k] for k in used],
                           cell.layers - 1, os.cpu_count() or 1)
    numbers, failed = check.judge(win.fed, delivered, ref)
    result.update(correct=check.is_correct(numbers), failed=failed,
                  metrics=metrics)
    result["device"] = device_info(device, cell.chips, peak, extra)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


def device_info(device, chips: int, peak: int, extra: dict) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    info.update(extra)
    return info


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None, program=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ.update(CACHE_ENV)
    cell = load_cell(a.workload)
    import torch
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), "
              f"this machine has {count}", file=sys.stderr)
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                      make_program=program)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
