"""Decoder CLI of the PyTorch/CUDA port (counterpart of ``hevc_tpu.cli``).

Decodes an Annex-B stream (or MP4 / MPEG-TS) with ``TorchDecoder`` (or a
NumPy backend, ``-b``), optionally writes the raw YUV, checks the SEI
decoded-picture hashes and prints ``frame= N fps= F time= T``.

Usage: python -m hevc_tpu_torch.cli -i in.265 [-o out.yuv] [-c]
       [-b torch|inline|plan] [--device cuda] [--trace-out t.json]

The pictures written are those of the highest layer decoded (up to
``-l``): of the API's selection (``api.LayerSelect``), only the top
layer's, so that every picture of the raw output has one size.

``--trace-out`` decodes access unit by access unit, as the API does (each
unit's index is its pictures' id), under ``torch.profiler`` (the CPU, and
CUDA on a card) with the program's timeline on, and writes one chrome
trace: the profiler's events and kernels with the program's spans of
every thread and its counters (``trace.export_chrome``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-o", "--output", help="raw YUV output path")
    ap.add_argument("-c", "--no-md5", action="store_true",
                    help="disable SEI decoded-picture-hash checking")
    ap.add_argument("-v", "--log-level", type=int, default=30)
    ap.add_argument("-b", "--backend", default="torch",
                    choices=["torch", "inline", "plan"],
                    help="reconstruction backend (torch = the frame "
                         "program on --device)")
    ap.add_argument("-n", "--frames", type=int, default=0,
                    help="stop after N frames (0 = all)")
    ap.add_argument("-l", "--layer", type=int, default=63,
                    help="maximum quality (SHVC) layer id to decode")
    ap.add_argument("-t", "--temporal-layer", type=int, default=7,
                    help="maximum temporal layer id to decode")
    ap.add_argument("--device", default="cuda",
                    help="torch device of stage B (cuda, cuda:N; cpu runs "
                         "the plain PyTorch versions of the kernels)")
    ap.add_argument("--trace-out", metavar="PATH",
                    help="write a chrome trace of the decode: the "
                         "profiler's events and kernels beside the "
                         "program's spans of every thread")
    args = ap.parse_args(argv)

    from .api import LayerSelect
    from .decoder import Decoder
    from .io import open_input

    data = open_input(args.input)
    t0 = time.time()
    dec = Decoder(check_md5=not args.no_md5, recon_backend=args.backend,
                  target_layer=args.layer,
                  temporal_layer=args.temporal_layer, device=args.device)
    select = LayerSelect(args.layer)
    if args.trace_out:
        frames = _traced_decode(dec, data, args.trace_out, select)
    else:
        frames = select(dec.decode_bytes(data))
    top = max((f.layer for f in frames), default=0)
    frames = [f for f in frames if f.layer == top]
    if args.frames:
        frames = frames[:args.frames]
    dt = time.time() - t0

    bad = 0
    out = open(args.output, "wb") if args.output else None
    try:
        for f in frames:
            if f.md5_ok is False:
                bad += 1
                print(f"Incorrect MD5 (poc {f.poc})", file=sys.stderr)
            elif f.md5_ok and args.log_level >= 40:
                print(f"Correct MD5 (poc {f.poc})")
            if out:
                for p in f.planes:
                    out.write(p.astype(np.uint8 if p.dtype == np.uint8
                                       else "<u2").tobytes())
    finally:
        if out:
            out.close()
    n = len(frames)
    fps = n / dt if dt > 0 else 0.0
    print(f"frame= {n} fps= {fps:.1f} time= {dt:.2f}")
    return 1 if bad else 0


def _traced_decode(dec, data, path, select):
    """Decode ``data`` one access unit at a time (pts = its index), the
    pictures ``select`` delivers fetched to the host, under
    ``torch.profiler`` with the timeline on; write the merged chrome trace
    to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import trace
    from .bitstream import nal as nalmod
    from .io.parser import split_access_units
    cuda = getattr(dec, "device", None) is not None \
        and dec.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    trace.reset()
    trace.timeline_start()
    frames = []
    try:
        with profile(activities=acts) as prof:
            for pts, au in enumerate(split_access_units(data)):
                dec.next_pts = pts
                for n in nalmod.split_annexb(au):
                    dec.decode_nal(n)
                frames += select(dec.frames)
                dec.frames = []
            dec.flush()
            frames += select(dec.frames)
            dec.frames = []
            for f in frames:
                f.planes[0]  # the fetch, inside the trace
            if cuda:
                torch.cuda.synchronize(dec.device)
    finally:
        trace.timeline_stop()
        dec.close()
    raw = path + ".profiler.json"
    prof.export_chrome_trace(raw)
    try:
        trace.export_chrome(path, raw)
    finally:
        os.remove(raw)
    return frames


if __name__ == "__main__":
    sys.exit(main())
