"""Decoder CLI of the PyTorch/CUDA port (counterpart of ``hevc_tpu.cli``).

Decodes an Annex-B stream (or MP4 / MPEG-TS) with ``TorchDecoder`` (or a
NumPy backend, ``-b``), optionally writes the raw YUV, checks the SEI
decoded-picture hashes and prints ``frame= N fps= F time= T``.

Usage: python -m hevc_tpu_torch.cli -i in.265 [-o out.yuv] [-c]
       [-b torch|inline|plan] [--device cuda]
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args(argv)

    from .decoder import Decoder
    from .io import open_input

    data = open_input(args.input)
    t0 = time.time()
    dec = Decoder(check_md5=not args.no_md5, recon_backend=args.backend,
                  target_layer=args.layer,
                  temporal_layer=args.temporal_layer, device=args.device)
    frames = dec.decode_bytes(data)
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


if __name__ == "__main__":
    sys.exit(main())
