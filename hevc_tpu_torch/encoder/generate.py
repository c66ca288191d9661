"""Test/benchmark stream generator CLI.

Produces conformant HEVC Annex-B streams from synthetic sources (or a raw
YUV file) with embedded decoded-picture-hash SEI, so both the openHEVC
oracle binary and our decoder can verify them bit-exactly.

Usage:
    python -m hevc_tpu_torch.encoder.generate --out /tmp/t.265 \
        --width 416 --height 240 --frames 3 --qp 32 [--seed 0]
        [--source gradient|noise|zoneplate|yuv --yuv in.yuv]

Copied from ``hevc_tpu/encoder/generate.py`` at e99b487.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from .core import EncoderConfig, IntraEncoder


def synth_frame(kind: str, w: int, h: int, t: int, seed: int = 0):
    """One synthetic [Y, Cb, Cr] 4:2:0 frame (uint8)."""
    rng = np.random.default_rng(seed + 1000 * t)
    x = np.arange(w)[None, :].astype(np.float64)
    y = np.arange(h)[:, None].astype(np.float64)
    if kind == "gradient":
        luma = 128 + 60 * np.sin(x / 37.0 + t * 0.7) + 50 * np.cos(y / 23.0)
        luma = luma + rng.integers(-10, 10, (h, w))
    elif kind == "noise":
        luma = rng.integers(0, 256, (h, w))
    elif kind == "zoneplate":
        luma = 128 + 110 * np.cos((x * x + y * y) / (40.0 + 5 * t))
    else:
        raise ValueError(kind)
    luma = np.clip(luma, 0, 255).astype(np.uint8)
    cw, ch = w // 2, h // 2
    xc = np.arange(cw)[None, :]
    yc = np.arange(ch)[:, None]
    cb = np.clip(128 + 40 * np.sin(xc / 19.0 + t), 0, 255).astype(np.uint8)
    cb = np.broadcast_to(cb, (ch, cw)).copy()
    cr = np.clip(128 + 40 * np.cos(yc / 17.0 - t), 0, 255).astype(np.uint8)
    cr = np.broadcast_to(cr, (ch, cw)).copy()
    return [luma, cb, cr]


def synth_stream(path, w, h, qp, frames, wpp=True, kind="gradient", seed=9,
                 log2_ctb=6, **extra):
    """Writes to ``path`` an IPP stream of one ``synth_frame`` picture
    rolled a little each frame, with the settings of the root ``bench.py``'s
    ``_synth_stream`` (the same bytes for its arguments); ``extra``
    overrides or adds encoder settings, the chroma format and bit depth
    among them.  Returns ``path``."""
    kw = dict(width=w, height=h, qp=qp, log2_ctb_size=log2_ctb,
              log2_cu_size=log2_ctb, deblocking=True, sao=True, seed=1,
              gop="ipp", search_range=3, wpp=wpp)
    kw.update(extra)
    cfg = EncoderConfig(**kw)
    enc = IntraEncoder(cfg)
    base = synth_frame(kind, w, h, 0, seed=seed)
    cf, bd = cfg.chroma_format_idc, cfg.bit_depth
    data = bytearray()
    for t in range(frames):
        planes = [np.roll(base[0], (t * 4, t * 7), (0, 1))]
        for c in base[1:] if cf else ():
            c = np.roll(c, (t * 2, t * 3), (0, 1))
            if cf == 2:      # 4:2:2: chroma at the luma's height
                c = np.repeat(c, 2, 0)
            elif cf == 3:
                c = np.repeat(np.repeat(c, 2, 0), 2, 1)
            planes.append(c)
        if bd > 8:
            planes = [p.astype(np.int32) << (bd - 8) for p in planes]
        data += enc.encode_frame(planes)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def read_yuv_frames(path: str, w: int, h: int, n: int):
    frames = []
    fsz = w * h * 3 // 2
    raw = open(path, "rb").read()
    for t in range(min(n, len(raw) // fsz)):
        buf = np.frombuffer(raw[t * fsz:(t + 1) * fsz], np.uint8)
        yp = buf[:w * h].reshape(h, w)
        cb = buf[w * h:w * h + w * h // 4].reshape(h // 2, w // 2)
        cr = buf[w * h + w * h // 4:].reshape(h // 2, w // 2)
        frames.append([yp.copy(), cb.copy(), cr.copy()])
    return frames


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--width", type=int, default=416)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--source", default="gradient",
                    choices=["gradient", "noise", "zoneplate", "yuv"])
    ap.add_argument("--yuv", help="raw 4:2:0 planar input for --source yuv")
    ap.add_argument("--ctb", type=int, default=16, help="CTB size (16/32/64)")
    ap.add_argument("--recon-out", help="write encoder recon YUV here")
    args = ap.parse_args(argv)

    log2_ctb = args.ctb.bit_length() - 1
    cfg = EncoderConfig(width=args.width, height=args.height, qp=args.qp,
                        log2_ctb_size=log2_ctb,
                        log2_cu_size=min(log2_ctb, 4),
                        log2_min_cb_size=3)
    enc = IntraEncoder(cfg)
    if args.source == "yuv":
        frames = read_yuv_frames(args.yuv, args.width, args.height,
                                 args.frames)
    else:
        frames = [synth_frame(args.source, args.width, args.height, t,
                              args.seed) for t in range(args.frames)]
    out = bytearray()
    recon = bytearray()
    for planes in frames:
        out += enc.encode_frame(planes)
        if args.recon_out:
            for p in enc.recon_planes:
                recon += p.astype(np.uint8).tobytes()
    with open(args.out, "wb") as f:
        f.write(out)
    if args.recon_out:
        with open(args.recon_out, "wb") as f:
            f.write(recon)
    print(f"wrote {len(out)} bytes, {len(frames)} frame(s) -> {args.out}")


if __name__ == "__main__":
    main()
