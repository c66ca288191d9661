"""Encode a cell's bank of segments with the program's encoder, on the CPU.

    python -m benchmark.make_bank --config main1080 --traffic ra \
        --commit <commit of the encoder> [--jobs N]

Writes ``data/<config>/<traffic>/seg<k>.hevc`` (Annex-B, one closed GOP
each, starting with its parameter sets and an IDR) and ``bank.json``: each
segment's SHA-256 and access-unit sizes, and the encoder settings and
content it was made from.  Then decodes every segment with the plain
reference (``benchmark.reference``) and requires each picture to match the
MD5 its SEI carries, which is the encoder's own reconstruction.

A run never encodes: it reads the bank.  At 1920x1080 the encoder takes
tens of seconds a picture, so the segments are encoded side by side in
worker processes, one a segment.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from . import bank, refcache

# luma (rows, columns) directions of the four segments' motion
DIRECTIONS = ((1, 1), (1, -1), (-1, 1), (-1, -1))


def encoder_settings(cfg: dict, mix: dict, k: int) -> list:
    """Each layer's encoder settings: the configuration's, updated by the
    traffic mix's, with the segment's own seed."""
    layers = cfg["encoder"]["layers"] if cfg["layers"] > 1 \
        else [cfg["encoder"]]
    return [dict(layer, **mix["encoder"], seed=layer.get("seed", 1) + k)
            for layer in layers]


def _resize(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """Linear resampling to (h, w), sample centres aligned."""
    def axis(a, n, ax):
        m = a.shape[ax]
        pos = (np.arange(n) + 0.5) * m / n - 0.5
        lo = np.clip(np.floor(pos).astype(int), 0, m - 1)
        hi = np.clip(lo + 1, 0, m - 1)
        f = np.clip(pos - lo, 0.0, 1.0)
        shape = [1, 1]
        shape[ax] = n
        f = f.reshape(shape)
        return np.take(a, lo, ax) * (1 - f) + np.take(a, hi, ax) * f
    out = axis(axis(plane.astype(np.float64), h, 0), w, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def source_frames(content: dict, w: int, h: int, n: int, k: int) -> list:
    """Segment k's n display-order [Y, Cb, Cr] 4:2:0 pictures: the
    encoder's synthetic content, moved ``motion`` luma samples a picture
    in the segment's direction, its content time advanced ``t_step`` a
    picture."""
    from hevc_tpu_torch.encoder.generate import synth_frame
    dy, dx = (m * s for m, s in zip(content["motion"], DIRECTIONS[k % 4]))
    t0 = content["t0"] + k * n * content["t_step"]
    base = synth_frame(content["kind"], w, h, t0, seed=k)
    out = []
    for t in range(n):
        pic = synth_frame(content["kind"], w, h, t0 + t * content["t_step"],
                          seed=k) if content["t_step"] else base
        out.append([np.roll(p, (t * dy // s, t * dx // s), (0, 1))
                    for p, s in zip(pic, (1, 2, 2))])
    return out


def encode_segment(cfg: dict, mix: dict, k: int) -> list:
    """Segment k of a configuration under a traffic mix: its access units'
    bytes, in decode order."""
    from hevc_tpu_torch.encoder.core import (EncoderConfig, IntraEncoder,
                                             RaEncoder)
    settings = [EncoderConfig(**s) for s in encoder_settings(cfg, mix, k)]
    top = settings[-1]
    n = mix["pictures"]
    pics = source_frames(mix["content"], top.width, top.height, n, k)
    if cfg["layers"] == 2:
        from hevc_tpu_torch.encoder.shvc import ShvcEncoder
        bl = settings[0]
        enc = ShvcEncoder(*settings)
        return [enc.encode_frame(
            [_resize(p, bl.height // s, bl.width // s)
             for p, s in zip(el, (1, 2, 2))], el) for el in pics]
    if top.gop == "ra":
        aus = []

        class Recorded(RaEncoder):
            def _encode(self, *a, **kw):
                au = super()._encode(*a, **kw)
                aus.append(au)
                return au

        Recorded(top).encode(pics)
        return aus
    enc = IntraEncoder(top)
    return [enc.encode_frame(p) for p in pics]


def _encode_timed(cfg, mix, k):
    t0 = time.perf_counter()
    aus = encode_segment(cfg, mix, k)
    return aus, time.perf_counter() - t0


def make(config_name: str, traffic_name: str, commit: str, jobs: int,
         cfg: dict = None, mix: dict = None, out: str = None) -> dict:
    """Encode the bank (``cfg`` / ``mix`` / ``out`` override the files,
    for tests at small sizes), verify it against the reference and write
    ``bank.json``; returns its content."""
    cfg = cfg or bank.config(config_name)
    mix = mix or bank.traffic(traffic_name)
    out = out or bank.bank_dir(config_name, traffic_name)
    os.makedirs(out, exist_ok=True)
    n = mix["segments"]
    with ProcessPoolExecutor(min(n, jobs),
                             mp_context=mp.get_context("spawn")) as pool:
        futs = [pool.submit(_encode_timed, cfg, mix, k) for k in range(n)]
        results = [f.result() for f in futs]
    segs = []
    for k, (aus, secs) in enumerate(results):
        name = f"seg{k}.hevc"
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(b"".join(aus))
        segs.append({"file": name, "sha256": bank.sha256(path),
                     "bytes": os.path.getsize(path),
                     "au_sizes": [len(a) for a in aus],
                     "encode_s": round(secs, 1),
                     "encoder": encoder_settings(cfg, mix, k)})
        print(f"{config_name}/{traffic_name} seg{k}: {len(aus)} access "
              f"units, {segs[-1]['bytes']} bytes, {secs:.1f} s", flush=True)
    meta = {"config": config_name, "traffic": traffic_name,
            "encoder": "hevc_tpu_torch.encoder", "encoder_commit": commit,
            "content": mix["content"], "segments": segs}
    with open(os.path.join(out, "bank.json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    # every picture of the bank as the reference decodes it must carry the
    # MD5 its SEI states (the encoder's reconstruction)
    t0 = time.perf_counter()
    refcache.digests(bank.load_bank(config_name, traffic_name, out),
                     cfg["layers"] - 1, jobs)
    secs = time.perf_counter() - t0
    print(f"reference agrees with every SEI MD5 ({secs:.1f} s)", flush=True)
    return meta


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--commit", required=True,
                    help="the commit whose encoder makes the bank")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    a = ap.parse_args(argv)
    make(a.config, a.traffic, a.commit, a.jobs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
