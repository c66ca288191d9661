"""Frame-axis decode: pictures whose references all lie in earlier batches
decode side by side on several devices.

Port of ``hevc_tpu/tpu/pgop_frame.py``, the reference's frame threads
(N decoder clones in flight, gated by row progress) re-expressed for
devices: stage A runs in decode order on the host, pictures are grouped
into dependency batches (``ref_batches``: a picture joins the current
batch when every reference lies in an earlier one), and the pictures of a
batch run stage B on ``devices[k % len(devices)]``, those sharing a device
one after another.  Each picture runs ``sharded.band_step`` with one band
and no halo exchange; its reference windows are the whole PAD_REF-padded
frame.

Unlike the reference, which takes each picture's references from the
host's sequential decode, every decoded picture stays on its device while
the RPS keeps it, and an anchor is copied to the device of each picture
that reads it; no reference comes from the host.
"""
from __future__ import annotations

import torch

from .band import _bundle_frame, capture_plans
from .pack import PAD_REF
from .sharded import BandLayout, band_step


def ref_batches(captured):
    """Group decode-order (pic, ...) items into maximal batches whose
    references all lie in earlier batches: the static dependency schedule
    of frame threads at whole-frame granularity."""
    batches, cur = [], []
    done, cur_pocs = set(), set()
    for item in captured:
        pic = item[0]
        refs = {e[0] for e in (getattr(pic, "ref_list_l0", []) or [])} \
            | {e[0] for e in (getattr(pic, "ref_list_l1", []) or [])}
        if cur and refs <= done:
            cur.append(item)
            cur_pocs.add(pic.poc)
        else:
            if cur:
                batches.append(cur)
                done |= cur_pocs
            cur, cur_pocs = [item], {pic.poc}
            if not (refs <= done or not batches):
                raise ValueError("decode order violates reference "
                                 "availability")
    if cur:
        batches.append(cur)
    return batches


def decode_frame_parallel(stream, devices):
    """Decode a stream with each dependency batch's pictures spread over
    ``devices``.  Returns ({poc: [y, cb, cr]} int32 tensors on the device
    that decoded the picture, [[poc, ...] per batch] in decode order).
    Every picture's planes are held until it returns, as its host stage A
    (``capture_plans``) holds the whole stream: a call for a GOP, not a
    long stream.  The device DPB keeps only what the RPS keeps."""
    dpb = {}   # poc -> {device: reference windows}
    out = {}
    batches = ref_batches([(ent["pic"], ent)
                           for ent in capture_plans(stream)[1]])
    for batch in batches:
        for j, (pic, ent) in enumerate(batch):
            dev = torch.device(devices[j % len(devices)])
            fb = _bundle_frame(ent, 1, PAD_REF, PAD_REF)
            for poc in [p for p in dpb if p not in fb["dpb_pocs"]]:
                del dpb[poc]
            refs = {}
            for poc in fb["ref_pocs_l0"] + fb["ref_pocs_l1"]:
                on = dpb.get(poc)
                if on is None:
                    continue   # band_step raises, naming the POC
                if dev not in on:  # an anchor decoded on another device
                    on[dev] = [tuple(t.to(dev) for t in next(
                        iter(on.values()))[0])]
                refs[poc] = on[dev]
            (planes,) = band_step(BandLayout([dev]), fb, PAD_REF, PAD_REF,
                                  refs)
            dpb[fb["poc"]] = {dev: refs[fb["poc"]]}
            out[fb["poc"]] = list(planes)
    return out, [[pic.poc for pic, _ent in b] for b in batches]


def decode_bframes_frame_axis(devices, n_b=None, width=96, height=64, qp=30):
    """Encode a parallel-B GOP (``encoder.pgop.ParallelBGopEncoder``: I0,
    P(n_b + 1), then B1..Bn_b that read only the two anchors) and decode it
    with ``decode_frame_parallel``.  Returns (stream, {poc: planes} of the
    B pictures, batches)."""
    from .encoder.core import EncoderConfig
    from .encoder.generate import synth_frame
    from .encoder.pgop import ParallelBGopEncoder
    n_b = len(devices) if n_b is None else n_b
    cfg = EncoderConfig(width=width, height=height, qp=qp, log2_ctb_size=5,
                        log2_cu_size=5, gop="ra", deblocking=True, sao=True,
                        seed=2, search_range=2)
    stream = ParallelBGopEncoder(cfg, n_b).encode(
        [synth_frame("noise", width, height, t, seed=4)
         for t in range(n_b + 2)])
    out, batches = decode_frame_parallel(stream, devices)
    return stream, {p: out[p] for p in range(1, n_b + 1)}, batches
