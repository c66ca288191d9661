"""Motion-compensated prediction — bit-exact NumPy reference (8.5.4).

Capability parity with the reference's put_hevc_qpel/epel kernel grid
(reference: libavcodec/hevcdsp_template.c:2359-3375, hevcdsp.h:98-125)
re-derived from the specification's fractional sample interpolation
(8.5.4.2.2) and weighted sample prediction (8.5.4.3) processes.

Out-of-picture reads use coordinate clamping (border replication), the
exact semantics of the reference's edge emulation.

Frozen copy of ``hevc_tpu_torch/ops/mc.py`` at ee5ffe9.
"""
from __future__ import annotations

import numpy as np

# Table 8-11: luma 8-tap qpel filters (frac 1..3)
QPEL_FILTERS = {
    1: np.array([-1, 4, -10, 58, 17, -5, 1, 0], np.int32),
    2: np.array([-1, 4, -11, 40, 40, -11, 4, -1], np.int32),
    3: np.array([0, 1, -5, 17, 58, -10, 4, -1], np.int32),
}

# Table 8-13: chroma 4-tap epel filters (frac 1..7)
EPEL_FILTERS = {
    1: np.array([-2, 58, 10, -2], np.int32),
    2: np.array([-4, 54, 16, -2], np.int32),
    3: np.array([-6, 46, 28, -4], np.int32),
    4: np.array([-4, 36, 36, -4], np.int32),
    5: np.array([-4, 28, 46, -6], np.int32),
    6: np.array([-2, 16, 54, -4], np.int32),
    7: np.array([-2, 10, 58, -2], np.int32),
}


def _gather(ref: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    h, w = ref.shape
    return ref[np.clip(ys, 0, h - 1)[:, None],
               np.clip(xs, 0, w - 1)[None, :]].astype(np.int32)


def mc_luma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
            mv_x: int, mv_y: int, bit_depth: int) -> np.ndarray:
    """Luma fractional interpolation (8.5.4.2.2.1).

    mv in quarter-pel units.  Returns the 14-bit predSamplesLX [h, w]
    (before weighted prediction)."""
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    xi = x0 + (mv_x >> 2)
    yi = y0 + (mv_y >> 2)
    fx = mv_x & 3
    fy = mv_y & 3
    xs = np.arange(w) + xi
    ys = np.arange(h) + yi
    if fx == 0 and fy == 0:
        return _gather(ref, ys, xs) << shift3
    if fy == 0:
        f = QPEL_FILTERS[fx]
        acc = np.zeros((h, w), np.int64)
        for i in range(8):
            acc += int(f[i]) * _gather(ref, ys, xs - 3 + i)
        return (acc >> shift1).astype(np.int32)
    if fx == 0:
        f = QPEL_FILTERS[fy]
        acc = np.zeros((h, w), np.int64)
        for i in range(8):
            acc += int(f[i]) * _gather(ref, ys - 3 + i, xs)
        return (acc >> shift1).astype(np.int32)
    fh = QPEL_FILTERS[fx]
    fv = QPEL_FILTERS[fy]
    ys_t = np.arange(h + 7) + yi - 3
    tmp = np.zeros((h + 7, w), np.int64)
    for i in range(8):
        tmp += int(fh[i]) * _gather(ref, ys_t, xs - 3 + i)
    tmp >>= shift1
    acc = np.zeros((h, w), np.int64)
    for i in range(8):
        acc += int(fv[i]) * tmp[i:i + h]
    return (acc >> shift2).astype(np.int32)


def chroma_mv_parts(mv: int, shift: int):
    """(integer offset, eighth-pel filter index) of a chroma MV component
    for subsampling shift (1 = half-res, 0 = full-res); mv is the luma
    quarter-pel value (mvCLX == mvLX, 8.5.3.2.9)."""
    return mv >> (2 + shift), (mv & ((1 << (2 + shift)) - 1)) << (1 - shift)


def mc_chroma(ref: np.ndarray, x0: int, y0: int, w: int, h: int,
              mv_x: int, mv_y: int, bit_depth: int,
              hshift: int = 1, vshift: int = 1) -> np.ndarray:
    """Chroma fractional interpolation (8.5.4.2.2.2).

    mv in luma quarter-pel units; hshift/vshift per chroma format
    (4:2:0 = 1/1, 4:2:2 = 1/0, 4:4:4 = 0/0).  Returns the 14-bit
    predSamples [h, w]."""
    shift1 = bit_depth - 8
    shift2 = 6
    shift3 = 14 - bit_depth
    ox, fx = chroma_mv_parts(mv_x, hshift)
    oy, fy = chroma_mv_parts(mv_y, vshift)
    xi = x0 + ox
    yi = y0 + oy
    xs = np.arange(w) + xi
    ys = np.arange(h) + yi
    if fx == 0 and fy == 0:
        return _gather(ref, ys, xs) << shift3
    if fy == 0:
        f = EPEL_FILTERS[fx]
        acc = np.zeros((h, w), np.int64)
        for i in range(4):
            acc += int(f[i]) * _gather(ref, ys, xs - 1 + i)
        return (acc >> shift1).astype(np.int32)
    if fx == 0:
        f = EPEL_FILTERS[fy]
        acc = np.zeros((h, w), np.int64)
        for i in range(4):
            acc += int(f[i]) * _gather(ref, ys - 1 + i, xs)
        return (acc >> shift1).astype(np.int32)
    fh = EPEL_FILTERS[fx]
    fv = EPEL_FILTERS[fy]
    ys_t = np.arange(h + 3) + yi - 1
    tmp = np.zeros((h + 3, w), np.int64)
    for i in range(4):
        tmp += int(fh[i]) * _gather(ref, ys_t, xs - 1 + i)
    tmp >>= shift1
    acc = np.zeros((h, w), np.int64)
    for i in range(4):
        acc += int(fv[i]) * tmp[i:i + h]
    return (acc >> shift2).astype(np.int32)


def weighted_uni(pred: np.ndarray, bit_depth: int) -> np.ndarray:
    """Default (non-weighted) uni prediction output (8.5.4.3.2)."""
    shift = 14 - bit_depth
    off = 1 << (shift - 1) if shift > 0 else 0
    return np.clip((pred + off) >> shift, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def weighted_bi(p0: np.ndarray, p1: np.ndarray,
                bit_depth: int) -> np.ndarray:
    shift = 15 - bit_depth
    off = 1 << (shift - 1)
    return np.clip((p0.astype(np.int64) + p1 + off) >> shift, 0,
                   (1 << bit_depth) - 1).astype(np.int32)


def weighted_uni_explicit(pred: np.ndarray, w: int, o: int, log2wd: int,
                          bit_depth: int) -> np.ndarray:
    """Explicit weighted uni prediction (8.5.4.3.3).

    log2wd = weight denom + (14 - bitDepth); o in sample units (already
    scaled by << (bitDepth - 8))."""
    maxv = (1 << bit_depth) - 1
    if log2wd >= 1:
        v = ((pred.astype(np.int64) * w + (1 << (log2wd - 1)))
             >> log2wd) + o
    else:
        v = pred.astype(np.int64) * w + o
    return np.clip(v, 0, maxv).astype(np.int32)


def weighted_bi_explicit(p0: np.ndarray, p1: np.ndarray, w0: int, o0: int,
                         w1: int, o1: int, log2wd: int,
                         bit_depth: int) -> np.ndarray:
    maxv = (1 << bit_depth) - 1
    v = ((p0.astype(np.int64) * w0 + p1.astype(np.int64) * w1
          + ((o0 + o1 + 1) << log2wd)) >> (log2wd + 1))
    return np.clip(v, 0, maxv).astype(np.int32)
