"""Coefficient scan tables for residual coding (H.265 clause 6.5.3).

Capability parity with the reference's scan tables (reference:
libavcodec/hevc_cabac.c:412-535, hevc_data.c:25-75), re-derived from the
spec's scan order array initialization processes.

Global scan position i in an NxN transform block factors as
i = 16*sb + n: sub-block sb along the sub-block scan of the (N/4)x(N/4)
grid, coefficient n along the 4x4 scan — both using the same scanIdx.

Frozen copy of ``hevc_tpu_torch/coding/scans.py`` at ee5ffe9.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

SCAN_DIAG = 0
SCAN_HORIZ = 1
SCAN_VERT = 2


@lru_cache(maxsize=None)
def scan_xy(scan_idx: int, size: int) -> np.ndarray:
    """[size*size, 2] array of (x, y) per scan position (6.5.3)."""
    out = []
    if scan_idx == SCAN_DIAG:
        x = y = 0
        while len(out) < size * size:
            while y >= 0:
                if x < size and y < size:
                    out.append((x, y))
                y -= 1
                x += 1
            y = x
            x = 0
    elif scan_idx == SCAN_HORIZ:
        out = [(x, y) for y in range(size) for x in range(size)]
    else:
        out = [(x, y) for x in range(size) for y in range(size)]
    return np.array(out, np.int32)


@lru_cache(maxsize=None)
def block_scan(scan_idx: int, log2_size: int):
    """Full factored scan for a transform block.

    Returns (sub_scan, coef_scan, pos_of_xy) where
      sub_scan[sb]   = (xS, yS) sub-block coords along the sub-block scan,
      coef_scan[n]   = (xP, yP) within-sub-block coords (4x4 scan),
      pos_of_xy[y,x] = global scan position of coefficient (x, y).
    """
    size = 1 << log2_size
    if log2_size == 2:
        sub_scan = np.zeros((1, 2), np.int32)
    else:
        sub_scan = scan_xy(scan_idx, size >> 2)
    coef_scan = scan_xy(scan_idx, 4)
    pos_of_xy = np.zeros((size, size), np.int32)
    for sb, (xs, ys) in enumerate(sub_scan):
        for n, (xp, yp) in enumerate(coef_scan):
            pos_of_xy[(ys << 2) + yp, (xs << 2) + xp] = 16 * sb + n
    return sub_scan, coef_scan, pos_of_xy


def scan_idx_for_intra(pred_mode: int, log2_size: int, c_idx: int,
                       chroma_format_idc: int = 1) -> int:
    """scanIdx derivation (7.4.9.11): mode-dependent for small intra TUs."""
    if log2_size == 2 or (log2_size == 3 and (c_idx == 0
                                              or chroma_format_idc == 3)):
        if 6 <= pred_mode <= 14:
            return SCAN_VERT
        if 22 <= pred_mode <= 30:
            return SCAN_HORIZ
    return SCAN_DIAG
