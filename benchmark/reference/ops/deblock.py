"""Deblocking filter — bit-exact NumPy reference (H.265 clause 8.7.2).

Capability parity with the reference's deblocking_filter_CTB /
hevc_loop_filter_luma/chroma (reference: libavcodec/hevc_filter.c:525,
hevcdsp_template.c:3377), re-derived from the specification.

Frame-level two-pass schedule: all vertical edges, then all horizontal
edges — semantically identical to the reference's per-CTB shifted
schedule (filters never overlap within a pass: 8-sample edge spacing,
reads<=4, writes<=3 per side).

Edges are described by per-4x4-block boundary-strength maps
(bs_v[y4][x4] = strength of the vertical edge on the LEFT side of block
(x4, y4); bs_h = top side).  Only 8-aligned luma edges and 16-aligned
(luma coords) chroma edges are filtered, per the spec grid.

Frozen copy of ``hevc_tpu_torch/ops/deblock.py`` at ee5ffe9.
"""
from __future__ import annotations

import numpy as np

from . import reference as R

# Table 8-12
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24,
    26, 28, 30, 32, 34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56,
    58, 60, 62, 64], np.int32)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4,
    4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20,
    22, 24], np.int32)


def _clip3(lo, hi, v):
    return np.minimum(np.maximum(v, lo), hi)


def _filter_luma_segment(w: np.ndarray, beta: int, tc: int, maxv: int):
    """Filter one 4-line luma segment.  w: int32 [4, 8] window with
    columns p3 p2 p1 p0 q0 q1 q2 q3 along the filtering direction.
    Returns the modified window (copy) or None if not filtered."""
    p3, p2, p1, p0 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
    q0, q1, q2, q3 = w[:, 4], w[:, 5], w[:, 6], w[:, 7]
    dp = np.abs(p2 - 2 * p1 + p0)
    dq = np.abs(q2 - 2 * q1 + q0)
    dpq0 = int(dp[0] + dq[0])
    dpq3 = int(dp[3] + dq[3])
    d = dpq0 + dpq3
    if d >= beta:
        return None
    out = w.copy()
    # strong/weak decision on lines 0 and 3 (8.7.2.5.3)
    strong = True
    for i, dpq in ((0, dpq0), (3, dpq3)):
        ok = (2 * dpq < (beta >> 2)
              and abs(int(p3[i] - p0[i])) + abs(int(q0[i] - q3[i]))
              < (beta >> 3)
              and abs(int(p0[i] - q0[i])) < ((5 * tc + 1) >> 1))
        strong = strong and ok
    if strong:
        t2 = 2 * tc
        out[:, 3] = _clip3(p0 - t2, p0 + t2,
                           (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3)
        out[:, 2] = _clip3(p1 - t2, p1 + t2, (p2 + p1 + p0 + q0 + 2) >> 2)
        out[:, 1] = _clip3(p2 - t2, p2 + t2,
                           (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3)
        out[:, 4] = _clip3(q0 - t2, q0 + t2,
                           (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3)
        out[:, 5] = _clip3(q1 - t2, q1 + t2, (p0 + q0 + q1 + q2 + 2) >> 2)
        out[:, 6] = _clip3(q2 - t2, q2 + t2,
                           (p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3)
        return out
    # weak filter, per line
    dep = int(dp[0] + dp[3]) < ((beta + (beta >> 1)) >> 3)
    deq = int(dq[0] + dq[3]) < ((beta + (beta >> 1)) >> 3)
    for i in range(4):
        delta = (9 * (int(q0[i]) - int(p0[i]))
                 - 3 * (int(q1[i]) - int(p1[i])) + 8) >> 4
        if abs(delta) >= tc * 10:
            continue
        delta = max(-tc, min(tc, delta))
        out[i, 3] = max(0, min(maxv, int(p0[i]) + delta))
        out[i, 4] = max(0, min(maxv, int(q0[i]) - delta))
        if dep:
            dp1 = max(-(tc >> 1), min(tc >> 1,
                      (((int(p2[i]) + int(p0[i]) + 1) >> 1)
                       - int(p1[i]) + delta) >> 1))
            out[i, 2] = max(0, min(maxv, int(p1[i]) + dp1))
        if deq:
            dq1 = max(-(tc >> 1), min(tc >> 1,
                      (((int(q2[i]) + int(q0[i]) + 1) >> 1)
                       - int(q1[i]) - delta) >> 1))
            out[i, 5] = max(0, min(maxv, int(q1[i]) + dq1))
    return out


def _filter_chroma_segment(w: np.ndarray, tc: int, maxv: int):
    """w: int32 [n, 4] window: p1 p0 q0 q1.  Always-filter (bs==2)."""
    p1, p0, q0, q1 = w[:, 0], w[:, 1], w[:, 2], w[:, 3]
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + p1 - q1 + 4) >> 3)
    out = w.copy()
    out[:, 1] = _clip3(0, maxv, p0 + delta)
    out[:, 2] = _clip3(0, maxv, q0 - delta)
    return out


def deblock_frame(planes, qp_map, bs_v, bs_h, *, bit_depth=8,
                  beta_offset=0, tc_offset=0, chroma_format_idc=1,
                  cb_qp_offset=0, cr_qp_offset=0, no_filter4=None):
    """In-place deblocking of one frame.

    planes: [Y, Cb, Cr] arrays; qp_map: int [h4, w4] luma QP per 4x4;
    bs_v/bs_h: int [h4, w4] boundary strengths (0..2).

    beta_offset/tc_offset: scalars, or per-4x4 [h4, w4] maps carrying
    each slice's offsets at the edge's q-sample position (multi-slice;
    spec 8.7.2.5: parameters come from the slice containing q0 —
    reference per-CTB s->deblock[ctb], hevc_filter.c:539).

    no_filter4: optional bool [h4, w4] — samples of PCM CUs with
    pcm_loop_filter_disabled (and transquant-bypass CUs) are never
    MODIFIED by deblocking (8.7.2 nDp/nDq = 0), though neighbours still
    read them; implemented as a restore after each directional pass."""
    y = planes[0].astype(np.int32)
    h, w = y.shape
    maxv = (1 << bit_depth) - 1
    sub_w = 2 if chroma_format_idc in (1, 2) else 1
    sub_h = 2 if chroma_format_idc == 1 else 1
    b_map = isinstance(beta_offset, np.ndarray)
    t_map = isinstance(tc_offset, np.ndarray)

    def offs(y4, x4):
        bo = int(beta_offset[y4, x4]) if b_map else beta_offset
        to = int(tc_offset[y4, x4]) if t_map else tc_offset
        return bo, to

    def luma_params(qp_p, qp_q, bs, y4, x4):
        bo, to = offs(y4, x4)
        qp = (qp_p + qp_q + 1) >> 1
        beta = int(BETA_TABLE[min(max(qp + bo, 0), 51)]
                   ) << (bit_depth - 8)
        tc = int(TC_TABLE[min(max(qp + 2 * (bs - 1) + to, 0), 53)]
                 ) << (bit_depth - 8)
        return beta, tc

    nf_l = nf_cb = None
    snap_y = snap_c = None
    if no_filter4 is not None and no_filter4.any():
        nf_l = np.repeat(np.repeat(no_filter4, 4, 0), 4, 1)[:h, :w]
        snap_y = y.copy()

    # ---- pass 1: vertical edges (8-aligned), luma --------------------
    for x in range(8, w, 8):
        for y0 in range(0, h, 4):
            bs = int(bs_v[y0 >> 2, x >> 2])
            if bs == 0:
                continue
            qp_p = int(qp_map[y0 >> 2, (x - 1) >> 2])
            qp_q = int(qp_map[y0 >> 2, x >> 2])
            beta, tc = luma_params(qp_p, qp_q, bs, y0 >> 2, x >> 2)
            if tc == 0 and beta == 0:
                continue
            win = y[y0:y0 + 4, x - 4:x + 4]
            out = _filter_luma_segment(win.copy(), beta, tc, maxv)
            if out is not None:
                y[y0:y0 + 4, x - 4:x + 4] = out
    # ---- pass 1b: vertical chroma edges ------------------------------
    cplanes = []
    for c_idx in ((1, 2) if chroma_format_idc else ()):
        c = planes[c_idx].astype(np.int32)
        ch, cw = c.shape
        off = cb_qp_offset if c_idx == 1 else cr_qp_offset
        step_x = 8  # chroma edges every 8 chroma samples (8.7.2)
        for xc in range(step_x, cw, step_x):
            xl = xc * sub_w  # luma column of the edge
            for yc0 in range(0, ch, 4):
                yl = yc0 * sub_h
                bs = int(bs_v[yl >> 2, xl >> 2])
                if bs != 2:
                    continue
                qp_p = int(qp_map[yl >> 2, (xl - 1) >> 2])
                qp_q = int(qp_map[yl >> 2, xl >> 2])
                qpi = ((qp_p + qp_q + 1) >> 1) + off
                qpc = R.chroma_qp(qpi - off, off, chroma_format_idc)
                to = int(tc_offset[yl >> 2, xl >> 2]) if t_map \
                    else tc_offset
                tc = int(TC_TABLE[min(max(qpc + 2 + to, 0), 53)]
                         ) << (bit_depth - 8)
                if tc == 0:
                    continue
                n = min(4, ch - yc0)
                win = c[yc0:yc0 + n, xc - 2:xc + 2]
                c[yc0:yc0 + n, xc - 2:xc + 2] = \
                    _filter_chroma_segment(win.copy(), tc, maxv)
        cplanes.append(c)

    if nf_l is not None:
        nf_cb = nf_l[::sub_h, ::sub_w]
        snap_c = [c.copy() for c in cplanes]
        # exempt samples keep their pre-deblock values: snap_c was taken
        # AFTER the vertical chroma pass, so restore chroma from the
        # untouched input planes instead
        snap_c = [planes[c_idx].astype(np.int32)
                  for c_idx in ((1, 2) if chroma_format_idc else ())]
        y[nf_l] = snap_y[nf_l]
        for k, c in enumerate(cplanes):
            m = nf_cb[:c.shape[0], :c.shape[1]]
            c[m] = snap_c[k][m]

    # ---- pass 2: horizontal edges, luma ------------------------------
    for ye in range(8, h, 8):
        for x0 in range(0, w, 4):
            bs = int(bs_h[ye >> 2, x0 >> 2])
            if bs == 0:
                continue
            qp_p = int(qp_map[(ye - 1) >> 2, x0 >> 2])
            qp_q = int(qp_map[ye >> 2, x0 >> 2])
            beta, tc = luma_params(qp_p, qp_q, bs, ye >> 2, x0 >> 2)
            if tc == 0 and beta == 0:
                continue
            win = y[ye - 4:ye + 4, x0:x0 + 4].T  # direction-major
            out = _filter_luma_segment(win.copy(), beta, tc, maxv)
            if out is not None:
                y[ye - 4:ye + 4, x0:x0 + 4] = out.T
    # ---- pass 2b: horizontal chroma edges ----------------------------
    for k, c_idx in enumerate((1, 2) if chroma_format_idc else ()):
        c = cplanes[k]
        ch, cw = c.shape
        off = cb_qp_offset if c_idx == 1 else cr_qp_offset
        step_y = 8
        for yce in range(step_y, ch, step_y):
            yle = yce * sub_h
            for xc0 in range(0, cw, 4):
                xl = xc0 * sub_w
                bs = int(bs_h[yle >> 2, xl >> 2])
                if bs != 2:
                    continue
                qp_p = int(qp_map[(yle - 1) >> 2, xl >> 2])
                qp_q = int(qp_map[yle >> 2, xl >> 2])
                qpi = ((qp_p + qp_q + 1) >> 1) + off
                qpc = R.chroma_qp(qpi - off, off, chroma_format_idc)
                to = int(tc_offset[yle >> 2, xl >> 2]) if t_map \
                    else tc_offset
                tc = int(TC_TABLE[min(max(qpc + 2 + to, 0), 53)]
                         ) << (bit_depth - 8)
                if tc == 0:
                    continue
                n = min(4, cw - xc0)
                win = c[yce - 2:yce + 2, xc0:xc0 + n].T
                c[yce - 2:yce + 2, xc0:xc0 + n] = \
                    _filter_chroma_segment(win.copy(), tc, maxv).T
    if nf_l is not None:
        y[nf_l] = snap_y[nf_l]
        for k, c in enumerate(cplanes):
            m = nf_cb[:c.shape[0], :c.shape[1]]
            c[m] = snap_c[k][m]
    dt = planes[0].dtype
    planes[0][:] = y.astype(dt)
    if chroma_format_idc:
        planes[1][:] = cplanes[0].astype(dt)
        planes[2][:] = cplanes[1].astype(dt)
