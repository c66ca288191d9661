"""Motion vector prediction: spatial merge + AMVP (H.265 8.5.3.2).

Capability parity with the reference's hevc_mvs.c
(ff_hevc_luma_mv_merge_mode :523, derive_spatial_merge_candidates :307,
ff_hevc_luma_mv_mvp_mode :635), re-derived from the specification.

Bi-prediction (two reference lists) and TMVP (temporal_luma_motion_vector
:230 analogue, incl. the AMP availability model) are supported; the
native stage A mirrors this module record-for-record
(tests/test_native_stagea.py).

Frozen copy of ``hevc_tpu_torch/coding/mvs.py`` at ee5ffe9.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

PART_2Nx2N = 0
PART_2NxN = 1
PART_Nx2N = 2
PART_NxN = 3
PART_2NxnU = 4
PART_2NxnD = 5
PART_nLx2N = 6
PART_nRx2N = 7

NO_POC = -(1 << 30)


def part_blocks(part: int, x0: int, y0: int, size: int):
    """PU rectangles [(x, y, w, h)] of one CU for a partition mode
    (reference: hevcdec.c:2116 hls_prediction_unit grid incl. AMP)."""
    half, q = size >> 1, size >> 2
    if part == PART_2Nx2N:
        return [(x0, y0, size, size)]
    if part == PART_2NxN:
        return [(x0, y0, size, half), (x0, y0 + half, size, half)]
    if part == PART_Nx2N:
        return [(x0, y0, half, size), (x0 + half, y0, half, size)]
    if part == PART_2NxnU:
        return [(x0, y0, size, q), (x0, y0 + q, size, size - q)]
    if part == PART_2NxnD:
        return [(x0, y0, size, size - q), (x0, y0 + size - q, size, q)]
    if part == PART_nLx2N:
        return [(x0, y0, q, size), (x0 + q, y0, size - q, size)]
    if part == PART_nRx2N:
        return [(x0, y0, size - q, size), (x0 + size - q, y0, q, size)]
    return [(x0, y0, half, half), (x0 + half, y0, half, half),
            (x0, y0 + half, half, half),
            (x0 + half, y0 + half, half, half)]


@dataclass
class MotionInfo:
    """Full motion of a block: both lists (ref < 0 = list unused)."""
    mv0: Tuple[int, int] = (0, 0)
    ref0: int = -1
    poc0: int = NO_POC
    mv1: Tuple[int, int] = (0, 0)
    ref1: int = -1
    poc1: int = NO_POC

    @property
    def uses_l0(self):
        return self.ref0 >= 0

    @property
    def uses_l1(self):
        return self.ref1 >= 0


def _motion_at(pic, xn, yn) -> Optional[MotionInfo]:
    """Stored motion at luma (xn, yn), or None when intra/no motion."""
    y4, x4 = yn >> 2, xn >> 2
    if pic.is_intra[y4, x4]:
        return None
    r0 = int(pic.ref_l0[y4, x4])
    r1 = int(pic.ref_l1[y4, x4])
    if r0 < 0 and r1 < 0:
        return None
    return MotionInfo(
        mv0=(int(pic.mv_l0[y4, x4, 0]), int(pic.mv_l0[y4, x4, 1])),
        ref0=r0, poc0=int(pic.ref_poc_l0[y4, x4]),
        mv1=(int(pic.mv_l1[y4, x4, 0]), int(pic.mv_l1[y4, x4, 1])),
        ref1=r1, poc1=int(pic.ref_poc_l1[y4, x4]))


def _pu_flags(pic, x0, y0, n_w, n_h):
    """Per-PU neighbour-availability flags (left, up, up_left,
    up_right_sap, bottom_left) — mirror of the reference's
    ff_hevc_set_neighbour_available (hevc_mvs.c:43) + per-CTB boundary
    flags (hevcdec.c hls_decode_neighbour).  Unlike the z-scan sample
    availability used for intra prediction, these allow a second PU to
    read the first PU's motion inside the same CU."""
    sps, pps = pic.sps, pic.pps
    lcb = sps.log2_ctb_size
    ctb = 1 << lcb
    x0b, y0b = x0 & (ctb - 1), y0 & (ctb - 1)
    cx, cy = x0 >> lcb, y0 >> lcb
    cur_slice = pic.slice_idx[cy, cx]
    tile = pps.tile_of_ctb

    def ctb_ok(nx, ny):
        if nx < 0 or ny < 0 or nx >= sps.ctb_w or ny >= sps.ctb_h:
            return False
        return (pic.slice_idx[ny, nx] == cur_slice
                and tile[ny, nx] == tile[cy, cx])

    left = bool(x0b) or ctb_ok(cx - 1, cy)
    up = bool(y0b) or ctb_ok(cx, cy - 1)
    if not x0b and not y0b:
        up_left = ctb_ok(cx - 1, cy - 1)
    else:
        up_left = left and up
    if x0b + n_w == ctb:
        up_right_sap = ctb_ok(cx + 1, cy - 1) and not y0b
    else:
        up_right_sap = up
    # end_of_tiles_y = bottom of the current CTB row (hevcdec.c:2816)
    eoty = min((cy << lcb) + ctb, sps.height)
    bottom_left = False if (y0 + n_h) >= eoty else left
    return left, up, up_left, up_right_sap, bottom_left


def _z_avail(pic, xc, yc, xn, yn) -> bool:
    """6.4.1 z-scan availability as the reference applies it to the A0/B0
    corner candidates (hevc_mvs.c:65 z_scan_block_avail)."""
    lcb = pic.sps.log2_ctb_size
    if (yn >> lcb) < (yc >> lcb) or (xn >> lcb) < (xc >> lcb):
        return True
    return pic.z_order[yn >> 2, xn >> 2] <= pic.z_order[yc >> 2, xc >> 2]


def _same_motion(a: MotionInfo, b: MotionInfo) -> bool:
    return (a.mv0 == b.mv0 and a.ref0 == b.ref0
            and a.mv1 == b.mv1 and a.ref1 == b.ref1)


_COMB_L0 = (0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3)
_COMB_L1 = (1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2)


def merge_candidates(pic, x_pb, y_pb, n_w, n_h, part_idx, part_mode,
                     max_cand, num_ref_l0, ref_poc_l0,
                     num_ref_l1=0, ref_poc_l1=(),
                     is_b=False, tc=None, lt0=None,
                     lt1=None) -> List[MotionInfo]:
    """Merge candidate list: spatial (8.5.3.2.3), combined bi
    (8.5.3.2.4 for B), zero padding (8.5.3.2.5).  Availability follows
    the reference's model (hevc_mvs.c:307 derive_spatial_merge_candidates):
    boundary flags for A1/B1/B2, z-scan only for the A0/B0 corners,
    part-shape exclusions for the second PU."""
    sps = pic.sps
    a1 = (x_pb - 1, y_pb + n_h - 1)
    b1 = (x_pb + n_w - 1, y_pb - 1)
    b0 = (x_pb + n_w, y_pb - 1)
    a0 = (x_pb - 1, y_pb + n_h)
    b2 = (x_pb - 1, y_pb - 1)
    f_left, f_up, f_up_left, f_up_right, f_bottom_left = \
        _pu_flags(pic, x_pb, y_pb, n_w, n_h)

    cand: List[MotionInfo] = []
    m_a1 = None
    # second-PU exclusions (8.5.3.2.3): A1 for vertical splits, B1 for
    # horizontal splits — AMP modes included
    if f_left and not (part_idx == 1 and part_mode in
                       (PART_Nx2N, PART_nLx2N, PART_nRx2N)):
        m_a1 = _motion_at(pic, *a1)
        if m_a1 is not None:
            cand.append(m_a1)
    # pruning compares against a neighbour's MOTION whenever available,
    # regardless of whether that neighbour was itself pruned
    m_b1 = None
    if f_up and not (part_idx == 1 and part_mode in
                     (PART_2NxN, PART_2NxnU, PART_2NxnD)):
        m_b1 = _motion_at(pic, *b1)
        if m_b1 is not None and not (m_a1 and _same_motion(m_b1, m_a1)):
            cand.append(m_b1)
    m_b0 = None
    if f_up_right and b0[0] < sps.width \
            and _z_avail(pic, x_pb, y_pb, *b0):
        m_b0 = _motion_at(pic, *b0)
    if m_b0 is not None and not (m_b1 and _same_motion(m_b0, m_b1)):
        cand.append(m_b0)
    m_a0 = None
    if f_bottom_left and a0[1] < sps.height \
            and _z_avail(pic, x_pb, y_pb, *a0):
        m_a0 = _motion_at(pic, *a0)
    if m_a0 is not None and not (m_a1 and _same_motion(m_a0, m_a1)):
        cand.append(m_a0)
    if len(cand) < 4:
        m_b2 = _motion_at(pic, *b2) if f_up_left else None
        if m_b2 is not None \
                and not (m_a1 and _same_motion(m_b2, m_a1)) \
                and not (m_b1 and _same_motion(m_b2, m_b1)):
            cand.append(m_b2)
    # temporal candidate (8.5.3.2.7): refIdx 0, after spatial
    if tc is not None and len(cand) < max_cand:
        mi = None
        mv0 = temporal_mv(tc, x_pb, y_pb, n_w, n_h, 0, ref_poc_l0[0],
                          target_lt=bool(lt0[0]) if lt0 else False)
        if mv0 is not None:
            mi = MotionInfo(mv0=mv0, ref0=0, poc0=ref_poc_l0[0])
        if is_b:
            mv1 = temporal_mv(tc, x_pb, y_pb, n_w, n_h, 1, ref_poc_l1[0],
                              target_lt=bool(lt1[0]) if lt1 else False)
            if mv1 is not None:
                if mi is None:
                    mi = MotionInfo()
                mi.mv1, mi.ref1, mi.poc1 = mv1, 0, ref_poc_l1[0]
        if mi is not None:
            cand.append(mi)
    if is_b and len(cand) > 1 and len(cand) < max_cand:
        n_orig = len(cand)
        for k in range(min(12, n_orig * (n_orig - 1))):
            i0, i1 = _COMB_L0[k], _COMB_L1[k]
            if i0 >= n_orig or i1 >= n_orig:
                continue
            c0, c1 = cand[i0], cand[i1]
            if not (c0.uses_l0 and c1.uses_l1):
                continue
            if c0.poc0 == c1.poc1 and c0.mv0 == c1.mv1:
                continue
            cand.append(MotionInfo(mv0=c0.mv0, ref0=c0.ref0, poc0=c0.poc0,
                                   mv1=c1.mv1, ref1=c1.ref1, poc1=c1.poc1))
            if len(cand) >= max_cand:
                break
    zero_idx = 0
    num_ref = min(num_ref_l0, num_ref_l1) if is_b else num_ref_l0
    while len(cand) < max_cand:
        ridx = zero_idx if zero_idx < num_ref else 0
        mi = MotionInfo(mv0=(0, 0), ref0=ridx, poc0=ref_poc_l0[ridx])
        if is_b:
            mi.ref1 = ridx
            mi.poc1 = ref_poc_l1[ridx]
        cand.append(mi)
        zero_idx += 1
    return cand[:max_cand]


def _scale_tb_td(mv, tb, td) -> Tuple[int, int]:
    """MV scaling core (8.5.3.2.8)."""
    td = max(-128, min(127, td))
    tb = max(-128, min(127, tb))
    if td == 0:
        return tuple(mv)
    tx = (16384 + (abs(td) >> 1)) // td
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    out = []
    for c in mv:
        v = dsf * c
        out.append(max(-32768, min(32767,
                                   (abs(v) + 127 >> 8) * (1 if v >= 0 else -1))))
    return tuple(out)


def _scale_mv(mv, cur_poc, cur_ref_poc, nb_ref_poc) -> Tuple[int, int]:
    """Spatial AMVP scaling: tb = cur-ref distance, td = neighbour's
    (reference: hevc_mvs.c:557 dist_scale — td of 0 clamps to 1)."""
    if nb_ref_poc == cur_ref_poc:
        return tuple(mv)
    td = cur_poc - nb_ref_poc
    if td == 0:
        td = 1
    return _scale_tb_td(mv, cur_poc - cur_ref_poc, td)


def _lx_of(m: MotionInfo, lx: int):
    """Neighbour's (mv, ref_poc, ref_idx) for list lx, or None."""
    if lx == 0:
        return (m.mv0, m.poc0, m.ref0) if m.uses_l0 else None
    return (m.mv1, m.poc1, m.ref1) if m.uses_l1 else None


def amvp_candidates(pic, x_pb, y_pb, n_w, n_h, lx, ref_idx, ref_poc_list,
                    cur_poc, tc=None, lt0=None, lt1=None,
                    ref_lt_list=None) -> List[Tuple[int, int]]:
    """Spatial AMVP candidates for list lx (8.5.3.2.6-7): [mvp0, mvp1].

    A neighbour contributes from either of its lists: same-ref first,
    then (per the isScaledFlag rule) scaled from any reference.
    lt0/lt1: per-ref-idx long-term flags of the slice's L0/L1 — the
    scaled pass requires matching long-term status and never scales
    long-term MVs (reference: hevc_mvs.c:600 mv_mp_mode_mx_lt)."""
    target_poc = ref_poc_list[ref_idx]
    lt_of = (lt0 or (), lt1 or ())
    cur_lt = bool(lt_of[lx][ref_idx]) if ref_idx < len(lt_of[lx]) else False
    sps = pic.sps
    a0 = (x_pb - 1, y_pb + n_h)
    a1 = (x_pb - 1, y_pb + n_h - 1)
    b0 = (x_pb + n_w, y_pb - 1)
    b1 = (x_pb + n_w - 1, y_pb - 1)
    b2 = (x_pb - 1, y_pb - 1)
    # availability model of the reference's ff_hevc_luma_mv_mvp_mode
    # (hevc_mvs.c:635): A1/B1/B2 by boundary flags only (no same-CU
    # exclusion — AMVP may read the first PU's motion); z-scan for the
    # A0/B0 corners
    f_left, f_up, f_up_left, f_up_right, f_bottom_left = \
        _pu_flags(pic, x_pb, y_pb, n_w, n_h)
    av_a0 = (f_bottom_left and a0[1] < sps.height
             and _z_avail(pic, x_pb, y_pb, *a0))
    av_b0 = (f_up_right and b0[0] < sps.width
             and _z_avail(pic, x_pb, y_pb, *b0))

    def motion(pos, avail):
        return _motion_at(pic, *pos) if avail else None

    def same_ref(m):
        for l in (lx, 1 - lx):
            got = _lx_of(m, l)
            if got is not None and got[1] == target_poc:
                return got[0]
        return None

    def nb_lt(l, ridx):
        return bool(lt_of[l][ridx]) if ridx < len(lt_of[l]) else False

    def any_ref_scaled(m):
        for l in (lx, 1 - lx):
            got = _lx_of(m, l)
            if got is None:
                continue
            if nb_lt(l, got[2]) != cur_lt:
                continue  # long-term status must match
            if cur_lt:
                return got[0]  # both long-term: no scaling
            return _scale_mv(got[0], cur_poc, target_poc, got[1])
        return None

    mv_a = None
    a_neigh = [motion(a0, av_a0), motion(a1, f_left)]
    # isScaledFlag (8.5.3.2.6): an A position is available AND not intra
    # (reference: is_available_a0 || is_available_a1)
    a_block_avail = any(m is not None for m in a_neigh)
    for m in a_neigh:
        if m is not None:
            got = same_ref(m)
            if got is not None:
                mv_a = got
                break
    if mv_a is None:
        for m in a_neigh:
            if m is not None:
                got = any_ref_scaled(m)
                if got is not None:
                    mv_a = got
                    break
    mv_b = None
    b_neigh = [motion(b0, av_b0), motion(b1, f_up), motion(b2, f_up_left)]
    for m in b_neigh:
        if m is not None:
            got = same_ref(m)
            if got is not None:
                mv_b = got
                break
    if not a_block_avail:
        if mv_a is None:
            mv_a = mv_b
            mv_b = None
        if mv_b is None:
            for m in b_neigh:
                if m is not None:
                    got = any_ref_scaled(m)
                    if got is not None:
                        mv_b = got
                        break
    out = []
    if mv_a is not None:
        out.append(tuple(mv_a))
    if mv_b is not None and (not out or tuple(mv_b) != out[0]):
        out.append(tuple(mv_b))
    if tc is not None and len(out) < 2:
        t = temporal_mv(tc, x_pb, y_pb, n_w, n_h, lx, target_poc,
                        target_lt=cur_lt)
        if t is not None:
            out.append(tuple(t))
    while len(out) < 2:
        out.append((0, 0))
    return out[:2]


@dataclass
class TemporalCtx:
    """Collocated-picture context for TMVP (8.5.3.2.7-9).

    col: stored motion of the collocated picture — dict with mv0/mv1
    [h4,w4,2], poc0/poc1 [h4,w4] (NO_POC = unused), poc (its own POC);
    cur_poc: current picture POC; no_backward: NoBackwardPredFlag."""
    col: dict
    cur_poc: int
    ctb_log2: int
    pic_w: int
    pic_h: int
    no_backward: bool = True
    col_from_l0: bool = True


def _col_motion_at(tc: TemporalCtx, x: int, y: int):
    """Collocated motion at luma (x, y), 16x16 compressed granularity."""
    if x >= tc.pic_w or y >= tc.pic_h or x < 0 or y < 0:
        return None
    x, y = (x >> 4) << 4, (y >> 4) << 4
    y4, x4 = y >> 2, x >> 2
    col = tc.col
    p0 = int(col["poc0"][y4, x4])
    p1 = int(col["poc1"][y4, x4])
    if p0 == NO_POC and p1 == NO_POC:
        return None  # intra / unused
    return (tuple(int(v) for v in col["mv0"][y4, x4]), p0,
            tuple(int(v) for v in col["mv1"][y4, x4]), p1)


def temporal_mv(tc: TemporalCtx, x_pb, y_pb, n_w, n_h, lx, target_poc,
                target_lt: bool = False):
    """Temporal candidate mvLXCol for list lx towards target_poc, or
    None.  Tries C0 (bottom-right, same-CTB-row constraint) then C1
    (centre).

    Long-term rule (reference: hevc_mvs.c:141 check_mvset): the target
    ref and the collocated block's ref must have matching long-term
    status; long-term MVs are never scaled.  A collocated ref is
    long-term exactly when its poc equals the collocated picture's own
    poc — only SHVC inter-layer refs are long-term in this framework
    and they always share the referencing picture's poc."""
    cands = []
    x_br, y_br = x_pb + n_w, y_pb + n_h
    if (y_pb >> tc.ctb_log2) == (y_br >> tc.ctb_log2):
        cands.append((x_br, y_br))
    cands.append((x_pb + (n_w >> 1), y_pb + (n_h >> 1)))
    for (x, y) in cands:
        m = _col_motion_at(tc, x, y)
        if m is None:
            continue
        mv0, p0, mv1, p1 = m
        # list selection (8.5.3.2.9)
        if p0 == NO_POC:
            mv_col, ref_col = mv1, p1
        elif p1 == NO_POC:
            mv_col, ref_col = mv0, p0
        elif tc.no_backward:
            mv_col, ref_col = (mv0, p0) if lx == 0 else (mv1, p1)
        else:
            if tc.col_from_l0:
                mv_col, ref_col = mv1, p1
            else:
                mv_col, ref_col = mv0, p0
        col_lt = ref_col == tc.col["poc"]
        if col_lt != bool(target_lt):
            continue  # candidate unusable at this position
        tb = tc.cur_poc - target_poc
        td = tc.col["poc"] - ref_col
        if target_lt or tb == td or td == 0:
            return tuple(mv_col)
        return _scale_tb_td(mv_col, tb, td)
    return None
