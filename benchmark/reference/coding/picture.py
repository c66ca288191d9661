"""Per-picture decode/encode state: planes, mode maps, z-scan availability.

Capability parity with the reference's per-picture tab_* arrays and the
z-scan address maps built in setup_pps (reference: libavcodec/hevcdec.h:
612-632, hevc_ps.c:2525 min_tb_addr_zs), re-derived from H.265 6.4.1/6.5.2.

All availability logic runs on the 4x4 luma grid: a neighbour sample is
available iff it lies inside the picture, its 4x4 block precedes the
current block in z-scan (tile-scan-major) order, and both blocks share a
slice and tile.

Frozen copy of ``hevc_tpu_torch/coding/picture.py`` at ee5ffe9.
"""
from __future__ import annotations

import numpy as np

from ..bitstream.ps import PPS, SPS
from ..ops import reference as R


def _z_order_map(sps: SPS, pps: PPS) -> np.ndarray:
    """z_order[y4, x4] — decode-order rank of each 4x4 luma block."""
    d = sps.log2_ctb_size - 2
    w4 = -(-sps.width // 4)
    h4 = -(-sps.height // 4)
    ys, xs = np.mgrid[0:h4, 0:w4]
    cx, cy = xs >> d, ys >> d
    base = pps.ctb_addr_rs_to_ts[cy * sps.ctb_w + cx].astype(np.int64) << (2 * d)
    lx, ly = xs & ((1 << d) - 1), ys & ((1 << d) - 1)
    z = np.zeros_like(base)
    for i in range(d):
        z |= ((lx >> i) & 1).astype(np.int64) << (2 * i)
        z |= ((ly >> i) & 1).astype(np.int64) << (2 * i + 1)
    return base + z


class PictureState:
    """Reconstruction planes + per-block side info for one picture."""

    def __init__(self, sps: SPS, pps: PPS):
        self.sps = sps
        self.pps = pps
        w, h = sps.width, sps.height
        cw, ch = w // sps.sub_w, h // sps.sub_h
        dt = np.uint8 if sps.bit_depth_luma <= 8 else np.uint16
        self.planes = [np.zeros((h, w), dt)]
        if sps.chroma_format_idc:
            self.planes += [np.zeros((ch, cw), dt),
                            np.zeros((ch, cw), dt)]
        self.w4 = -(-w // 4)
        self.h4 = -(-h // 4)
        # z-order map is a pure function of the SPS/PPS geometry and is
        # only ever read — cache it on the PPS across pictures
        zkey = (w, h, sps.log2_ctb_size)
        cached = getattr(pps, "_z_order_cache", None)
        if cached is None or cached[0] != zkey:
            pps._z_order_cache = (zkey, _z_order_map(sps, pps))
        self.z_order = pps._z_order_cache[1]
        # progress watermark: z rank below which blocks are reconstructed
        self.z_decoded = 0
        # per-4x4 side info
        self.intra_mode_y = np.full((self.h4, self.w4), R.INTRA_DC, np.int8)
        self.is_intra = np.zeros((self.h4, self.w4), bool)
        self.ct_depth = np.zeros((self.h4, self.w4), np.int8)
        self.skip_flag = np.zeros((self.h4, self.w4), bool)
        self.qp_y = np.zeros((self.h4, self.w4), np.int8)
        # per-CTB slice index (tile id comes from pps.tile_of_ctb)
        self.slice_idx = np.full((sps.ctb_h, sps.ctb_w), -1, np.int32)
        # per-4x4 CU transquant bypass + transform-skip flags (for filters)
        self.tq_bypass = np.zeros((self.h4, self.w4), bool)
        # per-4x4 "loop filters must not modify these samples" mask:
        # lossless CUs (8.7.2.5.3 nDp/nQp=0) and PCM CUs when
        # pcm_loop_filter_disabled_flag (reference: is_pcm/tq-bypass tests
        # in hevc_filter.c deblocking + sao_edge_restore)
        self.no_filter = np.zeros((self.h4, self.w4), bool)
        # deblocking boundary strengths: bs_v = left edge of each 4x4,
        # bs_h = top edge (reference: hevc_filter.c boundary_strength :765)
        self.bs_v = np.zeros((self.h4, self.w4), np.int8)
        self.bs_h = np.zeros((self.h4, self.w4), np.int8)
        # edge maps (TU or PU boundary) for BS derivation
        self.edge_v = np.zeros((self.h4, self.w4), bool)
        self.edge_h = np.zeros((self.h4, self.w4), bool)
        # transform-block edges only: the cbf term of 8.7.2.4 applies at
        # TU edges, not at PU-internal (AMP) edges
        self.tu_edge_v = np.zeros((self.h4, self.w4), bool)
        self.tu_edge_h = np.zeros((self.h4, self.w4), bool)
        # per-4x4 luma-cbf (nonzero residual) flag
        self.cbf_luma = np.zeros((self.h4, self.w4), bool)
        # motion fields: mv in quarter-pel, ref poc; ref_lx < 0 = unused
        self.mv_l0 = np.zeros((self.h4, self.w4, 2), np.int32)
        self.ref_l0 = np.full((self.h4, self.w4), -1, np.int8)
        self.ref_poc_l0 = np.full((self.h4, self.w4), -(1 << 30), np.int64)
        self.mv_l1 = np.zeros((self.h4, self.w4, 2), np.int32)
        self.ref_l1 = np.full((self.h4, self.w4), -1, np.int8)
        self.ref_poc_l1 = np.full((self.h4, self.w4), -(1 << 30), np.int64)

    def mark_block_edges(self, x0: int, y0: int, w: int, h: int):
        """Record a PU boundary on the left/top edges of a block."""
        x4, y4 = x0 >> 2, y0 >> 2
        if x0 > 0:
            self.edge_v[y4:y4 + (h >> 2), x4] = True
        if y0 > 0:
            self.edge_h[y4, x4:x4 + (w >> 2)] = True

    def mark_intra_tu_edges(self, x0: int, y0: int, size: int):
        """Record a TU boundary (also marks the combined edge maps)."""
        self.mark_block_edges(x0, y0, size, size)
        x4, y4 = x0 >> 2, y0 >> 2
        if x0 > 0:
            self.tu_edge_v[y4:y4 + (size >> 2), x4] = True
        if y0 > 0:
            self.tu_edge_h[y4, x4:x4 + (size >> 2)] = True

    def _bs_motion_differs(self, p, q):
        """8.7.2.4 motion-based bs=1 test between slices p/q of the 4x4
        maps (vectorized; handles uni and bi cases)."""
        big = -(1 << 30)
        p_has0 = self.ref_poc_l0[p] != big
        p_has1 = self.ref_poc_l1[p] != big
        q_has0 = self.ref_poc_l0[q] != big
        q_has1 = self.ref_poc_l1[q] != big
        np_ = p_has0.astype(np.int32) + p_has1
        nq = q_has0.astype(np.int32) + q_has1
        diff = np_ != nq

        def mvd_ge4(a, b):
            return np.abs(a - b).max(axis=-1) >= 4

        # uni/uni: compare the single used vectors and refs
        p_mv_uni = np.where(p_has0[..., None], self.mv_l0[p], self.mv_l1[p])
        q_mv_uni = np.where(q_has0[..., None], self.mv_l0[q], self.mv_l1[q])
        p_poc_uni = np.where(p_has0, self.ref_poc_l0[p], self.ref_poc_l1[p])
        q_poc_uni = np.where(q_has0, self.ref_poc_l0[q], self.ref_poc_l1[q])
        uni = (p_poc_uni != q_poc_uni) | mvd_ge4(p_mv_uni, q_mv_uni)
        # bi/bi
        same_pair = (((self.ref_poc_l0[p] == self.ref_poc_l0[q])
                      & (self.ref_poc_l1[p] == self.ref_poc_l1[q]))
                     | ((self.ref_poc_l0[p] == self.ref_poc_l1[q])
                        & (self.ref_poc_l1[p] == self.ref_poc_l0[q])))
        same_ref_both = self.ref_poc_l0[p] == self.ref_poc_l1[p]
        straight = (mvd_ge4(self.mv_l0[p], self.mv_l0[q])
                    | mvd_ge4(self.mv_l1[p], self.mv_l1[q]))
        crossed = (mvd_ge4(self.mv_l0[p], self.mv_l1[q])
                   | mvd_ge4(self.mv_l1[p], self.mv_l0[q]))
        l0_matches = self.ref_poc_l0[p] == self.ref_poc_l0[q]
        bi = np.where(same_ref_both, straight & crossed,
                      np.where(l0_matches, straight, crossed))
        bi = bi | ~same_pair
        both_bi = (np_ == 2) & (nq == 2)
        return diff | np.where(both_bi, bi, uni)

    def compute_bs(self):
        """Boundary strengths (8.7.2.4), in NumPy (the reference has no
        native code)."""
        return self.compute_bs_numpy()

    def compute_bs_numpy(self):
        """Boundary strengths (8.7.2.4) from the per-4x4 maps.

        bs=2 if either side intra; else 1 if either side has residual or
        the motion differs (refs / >=4 quarter-pel MV delta, uni or bi)."""
        for vertical in (True, False):
            edge = self.edge_v if vertical else self.edge_h
            bs = self.bs_v if vertical else self.bs_h
            if vertical:
                q = np.s_[:, 1:]
                p = np.s_[:, :-1]
                tgt = np.s_[:, 1:]
            else:
                q = np.s_[1:, :]
                p = np.s_[:-1, :]
                tgt = np.s_[1:, :]
            tu_edge = self.tu_edge_v if vertical else self.tu_edge_h
            intra_pq = self.is_intra[q] | self.is_intra[p]
            # cbf term only at transform-block edges (8.7.2.4); motion
            # term at any PU/TU edge
            resid = (self.cbf_luma[q] | self.cbf_luma[p]) & tu_edge[tgt]
            one = resid | self._bs_motion_differs(p, q)
            val = np.where(intra_pq, 2, np.where(one, 1, 0))
            bs[tgt] = np.where(edge[tgt], val, 0).astype(np.int8)
        self.bs_v[:, 0] = 0
        self.bs_h[0, :] = 0
        return self.bs_v, self.bs_h

    # -- availability ------------------------------------------------------
    def set_ctb_slice(self, ctb_x: int, ctb_y: int, slice_idx: int):
        self.slice_idx[ctb_y, ctb_x] = slice_idx

    def mark_block(self, x0: int, y0: int, size: int):
        """Advance the decoded watermark past luma block (x0, y0, size)."""
        z = self.z_order[(y0 + size - 1) >> 2, (x0 + size - 1) >> 2]
        self.z_decoded = max(self.z_decoded, int(z) + 1)

    def available(self, x_curr: int, y_curr: int, x_n: int, y_n: int) -> bool:
        """6.4.1 z-scan availability: neighbour luma sample (x_n, y_n)
        relative to current block at (x_curr, y_curr)."""
        if x_n < 0 or y_n < 0 or x_n >= self.sps.width or y_n >= self.sps.height:
            return False
        zn = self.z_order[y_n >> 2, x_n >> 2]
        zc = self.z_order[y_curr >> 2, x_curr >> 2]
        if zn >= zc:
            return False
        lc = self.sps.log2_ctb_size
        sn = self.slice_idx[y_n >> lc, x_n >> lc]
        sc = self.slice_idx[y_curr >> lc, x_curr >> lc]
        if sn != sc:
            return False
        if self.pps.tile_of_ctb[y_n >> lc, x_n >> lc] != \
                self.pps.tile_of_ctb[y_curr >> lc, x_curr >> lc]:
            return False
        return True

    # -- intra reference samples ------------------------------------------
    def intra_refs(self, c_idx: int, x0: int, y0: int, n: int):
        """Gather + substitute the 4n+1 intra reference samples (8.4.4.2.2).

        x0, y0 in component coords; returns (left, top, corner) int32
        after substitution, ready for filter/predict."""
        sps = self.sps
        sx = sps.sub_w if c_idx else 1
        sy = sps.sub_h if c_idx else 1
        plane = self.planes[c_idx]
        ph, pw = plane.shape
        n2 = 2 * n
        left = np.zeros(n2, np.int32)
        top = np.zeros(n2, np.int32)
        avail_l = np.zeros(n2, bool)
        avail_t = np.zeros(n2, bool)
        xl, yl = x0 * sx, y0 * sy  # luma coords of block origin
        for i in range(n2):
            if y0 + i < ph and self.available(xl, yl, xl - sx, (y0 + i) * sy):
                avail_l[i] = True
                left[i] = plane[y0 + i, x0 - 1]
        for i in range(n2):
            if x0 + i < pw and self.available(xl, yl, (x0 + i) * sx, yl - sy):
                avail_t[i] = True
                top[i] = plane[y0 - 1, x0 + i]
        avail_c = self.available(xl, yl, xl - sx, yl - sy)
        corner = int(plane[y0 - 1, x0 - 1]) if avail_c else 0
        bd = sps.bit_depth_luma if c_idx == 0 else sps.bit_depth_chroma
        return R.prepare_intra_refs(left, top, corner, avail_l, avail_t,
                                    avail_c, n, bd)

    def predict_intra(self, c_idx: int, x0: int, y0: int, n: int,
                      mode: int) -> np.ndarray:
        left, top, corner = self.intra_refs(c_idx, x0, y0, n)
        sps = self.sps
        bd = sps.bit_depth_luma if c_idx == 0 else sps.bit_depth_chroma
        return R.intra_predict(
            mode, left, top, corner, n, c_idx, bd,
            chroma444=(sps.chroma_format_idc == 3),
            strong_smoothing=bool(sps.strong_intra_smoothing),
            smoothing_disabled=bool(sps.intra_smoothing_disabled))

    # -- neighbour queries for syntax contexts ----------------------------
    def ctdepth_gt(self, x0: int, y0: int, depth: int) -> int:
        """split_cu_flag ctxInc contribution from (left, above) neighbours."""
        inc = 0
        if self.available(x0, y0, x0 - 1, y0) and \
                self.ct_depth[y0 >> 2, (x0 - 1) >> 2] > depth:
            inc += 1
        if self.available(x0, y0, x0, y0 - 1) and \
                self.ct_depth[(y0 - 1) >> 2, x0 >> 2] > depth:
            inc += 1
        return inc

    def luma_intra_mode_cand(self, x_pb: int, y_pb: int) -> tuple:
        """(candA, candB) for MPM derivation (8.4.2)."""
        cand = [R.INTRA_DC, R.INTRA_DC]
        for k, (xn, yn) in enumerate(((x_pb - 1, y_pb), (x_pb, y_pb - 1))):
            if not self.available(x_pb, y_pb, xn, yn):
                continue
            if not self.is_intra[yn >> 2, xn >> 2]:
                continue
            if k == 1 and (y_pb - 1) >> self.sps.log2_ctb_size != \
                    y_pb >> self.sps.log2_ctb_size:
                continue  # above CTB row: forced DC
            cand[k] = int(self.intra_mode_y[yn >> 2, xn >> 2])
        return cand[0], cand[1]


def mpm_list(cand_a: int, cand_b: int):
    """8.4.2 candModeList derivation."""
    if cand_a == cand_b:
        if cand_a < 2:
            return [R.INTRA_PLANAR, R.INTRA_DC, R.INTRA_ANGULAR_VER]
        return [cand_a,
                2 + ((cand_a + 29) % 32),
                2 + ((cand_a - 2 + 1) % 32)]
    lst = [cand_a, cand_b]
    if cand_a != R.INTRA_PLANAR and cand_b != R.INTRA_PLANAR:
        lst.append(R.INTRA_PLANAR)
    elif cand_a != R.INTRA_DC and cand_b != R.INTRA_DC:
        lst.append(R.INTRA_DC)
    else:
        lst.append(R.INTRA_ANGULAR_VER)
    return lst


CHROMA_CAND = (R.INTRA_PLANAR, R.INTRA_ANGULAR_VER, R.INTRA_ANGULAR_HOR,
               R.INTRA_DC)

# Table 8-3: intra mode conversion for 4:2:2 chroma
CHROMA_422_MODE = (0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18,
                   19, 20, 21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28,
                   28, 29, 29, 30, 31)


def chroma_mode_from_idx(idx: int, luma_mode: int) -> int:
    """8.4.3: intra_chroma_pred_mode 0..3 → mode (4 means derived=luma)."""
    if idx == 4:
        return luma_mode
    m = CHROMA_CAND[idx]
    return 34 if m == luma_mode else m


def chroma_mode_to_idx(mode: int, luma_mode: int) -> int:
    for i, m in enumerate(CHROMA_CAND):
        target = 34 if m == luma_mode else m
        if mode == target:
            return i
    assert mode == luma_mode, (mode, luma_mode)
    return 4


def crop_conf_win(planes, sps: SPS):
    """Crop decoded planes to the conformance window (7.4.3.2.1
    conf_win offsets are in chroma units; reference output crop:
    openhevc.c:662-740 oh_output_cropped_cpy)."""
    cw = getattr(sps, "conf_win", (0, 0, 0, 0))
    if not any(cw):
        return planes
    le, ri, to, bo = cw
    out = []
    for ci, p in enumerate(planes):
        fx = sps.sub_w if ci == 0 else 1
        fy = sps.sub_h if ci == 0 else 1
        h, w = p.shape
        out.append(p[to * fy:h - bo * fy, le * fx:w - ri * fx])
    return out
