"""Scaling lists (quantization matrices), H.265 7.3.4/7.4.5 + 8.6.3.

Capability parity with the reference's ScalingList handling
(hevc_ps.c:1727 set_default_scaling_list_data, :1757 scaling_list_data;
application in hevc_cabac.c:1484-1553 derive_quant_parameters and
:2030 scale_and_clip_coeff).  Storage layout: sl[size_id][matrix_id] is
the matrix in raster order (16 entries for size_id 0, 64 otherwise);
sl_dc[size_id-2][matrix_id] holds the DC scale for 16x16/32x32.

Frozen copy of ``hevc_tpu_torch/coding/scaling.py`` at ee5ffe9.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .scans import SCAN_DIAG, scan_xy

# default quantization matrices, H.265 Table 7-5/7-6 (raster order)
DEFAULT_INTRA_8 = np.array([
    16, 16, 16, 16, 17, 18, 21, 24,
    16, 16, 16, 16, 17, 19, 22, 25,
    16, 16, 17, 18, 20, 22, 25, 29,
    16, 16, 18, 21, 24, 27, 31, 36,
    17, 17, 20, 24, 30, 35, 41, 47,
    18, 19, 22, 27, 35, 44, 54, 65,
    21, 22, 25, 31, 41, 54, 70, 88,
    24, 25, 29, 36, 47, 65, 88, 115], np.int32)
DEFAULT_INTER_8 = np.array([
    16, 16, 16, 16, 17, 18, 20, 24,
    16, 16, 16, 17, 18, 20, 24, 25,
    16, 16, 17, 18, 20, 24, 25, 28,
    16, 17, 18, 20, 24, 25, 28, 33,
    17, 18, 20, 24, 25, 28, 33, 41,
    18, 20, 24, 25, 28, 33, 41, 54,
    20, 24, 25, 28, 33, 41, 54, 71,
    24, 25, 28, 33, 41, 54, 71, 91], np.int32)


def _diag_positions(size: int) -> np.ndarray:
    """Raster position per up-right-diagonal scan index (6.5.3)."""
    xy = scan_xy(SCAN_DIAG, size)
    return xy[:, 1] * size + xy[:, 0]


class ScalingListData:
    """One scaling_list_data() payload: 4 size classes x 6 matrices."""

    def __init__(self):
        self.sl = [np.empty((6, 16 if s == 0 else 64), np.int32)
                   for s in range(4)]
        self.sl_dc = np.full((2, 6), 16, np.int32)
        self.set_default()

    def set_default(self):
        self.sl[0][:] = 16
        for s in (1, 2, 3):
            self.sl[s][0:3] = DEFAULT_INTRA_8
            self.sl[s][3:6] = DEFAULT_INTER_8
        self.sl_dc[:] = 16

    # ---- bitstream -------------------------------------------------------
    def parse(self, r, chroma_format_idc: int = 1) -> "ScalingListData":
        for size_id in range(4):
            matrix_id = 0
            while matrix_id < 6:
                if r.flag():  # scaling_list_pred_mode_flag: explicit
                    next_coef = 8
                    coef_num = min(64, 1 << (4 + (size_id << 1)))
                    if size_id > 1:
                        next_coef = r.se() + 8
                        self.sl_dc[size_id - 2][matrix_id] = next_coef
                    pos = _diag_positions(4 if size_id == 0 else 8)
                    for i in range(coef_num):
                        next_coef = (next_coef + r.se() + 256) % 256
                        self.sl[size_id][matrix_id][pos[i]] = next_coef
                else:
                    delta = r.ue()
                    if delta:  # copy from earlier matrix (0 = keep default)
                        # Deliberate bug-for-bug parity with the reference:
                        # spec 7.4.5 says refMatrixId = matrixId -
                        # delta*(sizeId==3 ? 3 : 1), but the reference's
                        # scaling_list_data (hevc_ps.c) subtracts the raw
                        # delta for 32x32 too.  Our oracle is the reference
                        # binary, so we match it; encoder.write only emits
                        # delta patterns where the two agree.
                        self.sl[size_id][matrix_id] = \
                            self.sl[size_id][matrix_id - delta]
                        if size_id > 1:
                            self.sl_dc[size_id - 2][matrix_id] = \
                                self.sl_dc[size_id - 2][matrix_id - delta]
                matrix_id += 3 if size_id == 3 else 1
        if chroma_format_idc == 3:
            self.remap_444()
        return self

    def remap_444(self):
        """32x32 chroma matrices mirror the 16x16 ones in 4:4:4 (7.4.5
        note; reference: hevc_ps.c:1811-1820).  Called at parse time for
        the SPS and from PPS.derive once the SPS is known."""
        for m in (1, 2, 4, 5):
            self.sl[3][m] = self.sl[2][m]
            self.sl_dc[1][m] = self.sl_dc[0][m]

    def write(self, w, explicit: bool = True):
        """Emit scaling_list_data.  explicit=False signals all-default
        (pred_mode 0, delta 0); True writes the stored coefficients."""
        for size_id in range(4):
            matrix_id = 0
            while matrix_id < 6:
                if not explicit:
                    w.flag(0)
                    w.ue(0)
                else:
                    w.flag(1)
                    coef_num = min(64, 1 << (4 + (size_id << 1)))
                    next_coef = 8
                    if size_id > 1:
                        dc = int(self.sl_dc[size_id - 2][matrix_id])
                        w.se(dc - 8)
                        next_coef = dc
                    pos = _diag_positions(4 if size_id == 0 else 8)
                    for i in range(coef_num):
                        c = int(self.sl[size_id][matrix_id][pos[i]])
                        d = (c - next_coef + 256) % 256
                        if d > 127:
                            d -= 256
                        w.se(d)
                        next_coef = c
                matrix_id += 3 if size_id == 3 else 1

    # ---- 8.6.3 application -----------------------------------------------
    def factor(self, log2_size: int, matrix_id: int):
        """(S x S raster scale matrix, dc_scale) for one TU.

        16x16/32x32 expand the stored 8x8 matrix by 2x/4x blocks with the
        DC entry overridden (reference: scale_and_clip_coeff position
        mapping hevc_cabac.c:2035-2044)."""
        size_id = log2_size - 2
        s = 1 << log2_size
        if size_id == 0:
            m = self.sl[0][matrix_id].reshape(4, 4).copy()
            dc = int(m[0, 0])
        elif size_id == 1:
            m = self.sl[1][matrix_id].reshape(8, 8).copy()
            dc = int(m[0, 0])
        else:
            base = self.sl[size_id][matrix_id].reshape(8, 8)
            rep = s // 8
            m = np.repeat(np.repeat(base, rep, 0), rep, 1).copy()
            dc = int(self.sl_dc[size_id - 2][matrix_id])
            m[0, 0] = dc
        return m, dc


def matrix_id_for(is_inter: bool, c_idx: int) -> int:
    """matrix_id = 3 * pred + c_idx (reference: hevc_cabac.c:1547-1548).
    32x32 only stores luma matrices; 4:4:4 chroma 32x32 was remapped at
    parse time, so the same id is valid for every size class."""
    return 3 * int(is_inter) + c_idx
