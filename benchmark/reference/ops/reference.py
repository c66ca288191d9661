"""Bit-exact NumPy reference ops for HEVC reconstruction (stage B).

These are the scalar oracles for the Pallas/JAX kernels in this package:
every TPU kernel must match these functions exactly (integer arithmetic,
H.265 clauses 8.4 intra prediction, 8.6 scaling/transform).

Capability parity with the reference's hevcdsp_template.c /
hevcpred_template.c (reference: libavcodec/hevcdsp_template.c:62-496,
hevcpred_template.c:30-540), re-derived from the specification.

Frozen copy of ``hevc_tpu_torch/ops/reference.py`` at ee5ffe9.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Transform matrices (H.265 8.6.4.2) — spec constants
# ---------------------------------------------------------------------------

def _dct_matrix(n: int) -> np.ndarray:
    """The HEVC integer DCT-II basis transMatrix[k][j] for size n.

    Rows of the 32x32 matrix are defined by the spec; smaller sizes are
    subsampled: T_n[k][j] = T_32[k * (32/n)][j]."""
    # first-column coefficients of the 32-point matrix (spec 8.6.4.2)
    c32 = [
        64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
        64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4,
    ]
    T32 = np.zeros((32, 32), np.int64)
    # T32[k][j] derived from the DCT-II structure: T[k][j] =
    # round(64*sqrt(2/N)*cos((2j+1)k*pi/2N)) — the spec fixes the integer
    # values; reconstruct via the standard symmetry from the odd/even
    # decomposition using the canonical coefficient set.
    coef = np.array([
        64, 83, 36,  # 4-pt extras
        89, 75, 50, 18,  # 8-pt odd
        90, 87, 80, 70, 57, 43, 25, 9,  # 16-pt odd
        90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,  # 32-pt odd
    ], np.int64)
    # build exactly by the recursive even/odd definition
    def build(n):
        if n == 1:
            return np.array([[64]], np.int64)
        half = build(n // 2)
        T = np.zeros((n, n), np.int64)
        # even rows: T[2k][j] = half[k][j] for j<n/2, mirrored symmetrically
        # (cos((2(n-1-j)+1)·2k·π/2n) = cos(2kπ − (2j+1)kπ/n) = cos((2j+1)kπ/n))
        for k in range(n // 2):
            for j in range(n // 2):
                T[2 * k][j] = half[k][j]
                T[2 * k][n - 1 - j] = half[k][j]
        # odd rows from the canonical odd coefficient set
        if n == 2:
            odd = np.array([64], np.int64)
        elif n == 4:
            odd = np.array([83, 36], np.int64)
        elif n == 8:
            odd = np.array([89, 75, 50, 18], np.int64)
        elif n == 16:
            odd = np.array([90, 87, 80, 70, 57, 43, 25, 9], np.int64)
        else:
            odd = np.array([90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46,
                            38, 31, 22, 13, 4], np.int64)
        # T[2k+1][j]: generated by cos((2j+1)(2k+1)pi/2n) pattern; use the
        # DCT-II closed form with exact integer table lookup:
        # value = odd-coef of |...|; easier: numeric cos with rounding to
        # the known grid then snap to the odd coefficient set by magnitude.
        for k in range(n // 2):
            row = 2 * k + 1
            for j in range(n):
                c = np.cos((2 * j + 1) * row * np.pi / (2 * n))
                mag_target = abs(c) * 64 * np.sqrt(2)
                # snap to nearest value in the odd set
                idx = np.argmin(np.abs(odd - mag_target))
                T[row][j] = int(odd[idx]) * (1 if c > 0 else -1 if c < 0 else 0)
        return T
    return build(n)


# DST-VII 4x4 (spec 8.6.4.1)
DST4 = np.array([
    [29, 55, 74, 84],
    [74, 74, 0, -74],
    [84, -29, -74, 55],
    [55, -84, 74, -29],
], np.int64)

_DCT = {n: _dct_matrix(n) for n in (4, 8, 16, 32)}

LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], np.int64)


def dct_matrix(n: int) -> np.ndarray:
    return _DCT[n]


def dequant(levels: np.ndarray, qp: int, log2_size: int, bit_depth: int,
            scale_matrix=None, dc_scale: int = 16) -> np.ndarray:
    """Scaling process for transform coefficients (8.6.3).

    levels: int array [S,S] of TransCoeffLevel. Returns int32 d[S,S]
    clipped to 16-bit."""
    bd_shift = bit_depth + log2_size - 5
    if scale_matrix is None:
        m = np.full(levels.shape, 16, np.int64)
    else:
        m = scale_matrix.astype(np.int64).copy()
        m[0, 0] = dc_scale
    d = (levels.astype(np.int64) * m * (LEVEL_SCALE[qp % 6] << (qp // 6))
         + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)


def inverse_transform(d: np.ndarray, bit_depth: int, dst: bool = False) -> np.ndarray:
    """Inverse 2-D transform (8.6.4): returns residual int array [S,S].

    d is the dequantized coefficient array (row-major, d[y][x])."""
    n = d.shape[0]
    T = DST4 if dst else _DCT[n]
    # stage 1 (columns): e = clip16((T^T @ d + 64) >> 7)
    e = (T.T.astype(np.int64) @ d.astype(np.int64) + 64) >> 7
    e = np.clip(e, -32768, 32767)
    # stage 2 (rows): r = clip16((e @ T + add) >> shift2)
    shift2 = 20 - bit_depth
    r = (e @ T.astype(np.int64) + (1 << (shift2 - 1))) >> shift2
    return np.clip(r, -32768, 32767).astype(np.int32)


def transform_skip_residual(d: np.ndarray, bit_depth: int) -> np.ndarray:
    """Transform-skip path (8.6.4.2): r = (d + off) >> (15 - bd - log2)
    — the shift is SIZE-dependent (reference: hevcdsp_template.c:109
    transform_skip; rext allows skip blocks up to 32x32)."""
    log2 = d.shape[-1].bit_length() - 1
    shift = 15 - bit_depth - log2
    if shift > 0:
        r = (d.astype(np.int64) + (1 << (shift - 1))) >> shift
    else:
        r = d.astype(np.int64) << -shift
    return np.clip(r, -32768, 32767).astype(np.int32)


def transform_add(pred: np.ndarray, res: np.ndarray, bit_depth: int) -> np.ndarray:
    return np.clip(pred.astype(np.int64) + res, 0, (1 << bit_depth) - 1
                   ).astype(pred.dtype)


# ---------------------------------------------------------------------------
# Chroma QP mapping (8.6.1, Table 8-10)
# ---------------------------------------------------------------------------

_QPC_TAB = np.array([29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37],
                    np.int32)


def chroma_qp(qp_y: int, offset: int, chroma_format_idc: int,
              qp_bd_offset: int = 0) -> int:
    qpi = np.clip(qp_y + offset, -qp_bd_offset, 57)
    if chroma_format_idc == 1:
        if qpi < 30:
            qpc = qpi
        elif qpi > 43:
            qpc = qpi - 6
        else:
            qpc = int(_QPC_TAB[qpi - 30])
    else:
        qpc = min(qpi, 51)
    return int(qpc) + qp_bd_offset


# ---------------------------------------------------------------------------
# Intra prediction (8.4.4.2)
# ---------------------------------------------------------------------------

INTRA_PLANAR = 0
INTRA_DC = 1
INTRA_ANGULAR_HOR = 10
INTRA_ANGULAR_VER = 26

INTRA_PRED_ANGLE = np.array([
    32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
    -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32,
], np.int32)  # index = mode - 2

INV_ANGLE = np.array([
    -4096, -1638, -910, -630, -482, -390, -315, -256, -315, -390, -482,
    -630, -910, -1638, -4096,
], np.int32)  # index = mode - 11 (modes 11..25, angle < 0)


def _filter_flag(mode: int, n: int, cidx: int, chroma444: bool,
                 strong_smoothing_disabled: bool) -> bool:
    if cidx != 0 and not chroma444:
        return False
    if mode == INTRA_DC or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thres = {8: 7, 16: 1, 32: 0}[n]
    return min_dist > thres


def prepare_intra_refs(left: np.ndarray, top: np.ndarray, corner: int,
                       avail_left: np.ndarray, avail_top: np.ndarray,
                       avail_corner: bool, n: int, bit_depth: int):
    """Reference sample substitution (8.4.4.2.2).

    left: p[-1][0..2n-1] (top to bottom), top: p[0..2n-1][-1],
    corner: p[-1][-1]; avail_* are boolean masks per sample.
    Returns (left, top, corner) after substitution."""
    left = left.astype(np.int32).copy()
    top = top.astype(np.int32).copy()
    corner = int(corner)
    n2 = 2 * n
    total_avail = int(avail_left.sum() + avail_top.sum() + int(avail_corner))
    if total_avail == 0:
        v = 1 << (bit_depth - 1)
        left[:] = v
        top[:] = v
        return left, top, v
    if total_avail == n2 * 2 + 1:
        return left, top, corner
    # scan order: left from bottom (y=2n-1) up to y=0, corner, top x=0..2n-1
    # first element: if unavailable, take first available in scan order
    vals = []
    avs = []
    for y in range(n2 - 1, -1, -1):
        vals.append(left[y]); avs.append(bool(avail_left[y]))
    vals.append(corner); avs.append(bool(avail_corner))
    for x in range(n2):
        vals.append(top[x]); avs.append(bool(avail_top[x]))
    if not avs[0]:
        # substitute with the next available in scan order
        for i in range(1, len(vals)):
            if avs[i]:
                vals[0] = vals[i]
                break
    for i in range(1, len(vals)):
        if not avs[i]:
            vals[i] = vals[i - 1]
    # unpack
    for y in range(n2):
        left[n2 - 1 - y] = vals[y]
    corner = vals[n2]
    for x in range(n2):
        top[x] = vals[n2 + 1 + x]
    return left, top, corner


def filter_intra_refs(left: np.ndarray, top: np.ndarray, corner: int,
                      n: int, bit_depth: int, strong_smoothing: bool):
    """Reference sample filtering (8.4.4.2.3). Returns filtered copies."""
    n2 = 2 * n
    if strong_smoothing and n == 32:
        bi_int = (abs(corner + int(top[n2 - 1]) - 2 * int(top[n - 1]))
                  < (1 << (bit_depth - 5)))
        bi_int &= (abs(corner + int(left[n2 - 1]) - 2 * int(left[n - 1]))
                   < (1 << (bit_depth - 5)))
        if bi_int:
            fl = left.copy()
            ft = top.copy()
            for y in range(n2 - 1):
                fl[y] = ((63 - (y + 1)) * corner + (y + 1) * int(left[63]) + 32) >> 6
            for x in range(n2 - 1):
                ft[x] = ((63 - (x + 1)) * corner + (x + 1) * int(top[63]) + 32) >> 6
            return fl, ft, corner
    fl = left.copy()
    ft = top.copy()
    fc = (int(left[0]) + 2 * corner + int(top[0]) + 2) >> 2
    fl[0] = (corner + 2 * int(left[0]) + int(left[1]) + 2) >> 2
    for y in range(1, n2 - 1):
        fl[y] = (int(left[y - 1]) + 2 * int(left[y]) + int(left[y + 1]) + 2) >> 2
    ft[0] = (corner + 2 * int(top[0]) + int(top[1]) + 2) >> 2
    for x in range(1, n2 - 1):
        ft[x] = (int(top[x - 1]) + 2 * int(top[x]) + int(top[x + 1]) + 2) >> 2
    return fl, ft, fc


def intra_predict(mode: int, left: np.ndarray, top: np.ndarray, corner: int,
                  n: int, cidx: int, bit_depth: int,
                  chroma444: bool = False,
                  strong_smoothing: bool = False,
                  smoothing_disabled: bool = False) -> np.ndarray:
    """Full intra prediction for one nxn block given substituted refs.

    left/top are length-2n (post substitution); returns pred[y][x]."""
    if (not smoothing_disabled) and _filter_flag(
            mode, n, cidx, chroma444, False):
        left, top, corner = filter_intra_refs(
            left, top, corner, n, bit_depth, strong_smoothing)
    left = left.astype(np.int32)
    top = top.astype(np.int32)
    pred = np.zeros((n, n), np.int32)
    maxv = (1 << bit_depth) - 1
    if mode == INTRA_PLANAR:
        x = np.arange(n)
        y = np.arange(n)
        X, Y = np.meshgrid(x, y)  # X[y][x]=x
        pred = ((n - 1 - X) * left[Y] + (X + 1) * int(top[n])
                + (n - 1 - Y) * top[X] + (Y + 1) * int(left[n]) + n
                ) >> (int(np.log2(n)) + 1)
    elif mode == INTRA_DC:
        dc = (int(top[:n].sum()) + int(left[:n].sum()) + n) >> (int(np.log2(n)) + 1)
        pred[:, :] = dc
        if cidx == 0 and n < 32:
            pred[0, 0] = (int(left[0]) + 2 * dc + int(top[0]) + 2) >> 2
            pred[0, 1:] = (top[1:n] + 3 * dc + 2) >> 2
            pred[1:, 0] = (left[1:n] + 3 * dc + 2) >> 2
    else:
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        if mode >= 18:
            # vertical family: main ref = top
            # +1 slack: when i_fact==0 the weighted-zero sample b is still
            # read one slot past the last reference sample
            ref = np.zeros(3 * n + 3, np.int32)  # index offset n+1 → ref[-(n+1)]
            off = n + 1  # ref array index of p[-1+0][-1] is off+0... we use
            # ref[off + x] = p[x-1][-1] for x = 0..2n (x=0 is corner)
            ref[off + 0] = corner
            ref[off + 1: off + 1 + 2 * n] = top[:2 * n]
            ref[off + 1 + 2 * n] = top[2 * n - 1]
            if angle < 0:
                lim = (n * angle) >> 5
                inv = int(INV_ANGLE[mode - 11])
                # 8.4.4.2.6: extension only when lim < -1 (else never read)
                if lim < -1:
                    for x in range(-1, lim - 1, -1):
                        idx = ((x * inv + 128) >> 8) - 1  # index into left
                        ref[off + x] = corner if idx < 0 else left[idx]
            for yy in range(n):
                i_idx = ((yy + 1) * angle) >> 5
                i_fact = ((yy + 1) * angle) & 31
                for xx in range(n):
                    a = ref[off + xx + i_idx + 1]
                    b = ref[off + xx + i_idx + 2]
                    pred[yy, xx] = ((32 - i_fact) * a + i_fact * b + 16) >> 5
            if mode == 26 and cidx == 0 and n < 32:
                for yy in range(n):
                    pred[yy, 0] = np.clip(
                        int(top[0]) + ((int(left[yy]) - corner) >> 1), 0, maxv)
        else:
            # horizontal family: main ref = left; swap roles
            ref = np.zeros(3 * n + 3, np.int32)
            off = n + 1
            ref[off + 0] = corner
            ref[off + 1: off + 1 + 2 * n] = left[:2 * n]
            ref[off + 1 + 2 * n] = left[2 * n - 1]
            if angle < 0:
                lim = (n * angle) >> 5
                inv = int(INV_ANGLE[mode - 11])
                if lim < -1:
                    for x in range(-1, lim - 1, -1):
                        idx = ((x * inv + 128) >> 8) - 1
                        ref[off + x] = corner if idx < 0 else top[idx]
            for xx in range(n):
                i_idx = ((xx + 1) * angle) >> 5
                i_fact = ((xx + 1) * angle) & 31
                for yy in range(n):
                    a = ref[off + yy + i_idx + 1]
                    b = ref[off + yy + i_idx + 2]
                    pred[yy, xx] = ((32 - i_fact) * a + i_fact * b + 16) >> 5
            if mode == 10 and cidx == 0 and n < 32:
                for xx in range(n):
                    pred[0, xx] = np.clip(
                        int(left[0]) + ((int(top[xx]) - corner) >> 1), 0, maxv)
    return pred.astype(np.int32)


# ---------------------------------------------------------------------------
# Scan orders (6.5.3)
# ---------------------------------------------------------------------------

def diag_scan(size: int) -> np.ndarray:
    """Up-right diagonal scan: returns [size*size, 2] (x, y) per scan pos."""
    out = []
    x = y = 0
    while len(out) < size * size:
        while y >= 0:
            if x < size and y < size:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return np.array(out, np.int32)


def horiz_scan(size: int) -> np.ndarray:
    out = [(x, y) for y in range(size) for x in range(size)]
    return np.array(out, np.int32)


def vert_scan(size: int) -> np.ndarray:
    out = [(x, y) for x in range(size) for y in range(size)]
    return np.array(out, np.int32)


_SCANS = {}


def scan_order(scan_idx: int, size: int) -> np.ndarray:
    """scan_idx: 0=diag, 1=horizontal, 2=vertical; size in samples."""
    key = (scan_idx, size)
    if key not in _SCANS:
        fn = (diag_scan, horiz_scan, vert_scan)[scan_idx]
        _SCANS[key] = fn(size)
    return _SCANS[key]
