"""SHVC inter-layer upsampling — bit-exact NumPy reference.

Capability parity with the reference's upsample_base_layer_frame /
upsample_filter_block_{luma,cr}_{h,v} kernel family (reference:
libavcodec/hevcdsp_template.c:3582-4070, filter taps hevcdsp.c:101-145,
scale/phase setup hevcdec.c:545-567).  Semantics re-derived from H.265
Annex H (SHM) resampling:

  scale  = ((BL << 16) + (EL >> 1)) / EL          (1/65536 units)
  add    = ((phase * scale + 8) >> 4) - (1 << 11)
  refPos16 = ((x * scale - add) >> 12)            (1/16-pel position)
  phase = refPos16 & 15, refPos = refPos16 >> 4

Separable 8-tap (luma) / 4-tap (chroma) filtering over 16 phases:
horizontal pass into a 16-bit buffer (>> (bl_bd - 8)), vertical pass
with (+ (1 << (19 - el_bd))) >> (20 - el_bd) and clipping.  Handles x2,
x1.5 and arbitrary ratios with the same code path.

Copied from ``hevc_tpu/ops/upsample.py`` at e99b487.
"""
from __future__ import annotations

import numpy as np

UP_FILTER_LUMA = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0]], np.int32)

UP_FILTER_CHROMA = np.array([
    [0, 64, 0, 0],
    [-2, 62, 4, 0],
    [-2, 58, 10, -2],
    [-4, 56, 14, -2],
    [-4, 54, 16, -2],
    [-6, 52, 20, -2],
    [-6, 46, 28, -4],
    [-4, 42, 30, -4],
    [-4, 36, 36, -4],
    [-4, 30, 42, -4],
    [-4, 28, 46, -6],
    [-2, 20, 52, -6],
    [-2, 16, 54, -4],
    [-2, 14, 56, -4],
    [-2, 10, 58, -2],
    [0, 4, 62, -2]], np.int32)


def scale_factor(bl: int, el: int) -> int:
    return ((bl << 16) + (el >> 1)) // el


def phase_add(phase: int, scale: int) -> int:
    return ((phase * scale + 8) >> 4) - (1 << 11)


def _positions(n_el: int, scale: int, add: int):
    """(refPos, phase) per output coordinate."""
    x = np.arange(n_el)
    ref16 = (x * scale - add) >> 12
    return (ref16 >> 4).astype(np.int64), (ref16 & 15).astype(np.int64)


def _resample_plane(src: np.ndarray, el_h: int, el_w: int, taps: np.ndarray,
                    scale_x: int, add_x: int, scale_y: int, add_y: int,
                    bl_bd: int, el_bd: int) -> np.ndarray:
    """Separable resampling of one plane (source → el_h x el_w)."""
    ntaps = taps.shape[1]
    center = ntaps // 2 - 1  # tap index aligned with refPos
    bl_h, bl_w = src.shape
    shift_up = bl_bd - 8
    n_shift = 20 - el_bd
    # horizontal pass → int32 [bl_h, el_w]
    ref_x, ph_x = _positions(el_w, scale_x, add_x)
    tmp = np.zeros((bl_h, el_w), np.int64)
    for t in range(ntaps):
        cols = np.clip(ref_x + t - center, 0, bl_w - 1)
        tmp += taps[ph_x, t][None, :] * src[:, cols].astype(np.int64)
    tmp >>= shift_up
    # vertical pass → clipped output [el_h, el_w]
    ref_y, ph_y = _positions(el_h, scale_y, add_y)
    out = np.zeros((el_h, el_w), np.int64)
    for t in range(ntaps):
        rows = np.clip(ref_y + t - center, 0, bl_h - 1)
        out += taps[ph_y, t][:, None] * tmp[rows, :]
    out = (out + (1 << (n_shift - 1))) >> n_shift
    return np.clip(out, 0, (1 << el_bd) - 1).astype(np.int32)


def upsample_frame(bl_planes, el_w: int, el_h: int, *, sub_w=2, sub_h=2,
                   bl_bit_depth=8, el_bit_depth=8):
    """Upsample a [Y, Cb, Cr] base-layer picture to EL dimensions.

    Chroma uses the luma 1/65536 scale (identical ratio) with the SHVC
    vertical chroma phase for 4:2:0."""
    bl_h, bl_w = bl_planes[0].shape
    sx = scale_factor(bl_w, el_w)
    sy = scale_factor(bl_h, el_h)
    add_x = phase_add(0, sx)
    add_y = phase_add(0, sy)
    out = [_resample_plane(np.asarray(bl_planes[0], np.int32), el_h, el_w,
                           UP_FILTER_LUMA, sx, add_x, sy, add_y,
                           bl_bit_depth, el_bit_depth)]
    # chroma phases (reference: hevcdec.c:545)
    ph_v = (4 * el_h + (bl_h >> 1)) // bl_h - 4 if sub_h == 2 else 0
    add_xc = phase_add(0, sx)
    add_yc = phase_add(ph_v, sy)
    for c in (1, 2):
        out.append(_resample_plane(
            np.asarray(bl_planes[c], np.int32), el_h // sub_h,
            el_w // sub_w, UP_FILTER_CHROMA, sx, add_xc, sy, add_yc,
            bl_bit_depth, el_bit_depth))
    return out


def upscale_motion_field(bl_motion: dict, bl_w: int, bl_h: int,
                         el_w: int, el_h: int, el_poc: int,
                         irap: bool = False) -> dict:
    """Inter-layer motion-field mapping for TMVP from the IL ref
    (reference: hevc_filter.c:1985 ff_upscale_mv_block / hevc_refs.c
    scale_upsampled_mv_field; zeroed at EL IRAP per
    init_upsampled_mv_fields).

    bl_motion: a decoder dpb_motion dict (mv0/mv1 [h4,w4,2] int32,
    poc0/poc1 [h4,w4]).  Returns the same structure at EL dimensions,
    sampled per 16x16 EL block at the collocated BL 16x16 block and
    replicated, MVs rescaled by the SHVC mv_scale factors.  Every block at
    once in NumPy (a block whose collocated position falls outside the BL
    picture, or whose list has no reference, keeps the empty entry); the
    4x4 rows and columns past el_h >> 2 and el_w >> 2 stay empty."""
    h4e, w4e = -(-el_h // 4), -(-el_w // 4)
    NO_POC = -(1 << 30)
    out = {
        "mv0": np.zeros((h4e, w4e, 2), np.int32),
        "mv1": np.zeros((h4e, w4e, 2), np.int32),
        "poc0": np.full((h4e, w4e), NO_POC, np.int64),
        "poc1": np.full((h4e, w4e), NO_POC, np.int64),
        "poc": el_poc,
    }
    if irap:
        return out
    scale_x = ((bl_w << 16) + (el_w >> 1)) // el_w
    scale_y = ((bl_h << 16) + (el_h >> 1)) // el_h
    snr = scale_x == 65536 and scale_y == 65536
    mvsx = max(-4096, min(4095, ((el_w << 8) + (bl_w >> 1)) // bl_w))
    mvsy = max(-4096, min(4095, ((el_h << 8) + (bl_h >> 1)) // bl_h))

    def collocated(el, el_n, scale, bl_n, n4):
        """Each EL 16-block's collocated BL 4x4 index (clipped into the
        field) and whether the BL 16-block lies inside the picture."""
        bl = ((((np.minimum(el, el_n - 1) + 8) * scale + (1 << 15)) >> 16)
              + 4) & ~15
        return np.minimum(bl >> 2, n4 - 1), bl < bl_n

    h4b, w4b = np.shape(bl_motion["poc0"])
    yb4, oky = collocated(np.arange(0, el_h, 16, dtype=np.int64), el_h,
                          scale_y, bl_h, h4b)
    xb4, okx = collocated(np.arange(0, el_w, 16, dtype=np.int64), el_w,
                          scale_x, bl_w, w4b)
    at = np.ix_(yb4, xb4)
    ok = oky[:, None] & okx[None, :]

    def scale_mv(v, sc):
        p = np.int64(sc) * v
        return np.clip((p + 127 + (p < 0)) >> 8, -32768, 32767)

    def cells(blocks):
        """A 16-block array replicated over its 4x4 cells, cut to the
        first el_h >> 2 rows and el_w >> 2 columns of cells."""
        full = np.repeat(np.repeat(blocks, 4, axis=0), 4, axis=1)
        return full[:el_h >> 2, :el_w >> 2]

    for lst in ("0", "1"):
        poc = np.asarray(bl_motion["poc" + lst])[at].astype(np.int64)
        mv = np.asarray(bl_motion["mv" + lst])[at].astype(np.int64)
        if not snr:
            mv = np.stack([scale_mv(mv[..., 0], mvsx),
                           scale_mv(mv[..., 1], mvsy)], axis=-1)
        use = ok & (poc != NO_POC)
        written = np.s_[:el_h >> 2, :el_w >> 2]
        out["mv" + lst][written] = cells(np.where(use[..., None], mv, 0))
        out["poc" + lst][written] = cells(np.where(use, poc, NO_POC))
    return out


def upscale_mv_field(mv_bl: np.ndarray, bl_w: int, bl_h: int, el_w: int,
                     el_h: int) -> np.ndarray:
    """Inter-layer MV field upscale (reference: hevc_filter.c:1985
    ff_upscale_mv_block): mv_el = (mv_bl * mv_scale + 127 + sign) >> 8."""
    sx = max(-4096, min(4095, ((el_w << 8) + (bl_w >> 1)) // bl_w))
    sy = max(-4096, min(4095, ((el_h << 8) + (bl_h >> 1)) // bl_h))
    out = mv_bl.astype(np.int64).copy()
    for k, sc in ((0, sx), (1, sy)):
        v = out[..., k] * sc
        out[..., k] = np.clip((np.abs(v) + 127) >> 8, 0, 32767) \
            * np.sign(v)
    return np.clip(out, -32768, 32767).astype(np.int32)
