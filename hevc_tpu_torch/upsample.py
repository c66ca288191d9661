"""SHVC inter-layer reference on a torch device: upsampling and CGS colour
mapping, bit-exact.

Port of ``hevc_tpu/tpu/upsample.py`` (``resample_plane_jax``,
``upsample_frame_jax``, ``color_map_frame_jax``).  The reference computes
both in XLA, not in Pallas, so they are plain torch on int32 tensors
here: each separable pass is one gather of source columns (rows) and one
multiply-add per tap, with the tap of every output coordinate read from
the 16-phase tables of ``ops/upsample.py``.  The position and phase
vectors are built once per geometry and device; the CGS LUT is uploaded
once per parsed PPS and kept on its ``CgsLut``.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from .ops import upsample as U

I32 = torch.int32


def resample_plane(src, ref_x, ph_x, ref_y, ph_y, el_h, el_w, bl_bd, el_bd,
                   chroma=False):
    """One plane, source int32 [bl_h, bl_w] -> int32 [el_h, el_w].

    ref_x/ph_x, ref_y/ph_y: the integer source position and the 1/16
    phase of every output column and row (``ops.upsample._positions``), as
    tensors on the source's device."""
    dev = src.device
    taps = _taps(chroma, str(dev))
    ntaps = taps.shape[1]
    center = ntaps // 2 - 1
    bl_h, bl_w = src.shape
    shift_up = bl_bd - 8
    n_shift = 20 - el_bd
    src = src.to(I32)
    tx = taps[ph_x]                                  # [el_w, ntaps]
    tmp = torch.zeros((bl_h, el_w), dtype=I32, device=dev)
    for t in range(ntaps):
        cols = (ref_x + (t - center)).clamp(0, bl_w - 1)
        tmp += tx[:, t][None, :] * src.index_select(1, cols)
    if shift_up:
        tmp >>= shift_up
    ty = taps[ph_y]                                  # [el_h, ntaps]
    out = torch.zeros((el_h, el_w), dtype=I32, device=dev)
    for t in range(ntaps):
        rows = (ref_y + (t - center)).clamp(0, bl_h - 1)
        out += ty[:, t][:, None] * tmp.index_select(0, rows)
    out = (out + (1 << (n_shift - 1))) >> n_shift
    return out.clamp_(0, (1 << el_bd) - 1)


@lru_cache(maxsize=None)
def _taps(chroma, device_str):
    return torch.from_numpy(U.UP_FILTER_CHROMA if chroma
                            else U.UP_FILTER_LUMA).to(device_str)


@lru_cache(maxsize=64)
def _positions(bl_h, bl_w, el_h, el_w, sub_w, sub_h, device_str):
    """((ref_x, ph_x, ref_y, ph_y) of luma, the same of chroma) on the
    device, for one (BL size, EL size, subsampling); the chroma vertical
    phase follows from the sizes (reference: hevcdec.c:545)."""
    sx = U.scale_factor(bl_w, el_w)
    sy = U.scale_factor(bl_h, el_h)
    ph_v = (4 * el_h + (bl_h >> 1)) // bl_h - 4 if sub_h == 2 else 0

    def dev(*vecs):
        return tuple(torch.from_numpy(v).to(device_str) for v in vecs)

    luma = dev(*U._positions(el_w, sx, U.phase_add(0, sx)),
               *U._positions(el_h, sy, U.phase_add(0, sy)))
    chroma = dev(*U._positions(el_w // sub_w, sx, U.phase_add(0, sx)),
                 *U._positions(el_h // sub_h, sy, U.phase_add(ph_v, sy)))
    return luma, chroma


def upsample_frame(bl_planes, el_w, el_h, *, sub_w=2, sub_h=2,
                   bl_bit_depth=8, el_bit_depth=8):
    """A [Y, Cb, Cr] base-layer picture (tensors on one device) upsampled
    to the EL's size: the device mirror of ``ops.upsample.upsample_frame``.
    """
    bl_h, bl_w = bl_planes[0].shape
    luma, chroma = _positions(bl_h, bl_w, el_h, el_w, sub_w, sub_h,
                              str(bl_planes[0].device))
    out = [resample_plane(bl_planes[0], *luma, el_h, el_w, bl_bit_depth,
                          el_bit_depth)]
    for c in (1, 2):
        out.append(resample_plane(bl_planes[c], *chroma, el_h // sub_h,
                                  el_w // sub_w, bl_bit_depth, el_bit_depth,
                                  chroma=True))
    return out


# ---------------------------------------------------------------------------
# CGS colour mapping (device mirror of ops.cgs.color_map_frame)
# ---------------------------------------------------------------------------

def _lut_dev(cgs, device):
    """The LUT as int32 [Y*C*C, 4, 3] on ``device``, uploaded once per
    parsed PPS and cached on its CgsLut (per device)."""
    cache = cgs.__dict__.setdefault("_torch_lut", {})
    key = str(device)
    got = cache.get(key)
    if got is None:
        got = cache[key] = torch.from_numpy(
            cgs.lut.reshape(-1, 4, 3).astype("int32")).to(device)
    return got


def _shift_rows(x, d):
    """x moved by one row (d = +1: the row below, -1: the row above), the
    edge row repeated."""
    return torch.cat([x[1:], x[-1:]], 0) if d > 0 else \
        torch.cat([x[:1], x[:-1]], 0)


def _right(x):
    return torch.cat([x[:, 1:], x[:, -1:]], 1)


def color_map_frame(cgs, planes):
    """3D-LUT colour mapping of a 4:2:0 [Y, Cb, Cr] picture (tensors on
    one device; reference: hevcdsp_template.c:4511 map_color_block, as
    ``ops/cgs.py``).  Per pixel the cuboid's 12 vertex coefficients are one
    gather from the LUT."""
    y, u, v = (p.to(I32) for p in planes)
    lut = _lut_dev(cgs, y.device)
    csz = cgs.c_size

    def cub_index(y_val, u_val, v_val):
        yi = y_val >> cgs.y_shift2idx
        if cgs.octant_depth == 1:
            ui = (u_val >= cgs.adapt_threshold_u).to(I32)
            vi = (v_val >= cgs.adapt_threshold_v).to(I32)
        else:
            ui = u_val >> cgs.c_shift2idx
            vi = v_val >> cgs.c_shift2idx
        return (yi * csz + ui) * csz + vi

    def map_comp(comp, y_val, u_val, v_val):
        cub = cub_index(y_val, u_val, v_val)
        p = lut[:, :, comp].index_select(0, cub.reshape(-1)) \
            .view(*cub.shape, 4)
        return ((p[..., 0] * y_val + p[..., 1] * u_val + p[..., 2] * v_val
                 + cgs.mapping_offset) >> cgs.mapping_shift) + p[..., 3]

    def wrap16(x):
        return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)

    up, vp = _shift_rows(u, -1), _shift_rows(v, -1)
    un, vn = _shift_rows(u, 1), _shift_rows(v, 1)
    a_u, a_v = _right(u) + u, _right(v) + v
    tmp = [
        ((up + 3 * u + 2) >> 2, (vp + 3 * v + 2) >> 2),
        ((3 * a_u + up + _right(up) + 4) >> 3,
         (3 * a_v + vp + _right(vp) + 4) >> 3),
        ((un + 3 * u + 2) >> 2, (vn + 3 * v + 2) >> 2),
        ((3 * a_u + un + _right(un) + 4) >> 3,
         (3 * a_v + vn + _right(vn) + 4) >> 3),
    ]
    max_y = (1 << cgs.out_bd_y) - 1
    ch, cw = u.shape
    # the quadrants interleaved in the order (0,0), (0,1), (1,0), (1,1)
    out_y = torch.empty((ch * 2, cw * 2), dtype=I32, device=y.device)
    for quad, (tu, tv) in enumerate(tmp):
        yy, xx = quad >> 1, quad & 1
        out_y[yy::2, xx::2] = wrap16(map_comp(0, y[yy::2, xx::2], tu, tv)) \
            .clamp_(0, max_y)
    y_aver = (y[0::2, 0::2] + y[1::2, 0::2] + 1) >> 1
    max_c = (1 << cgs.out_bd_c) - 1
    out_u = wrap16(map_comp(1, y_aver, u, v)).clamp_(0, max_c)
    out_v = wrap16(map_comp(2, y_aver, u, v)).clamp_(0, max_c)
    return [out_y, out_u, out_v]
