"""CGS colour-gamut scalability: 3D asymmetric LUT parse/write + the
frame-level colour-mapping operator (NumPy oracle).

SHVC colour-gamut scalability maps the decoded base-layer frame through
a trilinear-ish 3D LUT (per-octant 4-vertex affine model) before
inter-layer upsampling.  Capability parity with the reference:
  * LUT container + derived shifts  (reference: libavcodec/hevc_ps.h:
    777-804 TCom3DAsymLUT)
  * cm_octant recursion parse       (reference: hevc_ps.c:2717
    xParse3DAsymLUTOctant, :2791 xParse3DAsymLUT, :2701 ReadParam,
    :2678 GetCuboidVertexPredAll, :2692 setCuboidVertexResTree)
  * frame-level colour mapping      (reference: hevcdsp_template.c:4351
    FUNC(colorMapping))
  * driver position: BL frame -> colorMapping -> upsample at EL frame
    start                           (reference: hevcdec.c:3627-3629)

The LUT is stored as one int32 ndarray lut[YSize, CSize, CSize, 4, 3]
(vertex index 0..3, component 0=Y 1=U 2=V) — the array form of the
reference's SCuboid***.  The emitter mirrors the parser's recursion so
encoder-written streams reproduce byte-for-byte.

Frozen copy of ``hevc_tpu_torch/ops/cgs.py`` at ee5ffe9.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class CgsLut:
    """Parsed colour_mapping_table() + derived constants."""

    ref_layer_ids: List[int] = field(default_factory=lambda: [0])
    octant_depth: int = 0          # cm_octant_depth (2 bits)
    y_part_num_log2: int = 0       # cm_y_part_num_log2 (2 bits)
    in_bd_y: int = 8               # cm_input_luma_bit_depth
    in_bd_c: int = 8
    out_bd_y: int = 8              # cm_output_luma_bit_depth
    out_bd_c: int = 8
    res_quant_bit: int = 0         # cm_res_quant_bit (2 bits)
    flc_bits: int = 1              # cm_flc_bits (2 bits, +1)
    adapt_threshold_u_delta: int = 0
    adapt_threshold_v_delta: int = 0
    lut: Optional[np.ndarray] = None  # [YSize, C, C, 4, 3] int32

    # ---- derived (reference: hevc_ps.c:2829-2849) ----
    @property
    def y_size(self) -> int:
        return 1 << (self.octant_depth + self.y_part_num_log2)

    @property
    def c_size(self) -> int:
        return 1 << self.octant_depth

    @property
    def y_shift2idx(self) -> int:
        return self.in_bd_y - self.octant_depth - self.y_part_num_log2

    @property
    def c_shift2idx(self) -> int:
        return self.in_bd_c - self.octant_depth

    @property
    def mapping_shift(self) -> int:
        return 10 + self.in_bd_y - self.out_bd_y

    @property
    def mapping_offset(self) -> int:
        return 1 << (self.mapping_shift - 1)

    @property
    def adapt_threshold_u(self) -> int:
        return (1 << (self.in_bd_c - 1)) + self.adapt_threshold_u_delta

    @property
    def adapt_threshold_v(self) -> int:
        return (1 << (self.in_bd_c - 1)) + self.adapt_threshold_v_delta


def _vertex_pred(lut: np.ndarray, y: int, u: int, v: int,
                 vertex: int) -> np.ndarray:
    """Vertex predictor: previous y-slice's cuboid, or the identity
    pattern at y==0 (reference: hevc_ps.c:2678 GetCuboidVertexPredAll —
    pred.{Y,U,V} = 1024 iff vertex matches the component)."""
    if y == 0:
        pred = np.zeros(3, np.int32)
        if vertex < 3:
            pred[vertex] = 1024
        return pred
    return lut[y - 1, u, v, vertex].copy()


def _set_vertex(cgs: CgsLut, y: int, u: int, v: int, vertex: int,
                deltas: Tuple[int, int, int]) -> None:
    """setCuboidVertexResTree (reference: hevc_ps.c:2692)."""
    pred = _vertex_pred(cgs.lut, y, u, v, vertex)
    q = cgs.res_quant_bit
    cgs.lut[y, u, v, vertex] = pred + (np.asarray(deltas, np.int32) << q)


def _read_param(r, n_flc: int) -> int:
    """ReadParam: ue prefix + n_flc-bit suffix + sign (reference:
    hevc_ps.c:2701)."""
    prefix = r.ue()
    code = r.u(n_flc) if n_flc else 0
    sym = (prefix << n_flc) + code
    if sym:
        return -sym if r.flag() else sym
    return 0


def _write_param(w, val: int, n_flc: int) -> None:
    sym = abs(val)
    w.ue(sym >> n_flc)
    if n_flc:
        w.u(sym & ((1 << n_flc) - 1), n_flc)
    if sym:
        w.flag(1 if val < 0 else 0)


def _flc_bits(cgs: CgsLut) -> int:
    n = cgs.mapping_shift - cgs.res_quant_bit - cgs.flc_bits
    return max(n, 0)


def _octant(cgs: CgsLut, r, w, depth: int, y0: int, u0: int, v0: int,
            length: int, splits, deltas) -> None:
    """One recursion step shared by parser (r set) and emitter (w set) —
    reference: hevc_ps.c:2717 xParse3DAsymLUTOctant."""
    can_split = depth < cgs.octant_depth
    if r is not None:
        split = r.flag() if can_split else 0
    else:
        split = 1 if (can_split and (depth, y0, u0, v0) in splits) else 0
        if can_split:
            w.flag(split)
    ypn = 1 << cgs.y_part_num_log2
    if split:
        half = length >> 1
        for dl in range(2):
            for dm in range(2):
                for dn in range(2):
                    _octant(cgs, r, w, depth + 1,
                            y0 + dl * half * ypn, u0 + dm * half,
                            v0 + dn * half, half, splits, deltas)
        return
    n_flc = _flc_bits(cgs)
    shift = cgs.octant_depth - depth
    for part in range(ypn):
        for vertex in range(4):
            if r is not None:
                if r.flag():
                    d = (_read_param(r, n_flc), _read_param(r, n_flc),
                         _read_param(r, n_flc))
                else:
                    d = (0, 0, 0)
            else:
                d = deltas.get((y0 + (part << shift), u0, v0, vertex),
                               (0, 0, 0))
                if any(d):
                    w.flag(1)
                    for comp in range(3):
                        _write_param(w, d[comp], n_flc)
                else:
                    w.flag(0)
            _set_vertex(cgs, y0 + (part << shift), u0, v0, vertex, d)
            for m in range(1, 1 << shift):
                _set_vertex(cgs, y0 + (part << shift) + m, u0, v0,
                            vertex, (0, 0, 0))
    # replicate the leaf into its non-anchor (u, v) positions
    for du in range(length):
        for dv in range(length):
            if du or dv:
                for yy in range(length * ypn):
                    for vertex in range(4):
                        _set_vertex(cgs, y0 + yy, u0 + du, v0 + dv,
                                    vertex, (0, 0, 0))


def parse_cgs_lut(r) -> CgsLut:
    """colour_mapping_table() parse (reference: hevc_ps.c:2791
    xParse3DAsymLUT)."""
    cgs = CgsLut()
    n_ref = r.ue() + 1
    cgs.ref_layer_ids = [r.u(6) for _ in range(n_ref)]
    cgs.octant_depth = r.u(2)
    cgs.y_part_num_log2 = r.u(2)
    cgs.in_bd_y = r.ue() + 8
    cgs.in_bd_c = r.ue() + 8
    cgs.out_bd_y = r.ue() + 8
    cgs.out_bd_c = r.ue() + 8
    cgs.res_quant_bit = r.u(2)
    cgs.flc_bits = r.u(2) + 1
    if cgs.octant_depth == 1:
        cgs.adapt_threshold_u_delta = r.se()
        cgs.adapt_threshold_v_delta = r.se()
    cgs.lut = np.zeros((cgs.y_size, cgs.c_size, cgs.c_size, 4, 3),
                       np.int32)
    _octant(cgs, r, None, 0, 0, 0, 0, 1 << cgs.octant_depth, None, None)
    return cgs


def write_cgs_lut(w, cgs: CgsLut,
                  splits: Optional[set] = None,
                  deltas: Optional[Dict] = None) -> CgsLut:
    """Emit colour_mapping_table() bits; `deltas` maps
    (yIdx, uIdx, vIdx, vertex) -> (dY, dU, dV) residuals at leaf
    anchors, `splits` is a set of (depth, y0, u0, v0) octants to split.
    Rebuilds cgs.lut exactly as a decoder will parse it."""
    w.ue(len(cgs.ref_layer_ids) - 1)
    for lid in cgs.ref_layer_ids:
        w.u(lid, 6)
    w.u(cgs.octant_depth, 2)
    w.u(cgs.y_part_num_log2, 2)
    w.ue(cgs.in_bd_y - 8)
    w.ue(cgs.in_bd_c - 8)
    w.ue(cgs.out_bd_y - 8)
    w.ue(cgs.out_bd_c - 8)
    w.u(cgs.res_quant_bit, 2)
    w.u(cgs.flc_bits - 1, 2)
    if cgs.octant_depth == 1:
        w.se(cgs.adapt_threshold_u_delta)
        w.se(cgs.adapt_threshold_v_delta)
    cgs.lut = np.zeros((cgs.y_size, cgs.c_size, cgs.c_size, 4, 3),
                       np.int32)
    _octant(cgs, None, w, 0, 0, 0, 0, 1 << cgs.octant_depth,
            splits or set(), deltas or {})
    return cgs


# ---------------------------------------------------------------------------
# frame-level colour mapping (reference: hevcdsp_template.c:4351)
# ---------------------------------------------------------------------------

def _lut_gather(cgs: CgsLut, y_val, u_val, v_val, comp: int):
    """Per-pixel cuboid lookup -> 4 vertex coefficients of `comp`."""
    yi = y_val >> cgs.y_shift2idx
    if cgs.octant_depth == 1:
        ui = (u_val >= cgs.adapt_threshold_u).astype(np.int64)
        vi = (v_val >= cgs.adapt_threshold_v).astype(np.int64)
    else:
        ui = u_val >> cgs.c_shift2idx
        vi = v_val >> cgs.c_shift2idx
    cub = cgs.lut[yi, ui, vi]            # [..., 4, 3]
    return (cub[..., 0, comp], cub[..., 1, comp],
            cub[..., 2, comp], cub[..., 3, comp])


def _map_comp(cgs: CgsLut, comp, y_val, u_val, v_val):
    p0, p1, p2, p3 = _lut_gather(cgs, y_val, u_val, v_val, comp)
    return ((p0 * y_val + p1 * u_val + p2 * v_val
             + cgs.mapping_offset) >> cgs.mapping_shift) + p3


def color_map_frame(cgs: CgsLut, planes) -> list:
    """Frame-level colorMapping for 4:2:0 input (the reference's only
    CGS chroma format) — vectorized mirror of hevcdsp_template.c:4351,
    including its exact chroma interpolation filters and edge clamping.

    Bit-exactness note: intermediates wrap int16 before the final clip,
    matching the reference's map_color_block (hevcdsp_template.c:4511,
    int16_t val_dst[6]) — the variant its shipped ACTIVE_PU_UPSAMPLING=1
    configuration actually executes.  (The frame-level colorMapping
    :4351 declares val_dst uint16_t instead; the two only diverge on
    out-of-range mappings that wrap, which no conforming LUT produces.)
    Block-wise mapping with the reference's is_bound_* edge handling
    decomposes exactly into this whole-frame form."""
    y = planes[0].astype(np.int64)
    u = planes[1].astype(np.int64)
    v = planes[2].astype(np.int64)
    ch, cw = u.shape

    up = np.concatenate([u[:1], u[:-1]], 0)    # prev row (clamped)
    vp = np.concatenate([v[:1], v[:-1]], 0)
    un = np.concatenate([u[1:], u[-1:]], 0)    # next row (clamped)
    vn = np.concatenate([v[1:], v[-1:]], 0)
    ur = np.concatenate([u[:, 1:], u[:, -1:]], 1)   # knext (clamped)
    vr = np.concatenate([v[:, 1:], v[:, -1:]], 1)
    upr = np.concatenate([up[:, 1:], up[:, -1:]], 1)
    vpr = np.concatenate([vp[:, 1:], vp[:, -1:]], 1)
    unr = np.concatenate([un[:, 1:], un[:, -1:]], 1)
    vnr = np.concatenate([vn[:, 1:], vn[:, -1:]], 1)

    # luma chroma-interp per 2x2 quadrant (reference loop body)
    a_u = ur + u
    a_v = vr + v
    tmp = [
        ((up + 3 * u + 2) >> 2, (vp + 3 * v + 2) >> 2),          # (0,0)
        ((3 * a_u + up + upr + 4) >> 3,
         (3 * a_v + vp + vpr + 4) >> 3),                          # (0,1)
        ((un + 3 * u + 2) >> 2, (vn + 3 * v + 2) >> 2),          # (1,0)
        ((3 * a_u + un + unr + 4) >> 3,
         (3 * a_v + vn + vnr + 4) >> 3),                          # (1,1)
    ]
    def wrap16(x):
        return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)

    max_y = (1 << cgs.out_bd_y) - 1
    out_y = np.empty((ch * 2, cw * 2), np.int64)
    for quad, (tu, tv) in enumerate(tmp):
        yy, xx = quad >> 1, quad & 1
        val = y[yy::2, xx::2]
        mapped = _map_comp(cgs, 0, val, tu, tv)
        out_y[yy::2, xx::2] = np.clip(wrap16(mapped), 0, max_y)

    y_aver = (y[0::2, 0::2] + y[1::2, 0::2] + 1) >> 1
    max_c = (1 << cgs.out_bd_c) - 1
    mu = _map_comp(cgs, 1, y_aver, u, v)
    mv = _map_comp(cgs, 2, y_aver, u, v)
    out_u = np.clip(wrap16(mu), 0, max_c)
    out_v = np.clip(wrap16(mv), 0, max_c)
    dt = np.int32
    return [out_y.astype(dt), out_u.astype(dt), out_v.astype(dt)]
