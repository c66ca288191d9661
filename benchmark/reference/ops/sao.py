"""Sample-adaptive offset — bit-exact NumPy reference (H.265 8.7.3).

Capability parity with the reference's sao_filter_CTB / sao_band_filter /
sao_edge_filter (reference: libavcodec/hevc_filter.c:264,
hevcdsp_template.c:310-496), re-derived from the specification.

SAO reads the deblocked picture and writes the output picture; all CTBs
read original (pre-SAO) neighbour samples, so frame-level application
with an input snapshot is exact.

Frozen copy of ``hevc_tpu_torch/ops/sao.py`` at ee5ffe9.
"""
from __future__ import annotations

import numpy as np

SAO_OFF = 0
SAO_BAND = 1
SAO_EDGE = 2

# hPos/vPos per eo_class (8.7.3): neighbour offsets (a, b)
_EO_NEIGHBOURS = {
    0: ((0, -1), (0, 1)),      # horizontal
    1: ((-1, 0), (1, 0)),      # vertical
    2: ((-1, -1), (1, 1)),     # 135 degrees
    3: ((1, -1), (-1, 1)),     # 45 degrees
}


def sao_band(block: np.ndarray, position: int, offsets, bit_depth: int):
    """Band offset over one region.  offsets: 4 signed values."""
    shift = bit_depth - 5
    band = block >> shift
    out = block.astype(np.int32).copy()
    for k in range(4):
        b = (position + k) & 31
        out[band == b] += int(offsets[k])
    return np.clip(out, 0, (1 << bit_depth) - 1)


def sao_edge(plane_in: np.ndarray, x0: int, y0: int, w: int, h: int,
             eo_class: int, offsets, bit_depth: int) -> np.ndarray:
    """Edge offset for region [y0:y0+h, x0:x0+w] of plane_in.

    offsets: 4 signed values for edge categories 1..4.  Samples whose
    neighbour falls outside the picture are left unmodified."""
    ph, pw = plane_in.shape
    (ay, ax), (by, bx) = _EO_NEIGHBOURS[eo_class]
    ys, xs = np.mgrid[y0:y0 + h, x0:x0 + w]
    na_y, na_x = ys + ay, xs + ax
    nb_y, nb_x = ys + by, xs + bx
    valid = ((na_y >= 0) & (na_y < ph) & (na_x >= 0) & (na_x < pw)
             & (nb_y >= 0) & (nb_y < ph) & (nb_x >= 0) & (nb_x < pw))
    cur = plane_in[y0:y0 + h, x0:x0 + w].astype(np.int32)
    a = plane_in[np.clip(na_y, 0, ph - 1), np.clip(na_x, 0, pw - 1)
                 ].astype(np.int32)
    b = plane_in[np.clip(nb_y, 0, ph - 1),
                 np.clip(nb_x, 0, pw - 1)].astype(np.int32)
    idx = 2 + np.sign(cur - a) + np.sign(cur - b)
    # remap: raw {0,1,2} -> {1,2,0}
    cat = np.where(idx == 2, 0, np.where(idx < 2, idx + 1, idx))
    off_lut = np.array([0, offsets[0], offsets[1], offsets[2], offsets[3]],
                       np.int32)
    out = np.clip(cur + off_lut[cat], 0, (1 << bit_depth) - 1)
    return np.where(valid, out, cur)


class SaoParams:
    """Per-CTB SAO parameters for the three components."""
    __slots__ = ("type_idx", "band_position", "offsets", "eo_class")

    def __init__(self):
        self.type_idx = [SAO_OFF, SAO_OFF, SAO_OFF]
        self.band_position = [0, 0, 0]
        self.offsets = [[0, 0, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0]]
        self.eo_class = [0, 0, 0]

    def copy(self):
        p = SaoParams()
        p.type_idx = list(self.type_idx)
        p.band_position = list(self.band_position)
        p.offsets = [list(o) for o in self.offsets]
        p.eo_class = list(self.eo_class)
        return p


def _edge_restrict_mask(bh, bw, flags, eo, at_l, at_t, at_r, at_b):
    """Pixels of one EDGE-SAO CTB left UNFILTERED due to restricted
    slice/tile borders (reference: hevcdsp_template.c:438
    sao_edge_restore_1 — full border rows/columns restored except the
    corner pixels whose diagonal class stays legal)."""
    from .boundaries import (SAO_D0, SAO_D1, SAO_D2, SAO_D3, SAO_HE0,
                             SAO_HE1, SAO_VE0, SAO_VE1)
    m = np.zeros((bh, bw), bool)
    s_ul = (not flags & SAO_D0) and eo == 2 and not at_l and not at_t
    s_ur = (not flags & SAO_D1) and eo == 3 and not at_t and not at_r
    s_lr = (not flags & SAO_D2) and eo == 2 and not at_r and not at_b
    s_ll = (not flags & SAO_D3) and eo == 3 and not at_l and not at_b
    if flags & SAO_VE0 and eo != 1:
        m[int(s_ul):bh - int(s_ll), 0] = True
    if flags & SAO_VE1 and eo != 1:
        m[int(s_ur):bh - int(s_lr), bw - 1] = True
    if flags & SAO_HE0 and eo != 0:
        m[0, int(s_ul):bw - int(s_ur)] = True
    if flags & SAO_HE1 and eo != 0:
        m[bh - 1, int(s_ll):bw - int(s_lr)] = True
    if flags & SAO_D0 and eo == 2:
        m[0, 0] = True
    if flags & SAO_D1 and eo == 3:
        m[0, bw - 1] = True
    if flags & SAO_D2 and eo == 2:
        m[bh - 1, bw - 1] = True
    if flags & SAO_D3 and eo == 3:
        m[bh - 1, 0] = True
    return m


def apply_sao_frame(planes, sao_map, ctb_size: int, bit_depth: int,
                    sub_w: int, sub_h: int, edge_flags=None,
                    no_filter4=None):
    """Apply SAO in place.  sao_map: dict (ctb_x, ctb_y) -> SaoParams
    (missing entries = off).  edge_flags: optional per-CTB uint8 map of
    boundaries.SAO_* bits restricting edge SAO at slice/tile edges.
    no_filter4: bool [h4, w4] — SAO never modifies samples of PCM CUs
    with pcm_loop_filter_disabled / transquant-bypass CUs (8.7.3)."""
    snap = [p.copy() for p in planes]
    nf = None
    if no_filter4 is not None and no_filter4.any():
        h0, w0 = planes[0].shape
        nf = np.repeat(np.repeat(no_filter4, 4, 0), 4, 1)[:h0, :w0]
    h, w = planes[0].shape
    cty = -(-h // ctb_size)
    ctx = -(-w // ctb_size)
    for (cx, cy), prm in sao_map.items():
        for c_idx in range(len(planes)):
            t = prm.type_idx[c_idx]
            if t == SAO_OFF:
                continue
            sw = sub_w if c_idx else 1
            sh_ = sub_h if c_idx else 1
            cs_x = ctb_size // sw
            cs_y = ctb_size // sh_
            x0, y0 = cx * cs_x, cy * cs_y
            ph, pw = planes[c_idx].shape
            bw = min(cs_x, pw - x0)
            bh = min(cs_y, ph - y0)
            if bw <= 0 or bh <= 0:
                continue
            if t == SAO_BAND:
                blk = snap[c_idx][y0:y0 + bh, x0:x0 + bw]
                out = sao_band(blk, prm.band_position[c_idx],
                               prm.offsets[c_idx], bit_depth)
            else:
                out = sao_edge(snap[c_idx], x0, y0, bw, bh,
                               prm.eo_class[c_idx], prm.offsets[c_idx],
                               bit_depth)
                fl = int(edge_flags[cy, cx]) if edge_flags is not None \
                    else 0
                if fl:
                    cur = snap[c_idx][y0:y0 + bh, x0:x0 + bw]
                    m = _edge_restrict_mask(
                        bh, bw, fl, prm.eo_class[c_idx],
                        cx == 0, cy == 0, cx == ctx - 1, cy == cty - 1)
                    out = np.where(m, cur, out)
            planes[c_idx][y0:y0 + bh, x0:x0 + bw] = \
                out.astype(planes[c_idx].dtype)

    if nf is not None:
        for c_idx, p in enumerate(planes):
            m = nf[::(sub_h if c_idx else 1), ::(sub_w if c_idx else 1)]
            m = m[:p.shape[0], :p.shape[1]]
            p[m] = snap[c_idx][m]
