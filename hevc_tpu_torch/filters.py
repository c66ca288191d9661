"""In-loop filters (deblocking 8.7.2, SAO 8.7.3), bit-exact.

Port of ``hevc_tpu/tpu/filters.py``: each deblocking pass is one batched
computation over the [segments, edges] grid of 8-sample windows (the
horizontal pass is the vertical pass on the transposed plane), and SAO is
per-pixel selects over per-CTB parameter maps upsampled to pixels.  Both
take the JAX version's per-slice maps (deblocking offsets per 4x4, SAO
slice/tile edge restrictions per CTB) and its PCM/TQB exemption masks.
Unlike it, chroma passes keep the row and column subsampling apart, so
4:2:2 filters (the JAX version raises there).
"""
from __future__ import annotations

import torch

from .tables import edge_pad


def _luma_filter_segments(win, beta, tc, maxv):
    """8.7.2.5.3 luma edge filter on win [..., 4, 8] (p3..q3 per line)."""
    p3, p2, p1, p0 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    q0, q1, q2, q3 = win[..., 4], win[..., 5], win[..., 6], win[..., 7]
    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    dpq0 = dp[..., 0] + dq[..., 0]
    dpq3 = dp[..., 3] + dq[..., 3]
    do_filter = (dpq0 + dpq3 < beta)[..., None]

    def strong_line(i, dpq):
        return ((2 * dpq < (beta >> 2))
                & ((p3[..., i] - p0[..., i]).abs()
                   + (q0[..., i] - q3[..., i]).abs() < (beta >> 3))
                & ((p0[..., i] - q0[..., i]).abs() < ((5 * tc + 1) >> 1)))

    strong = (strong_line(0, dpq0) & strong_line(3, dpq3))[..., None]
    t2 = (2 * tc)[..., None]

    def c3(v, x):
        return torch.minimum(torch.maximum(v, x - t2), x + t2)

    sp0 = c3((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = c3((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = c3((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = c3((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = c3((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = c3((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)
    # weak filter
    tcw = tc[..., None]
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wmask = delta.abs() < 10 * tcw
    delta = torch.minimum(torch.maximum(delta, -tcw), tcw)
    wp0 = (p0 + delta).clamp(0, maxv)
    wq0 = (q0 - delta).clamp(0, maxv)
    side_thr = (beta + (beta >> 1)) >> 3
    dep = (dp[..., 0] + dp[..., 3] < side_thr)[..., None]
    deq = (dq[..., 0] + dq[..., 3] < side_thr)[..., None]
    tc2 = tcw >> 1

    def clip2(v):
        return torch.minimum(torch.maximum(v, -tc2), tc2)

    wp1 = (p1 + clip2((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1)).clamp(0, maxv)
    wq1 = (q1 + clip2((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1)).clamp(0, maxv)

    def sel(s_, w_, orig, extra=True):
        return torch.where(do_filter, torch.where(
            strong, s_, torch.where(wmask & extra, w_, orig)), orig)

    out = win.clone()
    out[..., 1] = torch.where(do_filter & strong, sp2, p2)
    out[..., 2] = sel(sp1, wp1, p1, dep)
    out[..., 3] = sel(sp0, wp0, p0)
    out[..., 4] = sel(sq0, wq0, q0)
    out[..., 5] = sel(sq1, wq1, q1, deq)
    out[..., 6] = torch.where(do_filter & strong, sq2, q2)
    return out


def _chroma_filter_segments(win, tc, maxv):
    """8.7.2.5.5 chroma filter on win [..., L, 4] (p1 p0 q0 q1)."""
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    tcw = tc[..., None]
    delta = (((q0 - p0) << 2) + p1 - q1 + 4) >> 3
    delta = torch.minimum(torch.maximum(delta, -tcw), tcw)
    out = win.clone()
    out[..., 1] = (p0 + delta).clamp(0, maxv)
    out[..., 2] = (q0 - delta).clamp(0, maxv)
    return out


def _is_map(off):
    """A per-4x4 offset map, not a scalar offset."""
    return isinstance(off, torch.Tensor) and off.dim() == 2


def _at_edges(m, sub_c):
    """A per-4x4 map [rows, w4] sampled at the q position of each filtered
    edge (one every 8 plane samples, plane samples = sub_c luma)."""
    return m[:, 2 * sub_c::2 * sub_c]


def _luma_pass(y, qp4, bs4, beta_off, tc_off, bd, tables):
    """One directional luma pass over plane y (filters along axis 1).

    beta_off / tc_off: scalars, or per-4x4 [h4, w4] maps of the offsets of
    the slice holding each edge's q sample (multi-slice)."""
    h, w = y.shape
    n_e = (w - 4) // 8
    if n_e <= 0:
        return y
    s = h // 4
    win = y[:, 4:4 + 8 * n_e].reshape(s, 4, n_e, 8).permute(0, 2, 1, 3)
    bs = _at_edges(bs4, 1)[:, :n_e]
    qp = (qp4[:, 1::2][:, :n_e] + _at_edges(qp4, 1)[:, :n_e] + 1) >> 1
    if _is_map(beta_off):
        beta_off = _at_edges(beta_off, 1)[:, :n_e]
    if _is_map(tc_off):
        tc_off = _at_edges(tc_off, 1)[:, :n_e]
    beta = tables["beta"][(qp + beta_off).clamp(0, 51).long()] << (bd - 8)
    tc = tables["tc"][(qp + 2 * (bs - 1) + tc_off).clamp(0, 53).long()] \
        << (bd - 8)
    outw = _luma_filter_segments(win, beta, tc, (1 << bd) - 1)
    outw = torch.where((bs > 0)[..., None, None], outw, win)
    y = y.clone()
    y[:, 4:4 + 8 * n_e] = outw.permute(0, 2, 1, 3).reshape(h, 8 * n_e)
    return y


def _chroma_pass(c, qp4, bs4, tc_off, qp_off, bd, sub_r, sub_c, qpc_tab,
                 tables):
    """One directional chroma pass (edges every 8 chroma samples).

    sub_r / sub_c: the subsampling of the plane's rows and of the filtered
    axis (they differ in 4:2:2): chroma segment m reads the luma-grid maps
    at row m * sub_r, edge j at column 2 * sub_c * (j + 1).  qpc_tab: the
    4:2:0 chroma QP table, or None for Min(qPi, 51)."""
    ch, cw = c.shape
    n_e = (cw - 2) // 8
    if n_e <= 0:
        return c
    s = ch // 4
    cpad = torch.cat([c, torch.zeros((ch, 8), dtype=c.dtype,
                                     device=c.device)], 1)
    win = cpad[:, 6:6 + 8 * n_e].reshape(s, 4, n_e, 8).permute(0, 2, 1, 3)
    seg = win[..., :4]
    bs_r = bs4[::sub_r][:s]
    qp_r = qp4[::sub_r][:s]
    bs = _at_edges(bs_r, sub_c)[:, :n_e]
    qpi = ((qp_r[:, 2 * sub_c - 1::2 * sub_c][:, :n_e]
            + _at_edges(qp_r, sub_c)[:, :n_e] + 1) >> 1) + qp_off
    qpi = qpi.clamp(0, 57)
    qpc = qpi.clamp(max=51) if qpc_tab is None else qpc_tab[qpi.long()]
    if _is_map(tc_off):
        tc_off = _at_edges(tc_off[::sub_r][:s], sub_c)[:, :n_e]
    tc = tables["tc"][(qpc + 2 + tc_off).clamp(0, 53).long()] << (bd - 8)
    outs = _chroma_filter_segments(seg, tc, (1 << bd) - 1)
    outw = win.clone()
    outw[..., :4] = torch.where((bs == 2)[..., None, None], outs, seg)
    cpad[:, 6:6 + 8 * n_e] = outw.permute(0, 2, 1, 3).reshape(ch, 8 * n_e)
    return cpad[:, :cw]


def _t(m):
    """A per-4x4 offset map transposed for the horizontal pass (scalars
    pass through)."""
    return m.t() if _is_map(m) else m


def _keep(out, before, nf):
    """PCM / transquant-bypass samples keep their pre-deblock values."""
    return out if nf is None else torch.where(nf, before, out)


def deblock_luma(y, qp4, bs_v4, bs_h4, beta_off, tc_off, tables, bd=8,
                 nf=None):
    """Luma deblocking (also the whole of 4:0:0's): the vertical pass,
    then the horizontal pass on the transposed plane.  ``nf``: a bool
    pixel mask of samples deblocking never modifies (8.7.2 nDp/nDq = 0),
    restored after EACH pass, so the horizontal pass reads them as
    decoded."""
    y_in = y
    y = _keep(_luma_pass(y, qp4, bs_v4, beta_off, tc_off, bd, tables),
              y_in, nf)
    y = _luma_pass(y.t(), qp4.t(), bs_h4.t(), _t(beta_off), _t(tc_off),
                   bd, tables).t()
    return _keep(y, y_in, nf).contiguous()


def _deblock_chroma(c, qp4, bs_v4, bs_h4, tc_off, qp_off, bd, sub_w,
                    sub_h, qpc_tab, tables, nf):
    c_in = c
    c = _keep(_chroma_pass(c, qp4, bs_v4, tc_off, qp_off, bd, sub_h, sub_w,
                           qpc_tab, tables), c_in, nf)
    c = _chroma_pass(c.t(), qp4.t(), bs_h4.t(), _t(tc_off), qp_off, bd,
                     sub_w, sub_h, qpc_tab, tables).t()
    return _keep(c, c_in, nf).contiguous()


def deblock(y, cb, cr, qp4, bs_v4, bs_h4, beta_off, tc_off, cb_qp_off,
            cr_qp_off, tables, bd=8, sub_w=2, sub_h=2, nf_y=None,
            nf_c=None):
    """Full-frame deblocking (port of ``deblock_jax``): each plane's
    vertical pass, then its horizontal pass.

    beta_off / tc_off: int32 scalars or per-4x4 [h4, w4] maps; nf_y /
    nf_c: optional bool pixel masks of exempt samples.  The chroma QP
    mapping is Table 8-10 for 4:2:0 and Min(qPi, 51) otherwise (8.7.2.5.5,
    ChromaArrayType != 1)."""
    qpc_tab = tables["qpc"] if sub_w == sub_h == 2 else None
    y = deblock_luma(y, qp4, bs_v4, bs_h4, beta_off, tc_off, tables, bd,
                     nf_y)
    cb = _deblock_chroma(cb, qp4, bs_v4, bs_h4, tc_off, cb_qp_off, bd,
                         sub_w, sub_h, qpc_tab, tables, nf_c)
    cr = _deblock_chroma(cr, qp4, bs_v4, bs_h4, tc_off, cr_qp_off, bd,
                         sub_w, sub_h, qpc_tab, tables, nf_c)
    return y, cb, cr


_EO = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (1, -1, -1, 1))


def _upsample(m, lh, lw, h, w):
    """Per-CTB map [cty, ctx, ...] -> per-pixel [h, w, ...] (CTBs of
    2^lh x 2^lw samples)."""
    return m.repeat_interleave(1 << lh, 0).repeat_interleave(1 << lw, 1)[
        :h, :w]


def _restricted(k, fl, lh, lw, h, xx, w):
    """Edge-SAO samples of class k that stay unfiltered at restricted
    slice/tile borders (per-CTB ``boundaries.SAO_*`` bits ``fl``, already
    per pixel): whole border rows and columns, except the corners whose
    diagonal neighbour stays legal (reference: hevcdsp_template.c:438
    sao_edge_restore_1).  xx: the plane's columns in frame coordinates
    ([1, wb]), w the frame's width."""
    dev = fl.device
    yy = torch.arange(h, device=dev)[:, None]
    xm, ym = xx & ((1 << lw) - 1), yy & ((1 << lh) - 1)
    cond_l, cond_t = xm == 0, ym == 0
    cond_r = (xm == (1 << lw) - 1) | (xx == w - 1)
    cond_b = (ym == (1 << lh) - 1) | (yy == h - 1)
    at_l, at_t = xx < (1 << lw), yy < (1 << lh)
    at_r = (xx >> lw) == ((w - 1) >> lw)
    at_b = (yy >> lh) == ((h - 1) >> lh)
    ve0, ve1, he0, he1, d0, d1, d2, d3 = ((fl & (1 << i)) != 0
                                          for i in range(8))
    no = torch.zeros((), dtype=torch.bool, device=dev)
    s_ul = ~d0 & ~at_l & ~at_t if k == 2 else no
    s_ur = ~d1 & ~at_t & ~at_r if k == 3 else no
    s_lr = ~d2 & ~at_r & ~at_b if k == 2 else no
    s_ll = ~d3 & ~at_l & ~at_b if k == 3 else no
    restr = torch.zeros(fl.shape, dtype=torch.bool, device=dev)
    if k != 1:
        restr |= ve0 & cond_l & ~(cond_t & s_ul) & ~(cond_b & s_ll)
        restr |= ve1 & cond_r & ~(cond_t & s_ur) & ~(cond_b & s_lr)
    if k != 0:
        restr |= he0 & cond_t & ~(cond_l & s_ul) & ~(cond_r & s_ur)
        restr |= he1 & cond_b & ~(cond_l & s_ll) & ~(cond_r & s_lr)
    if k == 2:
        restr |= (d0 & cond_t & cond_l) | (d2 & cond_b & cond_r)
    if k == 3:
        restr |= (d1 & cond_t & cond_r) | (d3 & cond_b & cond_l)
    return restr


def sao_plane(plane, type_map, band_pos, offs4, eo_class, ctb_log2, bd,
              edge_flags=None, nf=None, halo=None, x0=0, w_frame=None):
    """SAO for one plane (port of ``sao_plane_jax``), or for one column
    band of it.

    plane: int32 [h, w]; type_map (0 off / 1 band / 2 edge), band_pos,
    eo_class: int32 [cty, ctx]; offs4: int32 [cty, ctx, 4]; ctb_log2: the
    CTB's log2 size in plane samples, or (log2 height, log2 width) where
    they differ (4:2:2 chroma).  edge_flags: optional int32 [cty, ctx] of
    ``ops.boundaries.SAO_*`` bits (restricted slice/tile borders); nf:
    optional bool pixel mask of samples SAO never modifies (8.7.3).  A
    column band (``sharded``) passes the neighbours' columns next to it,
    ``halo`` = (left, right), each [h, 1], its first column ``x0`` in the
    plane and the plane's width ``w_frame``: sample validity is in plane
    coordinates, the maps are the band's CTB columns."""
    lh, lw = (ctb_log2, ctb_log2) if isinstance(ctb_log2, int) \
        else ctb_log2
    h, w = plane.shape
    w_frame = w if w_frame is None else w_frame
    maxv = (1 << bd) - 1
    dev = plane.device
    t = _upsample(type_map, lh, lw, h, w)
    pos = _upsample(band_pos, lh, lw, h, w)
    offs = _upsample(offs4, lh, lw, h, w)
    cls = _upsample(eo_class, lh, lw, h, w)
    fl = None if edge_flags is None else _upsample(edge_flags, lh, lw, h, w)
    # ---- band: offset where band(v) matches pos+k ----
    band = plane >> (bd - 5)
    band_off = torch.zeros_like(plane)
    for k in range(4):
        band_off = band_off + torch.where(band == ((pos + k) & 31),
                                          offs[..., k], 0)
    band_out = (plane + band_off).clamp(0, maxv)
    # ---- edge: all 4 classes, select, category-masked offsets ----
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :] + x0
    pad = edge_pad(plane, 1, 1, 1, 1) if halo is None else edge_pad(
        torch.cat([halo[0], plane, halo[1]], 1), 1, 1, 0, 0)

    def shifted(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    edge_out = plane
    for k, (ay, ax, by, bx) in enumerate(_EO):
        idx = 2 + torch.sign(plane - shifted(ay, ax)) \
            + torch.sign(plane - shifted(by, bx))
        cat = torch.where(idx == 2, 0, torch.where(idx < 2, idx + 1, idx))
        off = torch.zeros_like(plane)
        for c in range(4):
            off = off + torch.where(cat == c + 1, offs[..., c], 0)
        valid = ((yy + ay >= 0) & (yy + ay < h) & (xx + ax >= 0)
                 & (xx + ax < w_frame) & (yy + by >= 0) & (yy + by < h)
                 & (xx + bx >= 0) & (xx + bx < w_frame))
        if fl is not None:
            valid = valid & ~_restricted(k, fl, lh, lw, h, xx, w_frame)
        res = torch.where(valid, (plane + off).clamp(0, maxv), plane)
        edge_out = torch.where(cls == k, res, edge_out)
    out = torch.where(t == 1, band_out,
                      torch.where(t == 2, edge_out, plane))
    return out if nf is None else torch.where(nf, plane, out)
