"""Multi-slice / tile filter-boundary semantics: parameter maps + gates.

The reference carries per-CTB deblock parameters (s->deblock[ctb],
hevc_filter.c:539-549), gates boundary-strength computation on
slice/tile edges (hevc_filter.c:989-1060 bd_slice/bd_tiles with
lc->boundary_flags, hevcdec.c:2822-2840), skips whole CTBs whose slice
disables deblocking (deblock[ctb].disable), and restricts edge-SAO at
restricted borders via vert_edge/horiz_edge/diag_edge flags
(hevc_filter.c:264-330 sao_filter_CTB + hevcdsp_template.c:438
sao_edge_restore_1).  This module derives all of that as dense maps the
frame-level NumPy/JAX filter kernels consume:

  * beta4 / tc4: per-4x4 deblock offsets of the CTB containing the
    edge's q sample (spec 8.7.2.5: offsets come from the slice of q0);
  * BS gating masks zeroing edges across disallowed slice/tile
    boundaries and inside deblock-disabled slices;
  * per-CTB SAO edge-restriction flag bytes (bit k of SAO_* masks).

Frozen copy of ``hevc_tpu_torch/ops/boundaries.py`` at ee5ffe9.
"""
from __future__ import annotations

import numpy as np

# SAO edge-flag bits (per CTB)
SAO_VE0, SAO_VE1, SAO_HE0, SAO_HE1 = 1, 2, 4, 8
SAO_D0, SAO_D1, SAO_D2, SAO_D3 = 16, 32, 64, 128


def slice_param_arrays(slice_addr, params):
    """Per-CTB scalar arrays from per-slice params.

    slice_addr: int [cty, ctx] slice index per CTB; params: per-slice
    list of dicts with beta_offset, tc_offset, disable, sao, lf_across.
    Returns (beta_c, tc_c, disable_c, lfase_c) int32 [cty, ctx]."""
    n = int(slice_addr.max()) + 1
    beta = np.zeros(n, np.int32)
    tc = np.zeros(n, np.int32)
    dis = np.zeros(n, np.int32)
    lfa = np.ones(n, np.int32)
    for s in range(n):
        p = params[s] if s < len(params) else {}
        beta[s] = p.get("beta_offset", 0)
        tc[s] = p.get("tc_offset", 0)
        dis[s] = 1 if p.get("disable", False) else 0
        lfa[s] = 0 if not p.get("lf_across", True) else 1
    return (beta[slice_addr], tc[slice_addr], dis[slice_addr],
            lfa[slice_addr])


def upsample4(ctb_map, cs, h4, w4):
    """Per-CTB map -> per-4x4 map (q-sample lookup grid)."""
    r = cs // 4
    return np.repeat(np.repeat(ctb_map, r, axis=0), r, axis=1)[:h4, :w4]


def gate_bs(bs_v, bs_h, slice_addr, tile_id, lfase_c, disable_c,
            across_tiles, cs):
    """Zero boundary strengths across disallowed slice/tile edges and
    inside deblock-disabled slices (reference: hevc_filter.c:1002-1007 /
    :1043-1046 bd_slice/bd_tiles; deblock[ctb].disable skip).

    bs maps are per-4x4 (luma grid); edits copies, returns them."""
    h4, w4 = bs_v.shape
    r = cs // 4
    bs_v = bs_v.copy()
    bs_h = bs_h.copy()
    # CTB-left vertical edges: x4 multiple of r, x4 > 0
    for xc in range(1, (w4 + r - 1) // r):
        x4 = xc * r
        if x4 >= w4:
            break
        q = slice_addr[:, xc]
        p = slice_addr[:, xc - 1]
        qt = tile_id[:, xc]
        pt = tile_id[:, xc - 1]
        blocked = ((q != p) & (lfase_c[:, xc] == 0)) \
            | ((qt != pt) & (not across_tiles))
        rows = np.repeat(blocked, r)[:h4]
        bs_v[rows, x4] = 0
    for yc in range(1, (h4 + r - 1) // r):
        y4 = yc * r
        if y4 >= h4:
            break
        q = slice_addr[yc]
        p = slice_addr[yc - 1]
        qt = tile_id[yc]
        pt = tile_id[yc - 1]
        blocked = ((q != p) & (lfase_c[yc] == 0)) \
            | ((qt != pt) & (not across_tiles))
        cols = np.repeat(blocked, r)[:w4]
        bs_h[y4, cols] = 0
    # deblock-disabled slices: all edges whose q sample is in the CTB
    dis4 = upsample4(disable_c, cs, h4, w4)
    bs_v[dis4 == 1] = 0
    bs_h[dis4 == 1] = 0
    return bs_v, bs_h


def filter_frame_multislice(planes, qp_map, bs_v, bs_h, slice_addr,
                            tile_id, params, sao_map, cs, bit_depth,
                            chroma_format_idc, cb_qp_offset,
                            cr_qp_offset, across_tiles, tiles_enabled,
                            sub_w, sub_h, no_filter4=None):
    """Host (NumPy) in-loop filters with full multi-slice semantics:
    per-slice deblock offsets/disable, slice/tile boundary gating of
    BS, and restricted-border edge SAO.  Shared by the encoder's recon
    path and the decoder's inline/plan backends."""
    from .deblock import deblock_frame
    from .sao import apply_sao_frame
    beta_c, tc_c, dis_c, lfa_c = slice_param_arrays(slice_addr, params)
    h4, w4 = bs_v.shape
    if not (dis_c == 1).all():
        gv, gh = gate_bs(bs_v, bs_h, slice_addr, tile_id, lfa_c, dis_c,
                         across_tiles, cs)
        deblock_frame(planes, qp_map, gv, gh, no_filter4=no_filter4,
                      bit_depth=bit_depth,
                      beta_offset=upsample4(beta_c, cs, h4, w4),
                      tc_offset=upsample4(tc_c, cs, h4, w4),
                      chroma_format_idc=chroma_format_idc,
                      cb_qp_offset=cb_qp_offset,
                      cr_qp_offset=cr_qp_offset)
    if sao_map:
        flags = sao_edge_flag_map(slice_addr, tile_id, lfa_c,
                                  across_tiles, tiles_enabled)
        apply_sao_frame(planes, sao_map, cs, bit_depth, sub_w, sub_h,
                        no_filter4=no_filter4,
                        edge_flags=flags)


def sao_edge_flag_map(slice_addr, tile_id, lfase_c, across_tiles,
                      tiles_enabled):
    """Per-CTB uint8 of SAO_* restriction bits (reference:
    hevc_filter.c:295-326 vert_edge/horiz_edge/diag_edge)."""
    cty, ctx = slice_addr.shape
    no_tile = bool(tiles_enabled) and not across_tiles
    flags = np.zeros((cty, ctx), np.uint8)
    for yc in range(cty):
        for xc in range(ctx):
            lfase = bool(lfase_c[yc, xc])
            restore = no_tile or not lfase
            if not restore:
                continue
            f = 0

            def differs(dy, dx):
                yn, xn = yc + dy, xc + dx
                if not (0 <= yn < cty and 0 <= xn < ctx):
                    return False, False
                sd = (not lfase
                      and slice_addr[yn, xn] != slice_addr[yc, xc])
                td = no_tile and tile_id[yn, xn] != tile_id[yc, xc]
                return sd, td

            sl, tl = differs(0, -1)
            sr, tr = differs(0, 1)
            su, tu = differs(-1, 0)
            sb, tb = differs(1, 0)
            if sl or tl:
                f |= SAO_VE0
            if sr or tr:
                f |= SAO_VE1
            if su or tu:
                f |= SAO_HE0
            if sb or tb:
                f |= SAO_HE1
            # diagonals combine the corner slice check with the two
            # adjacent tile-edge flags (reference :313-325)
            sul, _ = differs(-1, -1)
            sur, _ = differs(-1, 1)
            slr, _ = differs(1, 1)
            sll, _ = differs(1, -1)
            if xc > 0 and yc > 0 and (sul or tl or tu):
                f |= SAO_D0
            if yc > 0 and xc < ctx - 1 and (sur or tr or tu):
                f |= SAO_D1
            if yc < cty - 1 and xc < ctx - 1 and (slr or tr or tb):
                f |= SAO_D2
            if yc < cty - 1 and xc > 0 and (sll or tl or tb):
                f |= SAO_D3
            flags[yc, xc] = f
    return flags
