"""Per-class residual pools (port of ``hevc_tpu/tpu/recon.py:_residuals``)
and the per-CTB SAO maps of a picture (``pack_sao_params``)."""
from __future__ import annotations

import numpy as np
import torch

from .transforms import residual_batch


def _wrap16(v):
    """int16 wraparound — the reference's coefficient buffers are int16."""
    return ((v + 32768) & 65535) - 32768


def residuals(levels, rmeta, bit_depth, scale_bank, tables):
    """Per-class residual batches with a zeros slot prepended.

    levels: per class int32 [Nc, s, s]; rmeta: per class int32 [Nc, >=5]
    = (qp, dst, ts, raw, mtx+1 [, rot, rdpcm, ccp_alpha, ccp_slot]);
    scale_bank: per class int32 [7, s, s] (0 = flat, 1..6 = matrix ids).
    The rext columns apply the 4x4-skip rotation, the RDPCM accumulate
    and the cross-component add, as in the JAX package."""
    pre = []
    for c, log2 in enumerate((2, 3, 4, 5)):
        m = rmeta[c]
        sm = scale_bank[c][m[:, 4].long()]
        r = residual_batch(levels[c], m[:, 0], m[:, 1] != 0, m[:, 2] != 0,
                           log2, bit_depth, tables, sm)
        r = torch.where((m[:, 3] != 0)[:, None, None], levels[c], r)
        if m.shape[1] > 5:
            rot = (m[:, 5] != 0)[:, None, None]
            r = torch.where(rot, r.flip((1, 2)), r)
            rd = m[:, 6][:, None, None]
            # cumsum promotes int32 to int64; the wrap brings it back
            h = _wrap16(torch.cumsum(r, dim=2)).to(torch.int32)
            v = _wrap16(torch.cumsum(r, dim=1)).to(torch.int32)
            r = torch.where(rd == 1, h, torch.where(rd == 2, v, r))
        pre.append(r)
    out = []
    for c in range(4):
        m = rmeta[c]
        r = pre[c]
        zero = torch.zeros((1,) + tuple(r.shape[1:]), dtype=r.dtype,
                           device=r.device)
        if m.shape[1] > 5:
            pool = torch.cat([zero, r])
            alpha = m[:, 7][:, None, None]
            add = (alpha * pool[m[:, 8].long()]) >> 3
            r = torch.where(alpha != 0, _wrap16(r + add), r)
        out.append(torch.cat([zero, r]))
    return tuple(out)


def pack_sao_params(pic):
    """Per-CTB SAO parameter maps of a picture, 3 planes each: (type,
    band_pos, offs4, eo_class), int32 [3, cty, ctx] (offs4 [3, cty, ctx,
    4]: the 4 signed offsets of the band (k = 0..3) or edge (categories
    1..4)).  A copy of ``hevc_tpu/tpu/recon.py:pack_sao_params`` at
    7a00da0, which lives in a module that imports JAX."""
    if getattr(pic, "sao_arrays", None) is not None:
        return pic.sao_arrays  # native stage A fills these directly
    sps = pic.sps
    cty, ctx = sps.ctb_h, sps.ctb_w
    sao_map = getattr(pic, "sao_map", None) or {}
    t = np.zeros((3, cty, ctx), np.int32)
    pos = np.zeros((3, cty, ctx), np.int32)
    offs = np.zeros((3, cty, ctx, 4), np.int32)
    ec = np.zeros((3, cty, ctx), np.int32)
    for (xc, yc), prm in sao_map.items():
        for p in range(3):
            ti = prm.type_idx[p]
            t[p, yc, xc] = ti
            if ti:
                offs[p, yc, xc] = prm.offsets[p]
                pos[p, yc, xc] = prm.band_position[p]
                ec[p, yc, xc] = prm.eo_class[p]
    return t, pos, offs, ec
