"""The least time the card could take for a stage's work, and the work.

A bound is the larger of two times: the bytes the function must move
(each input read once, each output written once) over the card's memory
rate, and its operations over the card's peak rate for their type.  The
rates are NVIDIA's data sheet for the H100 SXM at its full 700 W.

``mc_work`` / ``resid_work`` / ``intra_work`` / ``residual_work`` /
``loop_filter_work`` count the decoder kernels' work on one picture's
inputs (what ``chip_smoke.py`` holds each kernel's time against);
``stage_b_work`` counts every stage of
the frame program (``pipeline.frame_program``) from the inputs of one
call, the kernels' terms through those functions, so the kernels' bounds
and the stage-B bytes are one count.
"""
from __future__ import annotations

import numpy as np
import torch

from . import intra_cuda, mc_cuda
from .intra import chunk_counts
from .pack import PAD_REF
from .pipeline import host_views

# device memory, and int32 operations outside the tensor cores: an SM has
# 64 int32 lanes against 128 fp32 ones, so half the 67 TFLOP/s of fp32, a
# multiply-add counting 2
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 33.5e12


def bound_ms(n_bytes, n_ops, chain_ms=0.0):
    """(ms, "bytes", "operations" or "chain"): the least time of the card
    for the bytes at HBM_BYTES_S, the int32 operations at INT32_OPS_S and,
    for a kernel that is one dependent chain per unit of parallel work,
    that chain (``cabac.rows.chain_bound``)."""
    terms = {"bytes": n_bytes / HBM_BYTES_S * 1e3,
             "operations": n_ops / INT32_OPS_S * 1e3, "chain": chain_ms}
    by = max(terms, key=terms.get)
    return terms[by], by


def mc_work(refs_l, refs_c, table):
    """(bytes, int32 operations) the picture's MC needs: every reference
    pixel some prediction reads, once (a full-pel axis reads no filter
    margin), the int16 row table, and each predicted pixel written once; the
    separable filter's multiply-adds (2 operations each, none on a
    full-pel axis) and about 4 operations a pixel to round, weight and
    clip."""
    dev = refs_l.device
    seen = {False: torch.zeros(refs_l.shape, dtype=torch.bool, device=dev),
            True: torch.zeros(refs_c.shape, dtype=torch.bool, device=dev)}
    ops, px = 0, 0
    for is_ch, bi, _wp, w, h, start, n in table.groups:
        nt = 4 if is_ch else 8
        refs = refs_c if is_ch else refs_l
        nr, hp, wp = refs.shape
        rows = torch.from_numpy(table.rows[start:start + n]).to(dev).long()
        px += n * w * h
        for o in ((0, 5) if bi else (0,)):
            sel = rows[:, o].clamp(0, nr - 1)
            by = rows[:, o + 1].clamp(0, hp - (h + nt - 1))
            bx = rows[:, o + 2].clamp(0, wp - (w + nt - 1))
            fx, fy = rows[:, o + 3] != 0, rows[:, o + 4] != 0
            c = nt // 2 - 1          # the unit tap's column
            ys = torch.arange(h + nt - 1, device=dev)
            xs = torch.arange(w + nt - 1, device=dev)
            need_y = fy[:, None] | ((ys >= c) & (ys < c + h))[None]
            need_x = fx[:, None] | ((xs >= c) & (xs < c + w))[None]
            mask = need_y[:, :, None] & need_x[:, None, :]
            yy = (by[:, None, None] + ys[None, :, None]).expand_as(mask)
            xx = (bx[:, None, None] + xs[None, None, :]).expand_as(mask)
            ss = sel[:, None, None].expand_as(mask)
            seen[bool(is_ch)][ss[mask], yy[mask], xx[mask]] = True
            nfx, nfy = int(fx.sum()), int(fy.sum())
            ops += 2 * nt * w * (nfx * (h + nt - 1) + nfy * h)
        ops += 4 * n * w * h
    n_bytes = 4 * (int(seen[False].sum()) + int(seen[True].sum()) + px) \
        + table.rows.nbytes
    return n_bytes, ops


def resid_work(fields, pools):
    """(bytes, int32 operations) of the residual add: each TU's canvas
    tile read and written, each residual block it uses read once, the row
    tables; an add and a clip (3 operations) a pixel.  Only the pools'
    shapes are read."""
    n_bytes, ops = 0, 0
    for c, f in enumerate(fields):
        s = 4 << c
        n = int(f.shape[0])
        slots = f[:, 2].clamp(0, pools[c].shape[0] - 1).unique().numel() \
            if n else 0
        n_bytes += 8 * n * s * s + 4 * slots * s * s + 12 * n
        ops += 3 * n * s * s
    return n_bytes, ops


def intra_work(scal_host, counts, resids):
    """(bytes, live chunks) of the intra wavefront on one picture's records.

    scal_host: per class the host copy of the records [n_chunks, B, 8];
    counts: ``intra.chunk_counts`` of them; resids: the four residual pools
    (only their shapes are read).  Bytes: per live record of n x n (cy >=
    0) its record (8 int32) and availability row (128 bytes), its 4n + 1
    neighbours read and its block written (int32); each residual block the
    live records use read once (the slot clamped into the pool, as the
    kernel clamps it).  The live chunks are those holding a record: the
    kernel's launches, one dependent step each."""
    n_bytes = 0
    for c, s in enumerate(scal_host):
        n = 4 << c
        s = np.asarray(s)
        if not s.size:
            continue
        rec = s[s[:, :, 0] >= 0]
        slots = np.unique(np.clip(rec[:, 3], 0, resids[c].shape[0] - 1))
        n_bytes += rec.shape[0] * (8 * 4 + 128 + 4 * (4 * n + 1)
                                   + 4 * n * n) + 4 * n * n * slots.size
    return n_bytes, intra_cuda.live_chunks(counts)


def residual_work(rmeta):
    """(bytes, int32 operations) of the residual stage (``resid_cuda``) on
    one picture: rmeta, per class the host's rows [N, 9] (padding rows
    included: the kernel computes them too).  Bytes: the int16 levels and
    the rows read, the int32 pools (a zero slot each) written; the scaling
    banks (7 matrices a class, 38 KB in all) are left out.  Operations: 4
    a coefficient to scale and clip it, and for a transformed TU (neither
    skipped nor bypassed) of n x n two passes of n multiply-adds (2
    operations each) and a rounding shift and a clip (2) a coefficient."""
    n_bytes, ops = 0, 0
    for c, m in enumerate(rmeta):
        s = 4 << c
        m = np.asarray(m)
        n = m.shape[0]
        tx = int(((m[:, 2] == 0) & (m[:, 3] == 0)).sum()) if n else 0
        n_bytes += 2 * n * s * s + 4 * m.size + 4 * (n + 1) * s * s
        ops += 4 * n * s * s + tx * s * s * 2 * (2 * s + 2)
    return n_bytes, ops


def loop_filter_work(shapes, h4, w4, ctb_h, ctb_w, do_deblock=True,
                     do_sao=True, per_slice=False, nf=False):
    """{pass: bytes} of the loop filter kernels (``filters_cuda``) on one
    picture: ``deblock_v``, ``deblock_h`` and ``sao``, 0 for a pass that is
    off.  Each pass reads the int32 planes of ``shapes`` (luma first) once
    and the maps it needs, as int32: deblocking the per-4x4 QP map and its
    boundary strengths, the beta and tc offset maps where the filter
    parameters are per slice (else four offsets) and the nf map where
    there is one; SAO seven parameters a CTB a plane, the per-CTB edge
    flags where per slice, and the nf map.  SAO writes its planes whole; a
    deblocking pass writes only the samples an edge of the 8-sample grid
    can change (3 on either side in luma, 6 of every 8; 1 in chroma, 2 of
    8), counted as samples, not as the sectors that hold them."""
    frame32 = sum(4 * h * w for h, w in shapes)
    (hl, wl), chroma = shapes[0], shapes[1:]
    db_write = 3 * hl * wl + sum(h * w for h, w in chroma)
    map4 = 4 * h4 * w4
    ctbs = ctb_h * ctb_w
    nf_b = map4 if nf else 0
    deblock = (frame32 + db_write + 2 * map4
               + (2 * map4 if per_slice else 16) + nf_b) if do_deblock else 0
    sao = (2 * frame32 + 4 * 7 * ctbs * len(shapes)
           + (4 * ctbs if per_slice else 0) + nf_b) if do_sao else 0
    return {"deblock_v": deblock, "deblock_h": deblock, "sao": sao}


def stage_b_work(args):
    """{stage: (bytes, int32 operations)} of one call of
    ``pipeline.frame_program(*args)``: what each stage must move on the
    card, each input read once and each output written once, int32 planes
    and pools as the frame program keeps them; operations are counted for
    the two inter kernels only (``mc_work``, ``resid_work``):

    - ``upload``: the packed buffers and the MC row table, written once;
      a level pool shipped as (idx, val) pairs (spec ``coo``) counts its
      6 bytes a pair and the scatter's write of the dense int16 pool;
    - ``residuals``: ``residual_work``: the int16 levels and their rows
      read, the int32 pools (a zero slot each) written;
    - ``mc``, ``resid_add``: ``mc_work`` and ``resid_work``;
    - ``intra``: ``intra_work``'s bytes;
    - ``deblock``, ``sao``: ``loop_filter_work``'s two deblocking passes
      and its SAO pass;
    - ``output``: the planes read once, the fused output and the
      PAD_REF-padded references of the device DPB written once."""
    (meta, meta16, meta8, avail_u8, _levels16, _bank, canvas0, refs_y,
     refs_cb, refs_cr, spec, _device) = args
    S = dict(spec)
    scal, rmeta, fields, groups = host_views(np.asarray(meta, np.int32),
                                             meta16, S)
    canvas_shape = tuple(canvas0 if isinstance(canvas0, tuple)
                         else np.shape(canvas0))
    table = mc_cuda.mc_table(groups, canvas_shape)
    coo_n, total = S["coo"]
    levels_b = 2 * total          # the dense int16 pool
    work = {"upload": (int(np.asarray(meta).nbytes
                           + np.asarray(meta8).nbytes
                           + np.asarray(avail_u8).nbytes
                           + (6 * coo_n + levels_b if coo_n else levels_b)
                           + table.rows.nbytes), 0)}
    sizes = [4 << c for c in range(4)]
    work["residuals"] = residual_work(rmeta)
    if S["n_refs"]:
        refs_l = torch.stack(list(refs_y))
        refs_c = refs_l if S["mono"] else torch.stack(list(refs_cb)
                                                      + list(refs_cr))
        work["mc"] = mc_work(refs_l, refs_c, table)
    else:
        work["mc"] = (0, 0)
    pools = [torch.empty((S["nlv"][c] + 1, s, s), dtype=torch.int32,
                         device="meta") for c, s in enumerate(sizes)]
    work["resid_add"] = resid_work([torch.from_numpy(f) for f in fields],
                                   pools)
    work["intra"] = (intra_work(scal, chunk_counts(scal), pools)[0], 0)
    regions = S["regions"][:1] if S["mono"] else S["regions"]
    frame32 = sum(4 * h * w for _oy, _ox, h, w in regions)
    lf = loop_filter_work([(h, w) for _oy, _ox, h, w in regions], S["h4"],
                          S["w4"], S["ctb_h"], S["ctb_w"], S["do_deblock"],
                          S["do_sao"], S["per_slice"], S["nf"])
    work["deblock"] = (lf["deblock_v"] + lf["deblock_h"], 0)
    work["sao"] = (lf["sao"], 0)
    out_b = 1 if S["bd"] <= 8 else 2
    work["output"] = (frame32 + sum(
        h * w * out_b + 4 * (h + 2 * PAD_REF) * (w + 2 * PAD_REF)
        for _oy, _ox, h, w in regions), 0)
    return work


# the stages of ``stage_b_work``, which add up to a frame program's bytes
STAGE_B_TERMS = ("upload", "residuals", "mc", "resid_add", "intra",
                 "deblock", "sao", "output")
