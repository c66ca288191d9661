"""Host-side frame packing for the port's frame program (NumPy + native).

Port of ``hevc_tpu/tpu/pipeline.py:pack_frame_pipeline`` and
``_saturate_mc_windows``, which live in a module that imports JAX.  The
buffers keep the JAX package's format — int32 ``meta``, int16 ``meta16``
MC rows, int8 ``meta8`` QP/BS maps, uint8 ``avail``, int16 ``levels16``
and the static ``spec`` tuple — so ``pipeline.frame_program`` takes what
either pack produces.  It always packs the unaligned layout (``pallas``
0), uploads the level pool dense, tags every MC row kind 3 and pads no
row counts: the card needs no static shapes.

The canvas layout (``region_offsets``, the ``PAD``/``TAIL`` margins, the
``DUMP`` sentinel, ``PAD_REF``) and ``PackedFrame``, the per-frame pack of
``native.pack_frame_native``, are those of ``hevc_tpu/tpu/pack.py`` at
e99b487.
"""
from __future__ import annotations

import ctypes as C
from dataclasses import dataclass

import numpy as np

from . import native as N
from . import trace
from .ops.boundaries import (gate_bs, sao_edge_flag_map, slice_param_arrays,
                             upsample4)

PAD = 8          # top/left margin of each region
TAIL = 72        # bottom/right slack so 2n-reads never leave the canvas
DUMP = -(1 << 20)  # scatter target for padding lanes (dropped as OOB)
PAD_REF = 64  # replication padding of reference planes (bounds the MVs
              # the packer accepts; generated streams stay well inside)
DUMP16 = 30000  # int16-safe out-of-canvas sentinel for padding MC rows


@dataclass
class PackedFrame:
    canvas: np.ndarray            # int32 [CH, CW]
    scal: tuple                   # per class: int32 [n_chunks, B, 8]
    avail: tuple                  # per class: bool [n_chunks, B, 128]
    levels: tuple                 # per class: int32 [Nc, s, s]
    rmeta: tuple                  # per class: int32 [Nc, 9] (qp, dst,
                                  # ts, raw, mtx+1, rot, rdpcm, ccp,
                                  # ccp_slot)
    n_chunks: int
    region: dict                  # plane -> (oy, ox, h, w)
    bit_depth: int
    # inter phases
    mc_groups: tuple = ()         # ((is_chroma, bi, w, h, wp, fields), ...)
                                  # fields int32 [N, 7|12 (+5 when wp)]:
                                  # pred cols, cy, cx[, w0, o0, w1, o1,
                                  # log2wd]
    resid_groups: tuple = ()      # per class int32 [N, 3] = (cy, cx, slot)
    refs_l: np.ndarray = None     # int32 [R, Hp, Wp] padded luma refs
    refs_c: np.ndarray = None     # int32 [2R, hp, wp] padded cb+cr refs
    scale_bank: tuple = ()        # per class: int32 [7, s, s] scaling
                                  # matrices (0 = flat, 1..6 = matrix id)


def region_offsets(sps):
    h, w = sps.height, sps.width
    if sps.chroma_format_idc == 0:
        # monochrome: no chroma records ever target the canvas — park
        # two dummy 8x8 regions in the top-left pad margin so the
        # 3-plane plumbing keeps its shape (4:0:0, 7.4.3.2)
        reg = {0: (PAD, PAD, h, w), 1: (0, 0, 8, 8), 2: (0, 8, 8, 8)}
        return reg, PAD + h + TAIL, PAD + w + TAIL + PAD
    h2, w2 = h // sps.sub_h, w // sps.sub_w
    reg = {0: (PAD, PAD, h, w),
           1: (PAD + h + PAD, PAD, h2, w2),
           2: (PAD + h + PAD, PAD + w2 + PAD, h2, w2)}
    ch = PAD + h + PAD + h2 + TAIL
    cw = max(PAD + w, PAD + w2 + PAD + w2) + TAIL + PAD
    return reg, ch, cw


def _pow2_at_least(x):
    return 1 << max(0, (x - 1).bit_length())


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _window_ok(mr, sps):
    """Per row: do the reference windows lie inside the padded planes?"""
    is_ch = mr[:, 0] == 1
    ext_h = mr[:, 3] + np.where(is_ch, 3, 7)
    ext_w = mr[:, 2] + np.where(is_ch, 3, 7)
    hp = np.where(is_ch, sps.height // sps.sub_h, sps.height) + 2 * PAD_REF
    wp = np.where(is_ch, sps.width // sps.sub_w, sps.width) + 2 * PAD_REF
    ok = (mr[:, 5] >= 0) & (mr[:, 6] >= 0) \
        & (mr[:, 5] + ext_h <= hp) & (mr[:, 6] + ext_w <= wp)
    ok &= np.where(mr[:, 1] == 1, (mr[:, 10] >= 0) & (mr[:, 11] >= 0)
                   & (mr[:, 10] + ext_h <= hp)
                   & (mr[:, 11] + ext_w <= wp), True)
    return ok


def saturate_mc_windows(mcrow, nm, sps):
    """Exact saturation of MC reference windows overhanging the PAD_REF
    replication band (port of ``pipeline._saturate_mc_windows``).

    A window lying entirely beyond the frame on an axis reads constant
    rows/columns, so its origin may be clamped into the pad; a window
    still out of bounds after that splits in half along the offending
    axis until its halves qualify.  Returns (mcrow, nm)."""
    mr = mcrow[:nm]
    ok = _window_ok(mr, sps)
    if ok.all():
        return mcrow, nm
    out = [r for r in mr[ok]]
    rows = list(mr[~ok])
    while rows:
        r = rows.pop()
        is_ch = r[0] == 1
        ntap = 3 if is_ch else 7
        hp = (sps.height // (sps.sub_h if is_ch else 1)) + 2 * PAD_REF
        wp = (sps.width // (sps.sub_w if is_ch else 1)) + 2 * PAD_REF
        wins = [(5, 6)] + ([(10, 11)] if r[1] == 1 else [])
        split_axis = None
        for cby, cbx in wins:
            for c, ext, lim, size_col in ((cby, r[3] + ntap, hp, 3),
                                          (cbx, r[2] + ntap, wp, 2)):
                v = r[c]
                if 0 <= v and v + ext <= lim:
                    continue
                if v + ext <= PAD_REF:           # fully before the frame
                    if ext <= PAD_REF:
                        r[c] = PAD_REF - ext
                        continue
                elif v >= lim - PAD_REF:         # fully after the frame
                    if ext <= PAD_REF:
                        r[c] = lim - PAD_REF
                        continue
                split_axis = size_col
                break
            if split_axis is not None:
                break
        if split_axis is not None and r[split_axis] > 4:
            half = int(r[split_axis]) // 2
            r2 = r.copy()
            r[split_axis] = half
            r2[split_axis] = half
            if split_axis == 3:   # vertical: by/by1/cy shift
                for c in (5, 10) if r[1] == 1 else (5,):
                    r2[c] += half
                r2[14] += half
            else:                 # horizontal: bx/bx1/cx shift
                for c in (6, 11) if r[1] == 1 else (6,):
                    r2[c] += half
                r2[15] += half
            rows.append(r)
            rows.append(r2)
            continue
        out.append(r)
    if len(out) == nm:
        mcrow[:nm] = np.asarray(out)
        return mcrow, nm
    arr = np.asarray(out, np.int32)
    return arr, arr.shape[0]


def pack_frame(pic):
    """Native records of one picture -> (meta, meta16, meta8, avail_u8,
    levels16, canvas0, spec).  ``canvas0`` is the canvas shape (the frame
    program starts from zeros), or an int16 host canvas holding the
    picture's PCM samples."""
    sps = pic.sps
    reg, chh, cww = region_offsets(sps)
    with trace.span("pack.concat"):
        rec, lvl = N._concat_chunks(pic.native_chunks)
    n_rec = rec.shape[0]
    refs0 = getattr(pic, "ref_list_l0", []) or []
    refs1 = getattr(pic, "ref_list_l1", []) or []
    n_refs = len(refs0) + len(refs1)

    P = N.PackParams()
    P.width, P.height = sps.width, sps.height
    P.sub_w, P.sub_h = sps.sub_w, sps.sub_h
    P.h4, P.w4 = pic.h4, pic.w4
    P.log2_ctb = sps.log2_ctb_size
    P.ctb_w, P.ctb_h = sps.ctb_w, sps.ctb_h
    P.chroma444 = int(sps.chroma_format_idc == 3)
    P.smoothing_disabled = int(sps.intra_smoothing_disabled)
    P.strong_smoothing = int(sps.strong_intra_smoothing)
    P.nrefs, P.r0 = n_refs, len(refs0)
    P.pad_ref = PAD_REF
    P.tile_mc = 0  # per-PU rows
    for p in range(3):
        for k in range(4):
            P.reg[p * 4 + k] = reg[p][k]

    cap = max(1, n_rec)
    imeta = np.empty((cap, 11), np.int32)
    iavail = np.zeros((cap, 128), np.uint8)
    lmeta = np.empty((cap, 11), np.int32)
    mcrow = np.empty((cap, 21), np.int32)
    residr = np.empty((cap, 4), np.int32)
    pcmrow = np.empty((cap, 6), np.int32)
    counts = np.zeros(8, np.int64)
    tabs = N._pps_tables(pic.pps)
    with trace.span("pack.native"):
        rc = N._pack_fn()(
            np.ascontiguousarray(rec).reshape(-1), n_rec, C.byref(P),
            pic.z_order.reshape(-1), pic.slice_idx.reshape(-1), tabs[3],
            imeta.reshape(-1), iavail.reshape(-1), lmeta.reshape(-1),
            mcrow.reshape(-1), residr.reshape(-1), pcmrow.reshape(-1),
            counts)
    if rc != 0:
        raise RuntimeError(f"native pipeline pack failed (rc={rc})")
    ni, nl, nm, nr, npcm, n_chunks_raw = (int(v) for v in counts[:6])
    canvas0 = (chh, cww)
    if npcm:
        # PCM samples pre-fill the canvas; nothing else writes there
        canvas0 = np.zeros(canvas0, np.int16)
        for _plane, cy, cx, w, h, off in pcmrow[:npcm].tolist():
            canvas0[cy:cy + h, cx:cx + w] = lvl[off:off + w * h].reshape(
                h, w)

    with trace.span("pack.guard"):
        if nm:
            mcrow, nm = saturate_mc_windows(mcrow, nm, sps)
            ok = _window_ok(mcrow[:nm], sps)
            if not ok.all():
                raise ValueError(
                    "MV exceeds PAD_REF after saturation: rows (is_ch, bi, "
                    f"w, h, sel, by, bx, ...): {mcrow[:nm][~ok][:3].tolist()}")

    n_chunks = _round_up(max(1, n_chunks_raw), 16)
    im, iv, lm = imeta[:ni], iavail[:ni], lmeta[:nl]
    cls_i = im[:, 0]
    parts = []        # int32 meta blocks, in frame_program order
    avail_parts = []
    B = []
    with trace.span("pack.intra"):
        for c in range(4):
            sel = np.nonzero(cls_i == c)[0]
            cnt = int(im[sel, 2].max()) + 1 if sel.size else 0
            Bc = _pow2_at_least(cnt) if cnt else 0
            B.append(Bc)
            a = np.zeros((n_chunks, Bc, 8), np.int32)
            a[:, :, 0] = DUMP
            a[:, :, 1] = DUMP
            a[:, :, 2] = 1
            v = np.zeros((n_chunks, Bc, 128), np.uint8)
            if sel.size:
                a[im[sel, 1], im[sel, 2]] = im[sel, 3:11]
                v[im[sel, 1], im[sel, 2]] = iv[sel]
            parts.append(a.reshape(-1))
            avail_parts.append(v.reshape(-1))

    lvl_parts = []
    with trace.span("pack.levels"):
        # per-class (rmeta, int16 levels); padding rows and the CCP zero
        # slot stay zeroed
        cls_counts = np.bincount(lm[:, 0], minlength=4) if nl else \
            np.zeros(4, np.int64)
        nlv = [_round_up(int(cls_counts[c]) + 1, 16) for c in range(4)]
        rms = [np.zeros((nlv[c], 9), np.int32) for c in range(4)]
        lv16s = [np.zeros((nlv[c], (4 << c) * (4 << c)), np.int16)
                 for c in range(4)]
        if nl:
            N._gather_levels_fn()(
                lvl, np.ascontiguousarray(lm).reshape(-1), nl,
                *(r.reshape(-1) for r in rms),
                *(v.reshape(-1) for v in lv16s))
        for c in range(4):
            parts.append(rms[c].reshape(-1))
            lvl_parts.append(lv16s[c].reshape(-1))

    # MC groups keyed (is_ch, bi, wp, 3, w, h): one kind, exact counts
    parts16 = []
    mc_groups = []
    with trace.span("pack.mc"):
        if nm:
            mcr = mcrow[:nm]
            wp_flag = (mcr[:, 20] >= 0).astype(np.int32)
            order = np.lexsort((mcr[:, 3], mcr[:, 2], wp_flag, mcr[:, 1],
                                mcr[:, 0]))
            srt = mcr[order]
            keys = np.column_stack([srt[:, :2], wp_flag[order],
                                    srt[:, 2:4]])
            bounds = [0] + (np.nonzero(np.any(np.diff(keys, axis=0) != 0,
                                              axis=1))[0] + 1).tolist() \
                + [nm]
            for a, b in zip(bounds[:-1], bounds[1:]):
                is_ch, bi, wp, w, h = (int(v) for v in keys[a])
                mc_groups.append((bool(is_ch), bool(bi), bool(wp), 3, w, h,
                                  b - a))
                parts16.append(srt[a:b, 4:21].astype(np.int16).reshape(-1))

    rr = residr[:nr]
    resid_rows = []
    for c in range(4):
        rows = rr[rr[:, 0] == c][:, 1:4]
        resid_rows.append(rows.shape[0])
        parts.append(rows.reshape(-1))

    # SAO maps + QP/BS + deblock offsets
    if getattr(pic, "sao_arrays", None) is not None:
        sao_t, sao_b, sao_o, sao_e = pic.sao_arrays
    else:
        ct = (3, sps.ctb_h, sps.ctb_w)
        sao_t = np.zeros(ct, np.int32)
        sao_b = np.zeros(ct, np.int32)
        sao_o = np.zeros(ct + (4,), np.int32)
        sao_e = np.zeros(ct, np.int32)
    parts += [sao_t.reshape(-1), sao_b.reshape(-1), sao_e.reshape(-1),
              sao_o.reshape(-1)]
    dbp = getattr(pic, "deblock_params", None)
    slice_params = getattr(pic, "slice_params", None) or []
    pps = pic.pps
    per_slice = len(slice_params) > 1 or (
        pps.tiles_enabled and not pps.loop_filter_across_tiles)
    if per_slice:
        # multi-slice filter semantics: gated BS, per-4x4 offset maps and
        # per-CTB SAO edge restrictions travel in meta8
        cs = 1 << sps.log2_ctb_size
        beta_c, tc_c, dis_c, lfa_c = slice_param_arrays(
            pic.slice_idx, slice_params or [{}])
        tiles_m = np.asarray(pps.tile_of_ctb) if pps.tiles_enabled \
            else np.zeros_like(pic.slice_idx)
        do_deblock = not (dis_c == 1).all()
        if do_deblock:
            pic.compute_bs()
            gv, gh = gate_bs(pic.bs_v, pic.bs_h, pic.slice_idx, tiles_m,
                             lfa_c, dis_c,
                             bool(pps.loop_filter_across_tiles), cs)
        else:
            gv = gh = np.zeros((pic.h4, pic.w4), np.int8)
        flags = sao_edge_flag_map(pic.slice_idx, tiles_m, lfa_c,
                                  bool(pps.loop_filter_across_tiles),
                                  bool(pps.tiles_enabled))
        parts8 = [pic.qp_y.astype(np.int8).reshape(-1),
                  gv.astype(np.int8).reshape(-1),
                  gh.astype(np.int8).reshape(-1),
                  upsample4(beta_c, cs, pic.h4, pic.w4)
                  .astype(np.int8).reshape(-1),
                  upsample4(tc_c, cs, pic.h4, pic.w4)
                  .astype(np.int8).reshape(-1),
                  flags.view(np.int8).reshape(-1)]
        parts.append(np.array([0, 0, pps.cb_qp_offset, pps.cr_qp_offset],
                              np.int32))
    elif dbp is not None:
        do_deblock = True
        pic.compute_bs()
        parts8 = [pic.qp_y.astype(np.int8).reshape(-1),
                  pic.bs_v.astype(np.int8).reshape(-1),
                  pic.bs_h.astype(np.int8).reshape(-1)]
        parts.append(np.array([dbp["beta_offset"], dbp["tc_offset"],
                               dbp["cb_qp_offset"], dbp["cr_qp_offset"]],
                              np.int32))
    else:
        do_deblock = False
        parts8 = [np.zeros(pic.h4 * pic.w4 * 3, np.int8)]
        parts.append(np.zeros(4, np.int32))
    # PCM (pcm_loop_filter_disabled) / transquant-bypass exemption, per 4x4
    nfmap = getattr(pic, "no_filter", None)
    nf_any = bool(nfmap is not None and nfmap.any())
    if nf_any:
        parts8.append(np.ascontiguousarray(nfmap).astype(np.int8)
                      .reshape(-1))

    with trace.span("pack.cat"):
        meta = np.concatenate(parts).astype(np.int32, copy=False)
        meta16 = np.concatenate(parts16) if parts16 \
            else np.zeros(1, np.int16)
        meta8 = np.concatenate(parts8)
        avail_u8 = np.concatenate(avail_parts) if any(B) \
            else np.zeros(1, np.uint8)
        levels16 = np.concatenate(lvl_parts)

    do_sao = bool(getattr(pic, "has_sao", False)) \
        or bool(getattr(pic, "sao_map", None))
    spec = (
        ("per_slice", per_slice),
        ("bd", sps.bit_depth_luma),
        ("n_chunks", n_chunks),
        ("B", tuple(B)),
        ("nlv", tuple(nlv)),
        ("mc_groups", tuple(mc_groups)),
        ("resid_rows", tuple(resid_rows)),
        ("regions", tuple(reg[p] for p in range(3))),
        ("h4", pic.h4), ("w4", pic.w4),
        ("ctb_h", sps.ctb_h), ("ctb_w", sps.ctb_w),
        ("ctb_log2", sps.log2_ctb_size),
        ("sub_w", sps.sub_w), ("sub_h", sps.sub_h),
        ("do_deblock", do_deblock), ("do_sao", do_sao),
        ("n_refs", n_refs),
        ("pallas", 0),
        ("nf", nf_any),
        ("mono", sps.chroma_format_idc == 0),
        ("coo", (0, sum(len(v) for v in lvl_parts))),
    )
    return meta, meta16, meta8, avail_u8, levels16, canvas0, spec
