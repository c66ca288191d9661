"""Host-side frame packing for the port's frame program (NumPy + native).

Port of ``hevc_tpu/tpu/pipeline.py:pack_frame_pipeline`` and
``_saturate_mc_windows``, which live in a module that imports JAX.  The
buffers keep the JAX package's format — int32 ``meta``, int16 ``meta16``
MC rows, int8 ``meta8`` QP/BS maps, uint8 ``avail``, int16 ``levels16``
and the static ``spec`` tuple — so ``pipeline.frame_program`` takes what
either pack produces.  It ships the level pool as (index, value) pairs
where the JAX pack does (``coo_pairs``).  It always packs the unaligned
layout (``pallas`` 0), tags every MC row kind 3 and pads no row counts:
the card needs no static shapes.

The canvas layout (``region_offsets``, the ``PAD``/``TAIL`` margins, the
``DUMP`` sentinel, ``PAD_REF``) and ``PackedFrame``, the per-frame pack of
``native.pack_frame_native``, are those of ``hevc_tpu/tpu/pack.py`` at
e99b487; ``pack_frame_plan`` (a picture's Python records to a
``PackedFrame``, what the banded and frame-axis decodes pack) is that
module's ``pack_frame`` at 7a00da0.
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


def _schedule_levels(pic, plan):
    """Wavefront scheduling of a picture's BlockRecords (a copy of
    ``hevc_tpu/tpu/pack.py:_schedule_levels`` at 7a00da0): MC records have
    no canvas dependencies, inter residual adds depend only on the MC
    writes below them, and an intra record's level is 1 + the highest
    level of the blocks its L-shaped reference band reads.  Returns
    (mc_records, resid_records, chunks), chunks[level] = intra records."""
    sps = pic.sps
    shapes = {0: (sps.height, sps.width)}
    shapes[1] = shapes[2] = (sps.height // sps.sub_h, sps.width // sps.sub_w)
    lvl_map = {p: np.full(shapes[p], -1, np.int32) for p in range(3)}
    chunks = []
    mc_records = []
    resid_records = []
    for r in plan:
        m = lvl_map[r.plane]
        if r.kind in ("mc", "pcm"):
            # PCM samples pre-fill the canvas: readable from level 0 like
            # MC output
            m[r.y:r.y + r.h, r.x:r.x + r.size] = \
                np.maximum(m[r.y:r.y + r.h, r.x:r.x + r.size], 0)
            if r.kind == "mc":
                mc_records.append(r)
            continue
        if r.kind == "resid":
            m[r.y:r.y + r.size, r.x:r.x + r.size] = \
                np.maximum(m[r.y:r.y + r.size, r.x:r.x + r.size], 0)
            resid_records.append(r)
            continue
        h, w = m.shape
        n2 = 2 * r.size
        x0 = max(0, r.x - 1)
        y0 = max(0, r.y - 1)
        col = m[y0:min(h, r.y + n2), x0:r.x] if r.x > 0 else None
        row = m[y0:r.y, x0:min(w, r.x + n2)] if r.y > 0 else None
        lvl = 0
        if col is not None and col.size:
            lvl = max(lvl, int(col.max()) + 1)
        if row is not None and row.size:
            lvl = max(lvl, int(row.max()) + 1)
        m[r.y:r.y + r.size, r.x:r.x + r.size] = lvl
        while len(chunks) <= lvl:
            chunks.append([])
        chunks[lvl].append(r)
    return mc_records, resid_records, chunks


def pack_frame_plan(pic, plan) -> PackedFrame:
    """A picture's Python BlockRecords -> ``PackedFrame`` (a copy of
    ``hevc_tpu/tpu/pack.py:pack_frame`` at 7a00da0).

    Not ``pack_frame``, the native pipeline pack of this module: this one
    takes the record list of ``Decoder(recon_backend="plan")`` and any
    object with the ``PictureState`` queries it uses, which is how the
    banded decode packs one column band (``band._BandPic``).  Unlike the
    JAX pack it packs no reference planes (``refs_l``/``refs_c`` stay
    None: the banded and frame-axis decodes read their references from the
    device), and a class's batch width per wavefront chunk is its largest
    count, not the next power of two.  MC rows keep the JAX field layout
    ((is_chroma, bi, w, h, wp, fields)); ``band.mc_rows`` converts them for
    ``mc_cuda.mc``.  A reference window outside the PAD_REF-padded frame
    vertically, or left of it, raises ValueError."""
    from .ops import reference as R
    from .ops.mc import chroma_mv_parts
    sps = pic.sps
    bd = sps.bit_depth_luma
    reg, ch, cw = region_offsets(sps)
    canvas = np.zeros((ch, cw), np.int32)
    classes = {4: 0, 8: 1, 16: 2, 32: 3}
    chroma444 = sps.chroma_format_idc == 3

    mc_records, resid_records, chunks = _schedule_levels(pic, plan)

    # residual pools (slot 0 = zeros, prepended on the device); rmeta row:
    # (qp, dst, ts, raw, mtx+1, rot, rdpcm, ccp_alpha, ccp_slot)
    lv = [[] for _ in range(4)]
    rmeta = [[] for _ in range(4)]
    slots = {}
    for r in plan:
        if r.kind == "pcm":
            oy, ox, _, _ = reg[r.plane]
            canvas[oy + r.y:oy + r.y + r.h,
                   ox + r.x:ox + r.x + r.size] = r.levels
            continue
        if r.levels is None and not getattr(r, "ccp", 0):
            continue
        c = classes[r.size]
        if r.levels is None:  # CCP-only chroma TU: own zero-level slot
            lv[c].append(np.zeros((r.size, r.size), np.int32))
        else:
            lv[c].append(np.asarray(r.levels, np.int32))
        rmeta[c].append((r.qp, int(r.dst), int(r.ts), int(r.tqb),
                         r.mtx + 1, int(getattr(r, "rot", False)),
                         int(getattr(r, "rdpcm", 0)),
                         int(getattr(r, "ccp", 0)), 0))
        slots[id(r)] = len(lv[c])
    for r in plan:  # CCP luma slots (same size class in 4:4:4)
        if getattr(r, "ccp", 0) and r.kind != "pcm":
            c = classes[r.size]
            row = list(rmeta[c][slots[id(r)] - 1])
            row[8] = slots[id(r.ccp_ref)]
            rmeta[c][slots[id(r)] - 1] = tuple(row)

    rec_meta = {}  # id(rec) -> (class, scal fields, avail bits)
    for chk in chunks:
        for r in chk:
            n = r.size
            sx = sps.sub_w if r.plane else 1
            sy = sps.sub_h if r.plane else 1
            oy, ox, rh, rw = reg[r.plane]
            xl, yl = r.x * sx, r.y * sy
            bits = np.zeros(128, bool)
            for i in range(2 * n):
                if r.y + i < rh:
                    bits[i] = pic.available(xl, yl, xl - sx, (r.y + i) * sy)
                if r.x + i < rw:
                    bits[64 + i] = pic.available(xl, yl, (r.x + i) * sx,
                                                 yl - sy)
            ac = pic.available(xl, yl, xl - sx, yl - sy)
            filt = (not sps.intra_smoothing_disabled
                    and R._filter_flag(r.mode, n, r.plane, chroma444, False))
            strong = bool(sps.strong_intra_smoothing) and n == 32 and filt
            rec_meta[id(r)] = (classes[n], (
                oy + r.y, ox + r.x, r.mode, slots.get(id(r), 0), int(filt),
                int(strong), int(r.plane == 0 and n < 32), int(ac)), bits)

    # ---- MC + inter-residual phase groups -------------------------------
    refs0 = getattr(pic, "ref_list_l0", []) or []
    refs1 = getattr(pic, "ref_list_l1", []) or []
    nrefs = len(refs0) + len(refs1)
    r0 = len(refs0)
    hs, vs = sps.sub_w - 1, sps.sub_h - 1

    def _mc_entry(r, mv, ridx, lx):
        """(sel, by, bx, fx, fy) for one prediction of a record."""
        if r.plane:
            ox, fx = chroma_mv_parts(mv[0], hs)
            oy, fy = chroma_mv_parts(mv[1], vs)
            bx = PAD_REF + r.x + ox - 1
            by = PAD_REF + r.y + oy - 1
            sel = (r.plane - 1) * nrefs + ridx + (r0 if lx else 0)
            hp = sps.height // sps.sub_h + 2 * PAD_REF
            ext = 3
        else:
            fx, fy = mv[0] & 3, mv[1] & 3
            bx = PAD_REF + r.x + (mv[0] >> 2) - 3
            by = PAD_REF + r.y + (mv[1] >> 2) - 3
            sel = ridx + (r0 if lx else 0)
            hp = sps.height + 2 * PAD_REF
            ext = 7
        if bx < 0 or by < 0 or by + r.h + ext > hp:
            raise ValueError("MV exceeds PAD_REF")
        return (sel, by, bx, fx, fy)

    mc_grp = {}
    for r in mc_records:
        oy, ox, _, _ = reg[r.plane]
        if r.bi:
            row = (_mc_entry(r, r.mv, r.ref_idx, 0)
                   + _mc_entry(r, r.mv1, r.ref_idx1, 1)
                   + (oy + r.y, ox + r.x))
        else:
            row = _mc_entry(r, r.mv, r.ref_idx, r.lx) + (oy + r.y, ox + r.x)
        if r.wp is not None:
            row = row + tuple(r.wp)
        key = (r.plane > 0, bool(r.bi), r.size, r.h, r.wp is not None)
        mc_grp.setdefault(key, []).append(row)
    mc_groups = tuple(
        k + (np.asarray(v, np.int32),) for k, v in sorted(mc_grp.items()))
    resid_grp = [[] for _ in range(4)]
    for r in resid_records:
        oy, ox, _, _ = reg[r.plane]
        resid_grp[classes[r.size]].append((oy + r.y, ox + r.x, slots[id(r)]))
    resid_groups = tuple(
        np.asarray(g, np.int32) if g else np.zeros((0, 3), np.int32)
        for g in resid_grp)

    n_chunks = _round_up(max(1, len(chunks)), 16)
    counts = [max((sum(1 for r in chk if classes[r.size] == c)
                   for chk in chunks), default=0) for c in range(4)]
    scal, avail = [], []
    for c in range(4):
        a = np.zeros((n_chunks, counts[c], 8), np.int32)
        a[:, :, 0] = DUMP
        a[:, :, 1] = DUMP
        a[:, :, 2] = 1
        scal.append(a)
        avail.append(np.zeros((n_chunks, counts[c], 128), bool))
    for k, chk in enumerate(chunks):
        fill = [0, 0, 0, 0]
        for r in chk:
            c, fields, bits = rec_meta[id(r)]
            scal[c][k, fill[c]] = fields
            avail[c][k, fill[c]] = bits
            fill[c] += 1

    levels, rmetas = [], []
    for c, s in enumerate((4, 8, 16, 32)):
        nlv = _round_up(max(1, len(lv[c]) + 1), 16)
        padl = nlv - len(lv[c])
        levels.append(np.stack(lv[c] + [np.zeros((s, s), np.int32)] * padl))
        rmetas.append(np.asarray(rmeta[c] + [(0,) * 9] * padl, np.int32))

    # scaling-list matrix banks: slot 0 = flat 16, 1..6 = matrix ids
    scaling = getattr(pic, "scaling", None)
    bank = []
    for c in range(4):
        b = np.full((7, 4 << c, 4 << c), 16, np.int32)
        if scaling is not None:
            for mid in range(6):
                b[mid + 1] = scaling.factor(c + 2, mid)[0]
        bank.append(b)

    return PackedFrame(canvas=canvas, scal=tuple(scal), avail=tuple(avail),
                       levels=tuple(levels), rmeta=tuple(rmetas),
                       n_chunks=n_chunks, region=reg, bit_depth=bd,
                       mc_groups=mc_groups, resid_groups=resid_groups,
                       scale_bank=tuple(bank))


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


@dataclass
class FilterInputs:
    """What the in-loop filters of one picture read, picture-wide: the
    single-device frame program's (through ``pack_frame``'s meta8) and the
    banded decode's (``band._bundle_frame``, one column slice a band)."""
    per_slice: bool               # several slices, or tiles without loop
                                  # filtering across them
    do_deblock: bool              # some slice deblocks
    qp4: np.ndarray               # QpY per 4x4 [h4, w4]
    bs_v: np.ndarray              # boundary strengths per 4x4, gated at
    bs_h: np.ndarray              # slice and tile edges (None when no
                                  # slice deblocks)
    beta: object                  # beta / tc offsets: ints, or per-4x4
    tc: object                    # [h4, w4] maps of each 4x4's slice
    cb_qp_off: int
    cr_qp_off: int
    sao_flags: np.ndarray = None  # uint8 [ctb_h, ctb_w] SAO edge
                                  # restrictions (``boundaries.SAO_*``)
    no_filter: np.ndarray = None  # bool [h4, w4] PCM / transquant-bypass
                                  # samples no filter modifies; None if none


def filter_inputs(pic) -> FilterInputs:
    """The filter inputs of a stage-A picture (multi-slice semantics:
    reference hevc_filter.c's s->deblock[ctb] and filter_slice_edges)."""
    sps, pps = pic.sps, pic.pps
    dbp = getattr(pic, "deblock_params", None)
    slice_params = getattr(pic, "slice_params", None) or []
    nfmap = getattr(pic, "no_filter", None)
    nf = np.ascontiguousarray(nfmap) if nfmap is not None and nfmap.any() \
        else None
    if len(slice_params) > 1 or (pps.tiles_enabled
                                 and not pps.loop_filter_across_tiles):
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
        return FilterInputs(
            True, do_deblock, pic.qp_y, gv, gh,
            upsample4(beta_c, cs, pic.h4, pic.w4),
            upsample4(tc_c, cs, pic.h4, pic.w4),
            pps.cb_qp_offset, pps.cr_qp_offset, flags, nf)
    if dbp is not None:
        pic.compute_bs()
        return FilterInputs(False, True, pic.qp_y, pic.bs_v, pic.bs_h,
                            dbp["beta_offset"], dbp["tc_offset"],
                            dbp["cb_qp_offset"], dbp["cr_qp_offset"],
                            None, nf)
    return FilterInputs(False, False, pic.qp_y, None, None, 0, 0, 0, 0,
                        None, nf)


# the sparse level upload of the JAX pack (``pack_frame_pipeline``): a pool
# of at least this many coefficients, fewer than a third of them nonzero,
# ships as (int32 index, int16 value) pairs, 6 bytes a nonzero against 2 a
# coefficient
COO_MIN = 1 << 16


def _pad_pairs(nz, val, total):
    """``nz``/``val`` padded to a power of two with the index ``total``
    (dropped on the device) and the value 0."""
    coo_n = _pow2_at_least(max(int(nz.size), 1))
    idx = np.full(coo_n, total, np.int32)
    idx[:nz.size] = nz
    pad = np.zeros(coo_n, np.int16)
    pad[:nz.size] = val
    return idx, pad


def coo_pairs(levels16):
    """(idx int32, val int16) of the nonzero levels of an int16 pool, padded
    to a power of two with the index ``levels16.size`` (dropped on the
    device), where the JAX pack ships the pool so; else None."""
    if levels16.size < COO_MIN:
        return None
    nz = np.nonzero(levels16)[0]
    if nz.size * 3 >= levels16.size:
        return None
    return _pad_pairs(nz, levels16[nz], levels16.size)


def sparse_levels(lvl, lm, nlv):
    """``coo_pairs`` of the dense level pool that ``hevc_native_gather_levels``
    would fill from ``lvl`` and the level rows ``lm`` (class, offset in
    ``lvl``, ...; ``nlv`` slots a class), found from the nonzeros of
    ``lvl`` without building the pool.  None where two rows share
    coefficients of ``lvl``, or where ``lvl`` holds a sixteenth or more of
    the pool's size in nonzeros: sorting that many pairs costs more than
    building the pool, which then decides (``coo_pairs``)."""
    sizes = [(4 << c) * (4 << c) for c in range(4)]
    total = sum(n * s for n, s in zip(nlv, sizes))
    if total < COO_MIN or np.count_nonzero(lvl) * 16 >= total:
        return None
    cls, off = lm[:, 0], lm[:, 1]
    # each row's slot in its class's pool, in row order
    slot = np.empty(cls.size, np.int64)
    for c in range(4):
        rows = np.flatnonzero(cls == c)
        slot[rows] = np.arange(rows.size)
    size = np.asarray(sizes, np.int64)[cls]
    base = np.concatenate([[0], np.cumsum([n * s for n, s in
                                           zip(nlv, sizes)])])[cls]
    live = np.flatnonzero(off >= 0)  # CCP-only rows keep a zeroed slot
    order = live[np.argsort(off[live], kind="stable")]
    start = off[order].astype(np.int64)
    end = start + size[order]
    if np.any(start[1:] < end[:-1]):
        return None
    p = np.flatnonzero(lvl != 0)  # a mask first: several times faster
    r = np.searchsorted(start, p, side="right") - 1
    keep = r >= 0
    keep[keep] = p[keep] < end[r[keep]]
    p, r = p[keep], r[keep]
    row = order[r]
    idx = base[row] + slot[row] * size[row] + (p - start[r])
    srt = np.argsort(idx, kind="stable")
    return _pad_pairs(idx[srt], lvl[p[srt]], total), total


def _level_rows(lm, nlv):
    """The per-class residual rows ``hevc_native_gather_levels`` writes:
    each level row's fields 2..10, in row order, zero-padded to ``nlv``."""
    rms = [np.zeros((nlv[c], 9), np.int32) for c in range(4)]
    for c in range(4):
        rows = lm[lm[:, 0] == c, 2:11]
        rms[c][:rows.shape[0]] = rows
    return rms


def pack_frame(pic):
    """Native records of one picture -> (meta, meta16, meta8, avail_u8,
    levels16, canvas0, spec).  ``canvas0`` is the canvas shape (the frame
    program starts from zeros), or an int16 host canvas holding the
    picture's PCM samples; ``levels16`` the int16 level pool, or its
    (idx, val) pairs where ``coo_pairs`` ships it sparse (spec ``coo``:
    (pairs, pool size), pairs 0 for a dense pool)."""
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
    trace.count("pack_map_cells", int(counts[6]))
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
    with trace.span("pack.intra"):
        sels, B = [], []
        for c in range(4):
            sel = np.nonzero(cls_i == c)[0]
            cnt = int(im[sel, 2].max()) + 1 if sel.size else 0
            sels.append(sel)
            B.append(_pow2_at_least(cnt) if cnt else 0)
        # the classes' [n_chunks, B_c, 128] availability blocks back to
        # back, written in place: the upload's own buffer
        avail_u8 = np.zeros(n_chunks * sum(B) * 128 or 1, np.uint8)
        avail_rows = avail_u8[:n_chunks * sum(B) * 128].reshape(-1, 128)
        row0 = 0
        for sel, Bc in zip(sels, B):
            a = np.zeros((n_chunks, Bc, 8), np.int32)
            a[:, :, 0] = DUMP
            a[:, :, 1] = DUMP
            a[:, :, 2] = 1
            if sel.size:
                a[im[sel, 1], im[sel, 2]] = im[sel, 3:11]
                avail_rows[row0 + im[sel, 1] * Bc + im[sel, 2]] = iv[sel]
            row0 += n_chunks * Bc
            parts.append(a.reshape(-1))

    with trace.span("pack.levels"):
        # per-class (rmeta, int16 levels); padding rows and the CCP zero
        # slot stay zeroed.  A pool that ships sparse is never built: its
        # pairs come from the nonzeros of the native level buffer
        cls_counts = np.bincount(lm[:, 0], minlength=4) if nl else \
            np.zeros(4, np.int64)
        nlv = [_round_up(int(cls_counts[c]) + 1, 16) for c in range(4)]
        sparse = sparse_levels(lvl, lm, nlv) if nl else None
        if sparse is not None:
            levels16, total = sparse
            rms = _level_rows(lm, nlv)
        else:
            sizes = [nlv[c] * (4 << c) * (4 << c) for c in range(4)]
            levels16 = np.zeros(sum(sizes), np.int16)
            rms = [np.zeros((nlv[c], 9), np.int32) for c in range(4)]
            if nl:
                cuts = np.cumsum(sizes)[:3]
                N._gather_levels_fn()(
                    lvl, np.ascontiguousarray(lm).reshape(-1), nl,
                    *(r.reshape(-1) for r in rms),
                    *np.split(levels16, cuts))
            total = levels16.size
            pairs = coo_pairs(levels16)
            if pairs is not None:
                levels16 = pairs
        parts += [r.reshape(-1) for r in rms]

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
    fi = filter_inputs(pic)
    per_slice, do_deblock = fi.per_slice, fi.do_deblock
    if per_slice:
        # multi-slice filter semantics: gated BS, per-4x4 offset maps and
        # per-CTB SAO edge restrictions travel in meta8
        parts8 = [fi.qp4.astype(np.int8).reshape(-1),
                  fi.bs_v.astype(np.int8).reshape(-1),
                  fi.bs_h.astype(np.int8).reshape(-1),
                  fi.beta.astype(np.int8).reshape(-1),
                  fi.tc.astype(np.int8).reshape(-1),
                  fi.sao_flags.view(np.int8).reshape(-1)]
        parts.append(np.array([0, 0, fi.cb_qp_off, fi.cr_qp_off], np.int32))
    elif do_deblock:
        parts8 = [fi.qp4.astype(np.int8).reshape(-1),
                  fi.bs_v.astype(np.int8).reshape(-1),
                  fi.bs_h.astype(np.int8).reshape(-1)]
        parts.append(np.array([fi.beta, fi.tc, fi.cb_qp_off, fi.cr_qp_off],
                              np.int32))
    else:
        parts8 = [np.zeros(pic.h4 * pic.w4 * 3, np.int8)]
        parts.append(np.zeros(4, np.int32))
    # PCM (pcm_loop_filter_disabled) / transquant-bypass exemption, per 4x4
    nf_any = fi.no_filter is not None
    if nf_any:
        parts8.append(fi.no_filter.astype(np.int8).reshape(-1))

    with trace.span("pack.cat"):
        meta = np.concatenate(parts).astype(np.int32, copy=False)
        meta16 = np.concatenate(parts16) if parts16 \
            else np.zeros(1, np.int16)
        meta8 = np.concatenate(parts8)
        coo_n = levels16[0].size if isinstance(levels16, tuple) else 0

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
        ("coo", (coo_n, total)),
    )
    return meta, meta16, meta8, avail_u8, levels16, canvas0, spec
