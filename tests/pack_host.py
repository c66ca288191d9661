"""The wavefront levels of the native records pass
(``hevc_native_pack_records``, ``hevc_tpu_torch/native/stage_a_pack.h``)
and a per-sample NumPy oracle of them, with a generator of record streams
that tile a picture as a conforming stream's CUs do.

The native pass keeps one level-map cell per cell of each plane's minimum
block grid; the oracle keeps one entry per sample, as the pass did before.
Both give each intra record ``(level, fill index)``: imeta columns 1-2."""
import ctypes as C

import numpy as np

from hevc_tpu_torch import native as N
from hevc_tpu_torch.native import (KIND_INTRA, KIND_MC, KIND_PCM,
                                   KIND_RESID, REC_H, REC_KIND, REC_LVL,
                                   REC_MODE, REC_NCOLS, REC_PLANE, REC_W,
                                   REC_X, REC_Y)
from hevc_tpu_torch.pack import PAD_REF

SUB = {0: (1, 1), 1: (2, 2), 2: (2, 1), 3: (1, 1)}  # (SubWidthC, SubHeightC)


def oracle_levels(rec, width, height, sub_w, sub_h):
    """(imeta columns 1-2 of each intra record in order, raw chunk count)
    from per-sample level maps: -1 unset, 0 decoded without intra, else the
    level; an intra record's level is 1 + the most over the column left of
    it and the row above it, each 2n samples from the corner, clipped."""
    shapes = [(height, width)] + [(height // sub_h, width // sub_w)] * 2
    maps = [np.full(s, -1, np.int64) for s in shapes]
    fill = [dict() for _ in range(4)]
    out = []
    for r in rec.tolist():
        kind, p, x, y, n = (r[REC_KIND], r[REC_PLANE], r[REC_X], r[REC_Y],
                            r[REC_W])
        m = maps[p]
        if kind != KIND_INTRA:
            h = r[REC_H] if kind in (KIND_MC, KIND_PCM) else n
            blk = m[y:y + h, x:x + n]
            blk[blk < 0] = 0
            continue
        lvl = 0
        if x > 0:
            lvl = max(lvl, int(m[max(y - 1, 0):y + 2 * n, x - 1].max()) + 1)
        if y > 0:
            lvl = max(lvl, int(m[y - 1, max(x - 1, 0):x + 2 * n].max()) + 1)
        m[y:y + n, x:x + n] = lvl
        cls = {4: 0, 8: 1, 16: 2, 32: 3}[n]
        j = fill[cls].get(lvl, 0)
        fill[cls][lvl] = j + 1
        out.append((lvl, j))
    levels = np.array(out, np.int32).reshape(-1, 2)
    return levels, int(levels[:, 0].max()) + 1 if len(out) else 0


def native_pass(rec, width, height, chroma_format_idc, log2_ctb=6):
    """The native records pass on ``rec`` of one slice and one tile:
    (imeta [n_intra, 11], counts [8]); counts[5] is the raw chunk count,
    counts[6] the level-map cells used."""
    sub_w, sub_h = SUB[chroma_format_idc]
    h4, w4 = height // 4, width // 4
    ctb = 1 << log2_ctb
    ctb_h, ctb_w = -(-height // ctb), -(-width // ctb)
    P = N.PackParams()
    P.width, P.height, P.sub_w, P.sub_h = width, height, sub_w, sub_h
    P.h4, P.w4 = h4, w4
    P.log2_ctb, P.ctb_w, P.ctb_h = log2_ctb, ctb_w, ctb_h
    P.chroma444 = int(chroma_format_idc == 3)
    P.nrefs, P.r0, P.pad_ref = 1, 1, PAD_REF
    for p in range(3):
        sw, sh = (1, 1) if p == 0 else (sub_w, sub_h)
        P.reg[p * 4 + 2], P.reg[p * 4 + 3] = height // sh, width // sw
    n = max(1, rec.shape[0])
    imeta = np.empty((n, 11), np.int32)
    iavail = np.zeros((n, 128), np.uint8)
    lmeta = np.empty((n, 11), np.int32)
    mcrow = np.empty((n, 21), np.int32)
    residr = np.empty((n, 4), np.int32)
    pcmrow = np.empty((n, 6), np.int32)
    counts = np.zeros(8, np.int64)
    rc = N._pack_fn()(
        np.ascontiguousarray(rec, np.int32).reshape(-1), rec.shape[0],
        C.byref(P), np.arange(h4 * w4, dtype=np.int64),
        np.zeros(ctb_h * ctb_w, np.int32), np.zeros(ctb_h * ctb_w, np.int32),
        imeta.reshape(-1), iavail.reshape(-1), lmeta.reshape(-1),
        mcrow.reshape(-1), residr.reshape(-1), pcmrow.reshape(-1), counts)
    if rc != 0:
        raise RuntimeError(f"native pack failed (rc={rc})")
    return imeta[:int(counts[0])], counts


def _row(kind, plane, x, y, w, h=0, mode=0, lvl=-1):
    r = [0] * REC_NCOLS
    r[REC_KIND], r[REC_PLANE], r[REC_X], r[REC_Y] = kind, plane, x, y
    r[REC_W], r[REC_H], r[REC_MODE], r[REC_LVL] = w, h, mode, lvl
    return r


def synth_records(rng, width, height, chroma_format_idc, mix="mixed",
                  ctb=64):
    """Records of one picture of ``width`` x ``height`` (multiples of 8),
    CU by CU in z-order over 64x64 CTBs, as stage A emits them: each CU of
    8 to 64 is intra (TUs of 4 to 32, chroma by the format's rules), inter
    (2Nx2N, Nx2N, 2NxN or AMP PUs, 8x4 and 4x8 in 8x8 CUs; MC then residual
    TUs) or, from 8 to 32, PCM.  ``mix``: "mixed", "no_intra" or
    "all_intra"."""
    sub_w, sub_h = SUB[chroma_format_idc]
    chroma = chroma_format_idc != 0
    rows = []

    def chroma_tu(kind, x, y, n):
        """The chroma blocks of the luma TU (or 8x8 parent) at x, y, n."""
        if not chroma:
            return
        cn = n // sub_w
        ys = [y // sub_h]
        if chroma_format_idc == 2:  # two square blocks, one above the other
            ys.append(y // sub_h + cn)
        for p in (1, 2):
            for cy in ys:
                rows.append(_row(kind, p, x // sub_w, cy, cn,
                                 mode=int(rng.integers(35))))

    def tu_tree(kind, x, y, n):
        if n > 32 or (n > 4 and rng.random() < 0.45):
            h = n // 2
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                tu_tree(kind, x + dx, y + dy, h)
            if h == 4 and chroma_format_idc != 3:  # chroma of the 8x8
                chroma_tu(kind, x, y, n)
            return
        if kind == KIND_RESID and rng.random() < 0.3:
            return  # no coded residual: the MC prediction is final
        rows.append(_row(kind, 0, x, y, n, mode=int(rng.integers(35)),
                         lvl=int(rng.integers(2)) - 1))
        if n > 4 or chroma_format_idc == 3:
            chroma_tu(kind, x, y, n)

    def mc(x, y, w, h):
        rows.append(_row(KIND_MC, 0, x, y, w, h))
        if chroma:
            for p in (1, 2):
                rows.append(_row(KIND_MC, p, x // sub_w, y // sub_h,
                                 w // sub_w, h // sub_h))

    def cu(x, y, n):
        kind = {"no_intra": "inter", "all_intra": "intra"}.get(mix)
        if kind is None:  # PCM CUs are 8 to 32
            u = rng.random() * (1.0 if n <= 32 else 0.9)
            kind = "intra" if u < 0.45 else ("inter" if u < 0.9 else "pcm")
        if kind == "intra":
            tu_tree(KIND_INTRA, x, y, n)
        elif kind == "pcm":
            rows.append(_row(KIND_PCM, 0, x, y, n, n))
            if chroma:
                for p in (1, 2):
                    rows.append(_row(KIND_PCM, p, x // sub_w, y // sub_h,
                                     n // sub_w, n // sub_h))
        else:
            h, q = n // 2, n // 4
            parts = [[(0, 0, n, n)], [(0, 0, h, n), (h, 0, h, n)],
                     [(0, 0, n, h), (0, h, n, h)]]
            if n >= 16:  # AMP: 2NxnU, 2NxnD, nLx2N, nRx2N
                parts += [[(0, 0, n, q), (0, q, n, n - q)],
                          [(0, 0, n, n - q), (0, n - q, n, q)],
                          [(0, 0, q, n), (q, 0, n - q, n)],
                          [(0, 0, n - q, n), (n - q, 0, q, n)]]
            for dx, dy, w, hh in parts[int(rng.integers(len(parts)))]:
                mc(x + dx, y + dy, w, hh)
            tu_tree(KIND_RESID, x, y, n)

    def cu_tree(x, y, n):
        if x >= width or y >= height:
            return
        inside = x + n <= width and y + n <= height
        if n > 8 and (not inside or rng.random() < 0.5):
            h = n // 2
            for dy, dx in ((0, 0), (0, h), (h, 0), (h, h)):
                cu_tree(x + dx, y + dy, h)
            return
        cu(x, y, n)

    for y in range(0, height, ctb):
        for x in range(0, width, ctb):
            cu_tree(x, y, ctb)
    return np.array(rows, np.int32).reshape(-1, REC_NCOLS)
