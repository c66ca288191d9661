"""Native (C++) stage-A front-end: build, load, and marshal.

The reference implements its entropy front-end in C with per-arch
assembly (reference: libavcodec/cabac.c, hevc_cabac.c, hevcdec.c:2845
hls_decode_entry); this module is our native-runtime equivalent — a C++
shared library compiled on first use with the baked-in toolchain and
driven through ctypes.  Two entry points:

  hevc_native_decode_residual — one transform block's residual coding
      (used by the inline/oracle path as a drop-in hot-loop kernel);
  hevc_native_decode_slice — the FULL CTU syntax loop for one slice
      segment chain (quadtree, CU/PU/TU syntax, MV derivation, QP state,
      SAO, PCM, WPP/tile segments), emitting a decode-ordered BlockRecord
      stream + residual-level pool + SAO parameter maps.

The Python CABAC engine/syntax layer (hevc_tpu/cabac, decoder/core.py)
remains the correctness oracle; bit-exact equivalence is asserted by
tests/test_native.py and tests/test_native_stagea.py.

Set HEVC_TPU_NATIVE=0 to force the pure-Python path.

Copied from ``hevc_tpu/native/__init__.py`` at e99b487.
"""
from __future__ import annotations

import ctypes as C
import os
import subprocess
import sys
from functools import lru_cache

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "stage_a.cpp")
_HDRS = (os.path.join(_DIR, "stage_a_engine.h"),
         os.path.join(_DIR, "stage_a_syntax.h"),
         os.path.join(_DIR, "stage_a_mt.h"),
         os.path.join(_DIR, "stage_a_pack.h"))
# built into the package's git-ignored build/ directory, beside the kernels
_SO = os.path.join(os.path.dirname(_DIR), "build", "_stagea.so")

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I16P = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I8P = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

# record stream layout — must match stage_a.cpp REC_* enum
REC_NCOLS = 24
(REC_KIND, REC_PLANE, REC_X, REC_Y, REC_W, REC_H, REC_MODE, REC_QP,
 REC_FLAGS, REC_MTX, REC_LVL, REC_MVX0, REC_MVY0, REC_REF0, REC_MVX1,
 REC_MVY1, REC_REF1, REC_WPW0, REC_WPO0, REC_WPW1, REC_WPO1,
 REC_LOG2WD, REC_CCP, REC_CCPREF) = range(24)
KIND_INTRA, KIND_RESID, KIND_MC, KIND_PCM = range(4)
F_DST, F_TS, F_TQB, F_BI, F_LX = 1, 2, 4, 8, 16
F_ROT, F_RDPCM_H, F_RDPCM_V = 32, 64, 128


class NativeParams(C.Structure):
    """Mirror of stage_a.cpp `struct Params` (field order must match)."""
    _fields_ = [(n, C.c_int32) for n in (
        "width", "height", "ctb_w", "ctb_h", "h4", "w4",
        "log2_ctb", "log2_min_cb", "log2_min_tb", "log2_max_tb",
        "max_tr_depth_intra", "max_tr_depth_inter",
        "chroma_fmt", "sub_w", "sub_h", "bd_luma", "bd_chroma",
        "qp_bd_offset",
        "amp_enabled", "pcm_enabled", "log2_min_pcm", "log2_max_pcm",
        "pcm_bd_luma", "pcm_bd_chroma", "pcm_filter_disabled",
        "sao_enabled", "have_scaling",
        "slice_qp",
        "cu_qp_delta_enabled", "diff_cu_qp_delta_depth",
        "tq_bypass_enabled", "ts_enabled", "log2_max_ts", "sdh",
        "pps_cb_qp_offset", "pps_cr_qp_offset",
        "wpp", "tiles",
        "slice_type", "sao_luma", "sao_chroma",
        "max_merge", "nref0", "nref1", "mvd_l1_zero",
        "slice_idx_val", "seg_addr",
        "sh_cb_qp_offset", "sh_cr_qp_offset",
        "has_tmvp", "no_backward", "col_from_l0",
        "has_wp", "wp_log2wd_luma", "wp_log2wd_chroma",
        "n_segs", "n_ctx",
        "persistent_rice", "ts_context", "implicit_rdpcm",
        "explicit_rdpcm", "ts_rotation", "ccp_enabled",
        "chroma_qp_offset_enabled", "diff_cu_chroma_qp_offset_depth",
        "n_chroma_offsets",
    )]


def _build() -> str:
    srcs_mtime = max(os.path.getmtime(p) for p in (_SRC,) + _HDRS)
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < srcs_mtime:
        # one temporary name per process: concurrent builders (test
        # workers) each finish their own file before the atomic rename
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        tmp = f"{_SO}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 _SRC, "-o", tmp],
                check=True, capture_output=True)
            os.replace(tmp, _SO)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return _SO


@lru_cache(maxsize=1)
def _lib():
    lib = C.CDLL(_build())
    fn = lib.hevc_native_decode_residual
    fn.restype = C.c_int
    fn.argtypes = [
        C.c_char_p, C.c_int64,                       # data, nbytes
        C.POINTER(C.c_int64),                        # io_bytepos
        C.POINTER(C.c_int32), C.POINTER(C.c_int32),  # io_range, io_offset
        C.POINTER(C.c_int32), C.POINTER(C.c_int32),  # io_bitbuf, io_nbits
        _U8P, _I32P,                                 # ctx, off
        C.c_int32, C.c_int32, C.c_int32,             # log2_size, c_idx, scan
        C.c_int32, C.c_int32, C.c_int32,             # sdh, ts_allowed, tqb
        _I32P, _I32P, _I32P,                         # sub/coef scan, pos map
        _I16P, C.POINTER(C.c_int32),                 # levels, ts_flag
    ]
    fs = lib.hevc_native_decode_slice
    fs.restype = C.c_int64
    fs.argtypes = [
        C.c_char_p, C.c_int64, _I64P,                # rbsp, nbytes, segs
        C.POINTER(NativeParams),
        _U8P, _U8P, _I32P,                           # fresh_ctx, ctx, stat
        _I32P, _I32P, _I32P,                         # ctx_off, scans, s_off
        _I32P, _I32P, _I32P, _I32P,                  # pps tables
        _I8P, _U8P, _I8P, _U8P, _I8P, _I32P,         # mode..slice_idx
        _U8P, _U8P, _U8P, _U8P, _U8P, _U8P, _U8P,    # tqb..cbf_luma
        _I32P, _I8P, _I64P, _I32P, _I8P, _I64P,      # mv/ref/poc l0,l1
        _I64P,                                       # z_order
        _I64P, _U8P, _I64P, _U8P,                    # ref lists
        _I32P, _I64P, _I32P, _I64P,                  # col motion
        C.c_int64, C.c_int64,                        # col_poc, cur_poc
        _I32P, _I32P,                                # wp_w, wp_o
        _I32P, _I32P, _I32P, _I32P,                  # sao out
        _I32P, _I32P,                                # chroma offset lists
        _I32P, C.c_int64, _I16P, C.c_int64,          # rec, cap, lvl, cap
        C.c_int32,                                   # n_threads
        _I64P,                                       # out_counts
    ]
    return lib


def stagea_threads() -> int:
    """Worker threads for the parallel stage-A paths (WPP rows / tiles).

    HEVC_TPU_STAGEA_THREADS overrides; default = CPU count - 1 (one
    core stays free for the pack/dispatch worker), min 1.  Measured on
    a 2-core host, 2 WPP threads run ~1.3x SLOWER than 1 (the 2-CTU-lag
    spin-wait burns the sibling core), so small hosts get 1."""
    v = os.environ.get("HEVC_TPU_STAGEA_THREADS")
    if v is not None:
        return max(1, int(v))
    return max(1, (os.cpu_count() or 2) - 1)


def available() -> bool:
    if os.environ.get("HEVC_TPU_NATIVE", "1") == "0":
        return False
    try:
        _lib()
        return True
    except Exception as e:  # missing toolchain etc. — fall back to Python
        print(f"hevc_tpu_torch.native: disabled ({e})", file=sys.stderr)
        return False


# fixed CtxId order of stage_a.cpp — the offsets array is built from the
# Python layout (single source of truth: hevc_tpu.cabac.ctx CTX_OFFSET)
_CTX_ORDER = (
    "sao_merge_flag", "sao_type_idx", "split_cu_flag",
    "cu_transquant_bypass_flag", "cu_skip_flag", "cu_qp_delta",
    "pred_mode_flag", "part_mode", "prev_intra_luma_pred_flag",
    "intra_chroma_pred_mode", "merge_flag", "merge_idx", "inter_pred_idc",
    "ref_idx_l0", "ref_idx_l1", "abs_mvd_greater0_flag",
    "abs_mvd_greater1_flag", "mvp_lx_flag", "no_residual_data_flag",
    "split_transform_flag", "cbf_luma", "cbf_cbcr", "transform_skip_flag",
    "explicit_rdpcm_flag", "explicit_rdpcm_dir_flag",
    "last_sig_coeff_x_prefix", "last_sig_coeff_y_prefix",
    "coded_sub_block_flag", "sig_coeff_flag",
    "coeff_abs_level_greater1_flag", "coeff_abs_level_greater2_flag",
    "log2_res_scale_abs", "res_scale_sign_flag",
    "cu_chroma_qp_offset_flag", "cu_chroma_qp_offset_idx",
)


@lru_cache(maxsize=None)
def _full_ctx_offsets() -> np.ndarray:
    from ..cabac.ctx import CTX_OFFSET
    return np.array([CTX_OFFSET[n] for n in _CTX_ORDER], np.int32)


@lru_cache(maxsize=None)
def _ctx_offsets() -> np.ndarray:
    """Legacy 7-entry layout of the residual-only entry."""
    from ..cabac.ctx import CTX_OFFSET

    names = ("transform_skip_flag", "last_sig_coeff_x_prefix",
             "last_sig_coeff_y_prefix", "coded_sub_block_flag",
             "sig_coeff_flag", "coeff_abs_level_greater1_flag",
             "coeff_abs_level_greater2_flag")
    return np.array([CTX_OFFSET[n] for n in names], np.int32)


@lru_cache(maxsize=None)
def _scan_tables(scan_idx: int, log2_size: int):
    from ..coding.scans import block_scan

    sub_scan, coef_scan, pos_of_xy = block_scan(scan_idx, log2_size)
    return (np.ascontiguousarray(sub_scan.reshape(-1), np.int32),
            np.ascontiguousarray(coef_scan.reshape(-1), np.int32),
            np.ascontiguousarray(pos_of_xy.reshape(-1), np.int32))


@lru_cache(maxsize=1)
def _scan_bank():
    """All scan tables flattened into one buffer + offsets per
    (scan_idx, log2_size, {sub, coef, pos})."""
    parts = []
    offs = np.zeros(3 * 4 * 3, np.int32)
    pos = 0
    for scan in range(3):
        for log2 in range(2, 6):
            trip = _scan_tables(scan, log2)
            for k, arr in enumerate(trip):
                offs[(scan * 4 + (log2 - 2)) * 3 + k] = pos
                parts.append(arr)
                pos += arr.size
    return np.concatenate(parts).astype(np.int32), offs


def decode_residual(d, cm, log2_size: int, c_idx: int, scan_idx: int, *,
                    sign_data_hiding: bool = False,
                    transform_skip_allowed: bool = False,
                    tq_bypass: bool = False):
    """Drop-in replacement for coding.residual.decode_residual backed by
    the C++ kernel.  Marshals the CabacDecoder + ContextModel state in
    and out around the call."""
    fn = _lib().hevc_native_decode_residual
    size = 1 << log2_size
    ctx = np.array(cm.states, np.uint8)
    sub_scan, coef_scan, pos_of_xy = _scan_tables(scan_idx, log2_size)
    levels = np.empty((size, size), np.int16)

    bytepos = C.c_int64(d.bytepos)
    rng = C.c_int32(d.range)
    off = C.c_int32(d.offset)
    bitbuf = C.c_int32(d._bitbuf)
    nbits = C.c_int32(d._nbits)
    ts_flag = C.c_int32(0)
    rc = fn(d.data, len(d.data), C.byref(bytepos), C.byref(rng),
            C.byref(off), C.byref(bitbuf), C.byref(nbits),
            ctx, _ctx_offsets(),
            log2_size, c_idx, scan_idx,
            int(sign_data_hiding), int(transform_skip_allowed),
            int(tq_bypass),
            sub_scan, coef_scan, pos_of_xy,
            levels.reshape(-1), C.byref(ts_flag))
    assert rc == 0
    d.bytepos = bytepos.value
    d.range = rng.value
    d.offset = off.value
    d._bitbuf = bitbuf.value
    d._nbits = nbits.value
    cm.states[:] = ctx.tolist()
    return levels, int(ts_flag.value)


# ---------------------------------------------------------------------------
# Full-slice stage-A front-end
# ---------------------------------------------------------------------------

_BUF_CACHE: dict = {}


def _buffers(w4: int, h4: int, fmt: int):
    """Worst-case record/level buffers, cached per picture geometry.

    Records: every 4x4 luma TU + worst-case chroma TUs + MC triples stay
    under 4 rows per 4x4 luma block; levels: total coded coefficients
    cannot exceed total samples across planes."""
    key = (w4, h4, fmt)
    if key not in _BUF_CACHE:
        n44 = w4 * h4
        cap_rec = 4 * n44 + 1024
        cfrac = {0: 0, 1: 8, 2: 16, 3: 32}[fmt]
        cap_lvl = 16 * n44 + (cfrac * n44 * 16) // 16 + 4096
        _BUF_CACHE[key] = (np.empty((cap_rec, REC_NCOLS), np.int32),
                           np.empty(cap_lvl, np.int16))
    return _BUF_CACHE[key]


def _pps_tables(pps):
    tabs = getattr(pps, "_native_tabs", None)
    if tabs is None:
        tabs = tuple(np.ascontiguousarray(a, np.int32) for a in (
            pps.ctb_addr_rs_to_ts, pps.ctb_addr_ts_to_rs,
            pps.tile_id_of_ts, pps.tile_of_ctb))
        pps._native_tabs = tabs
    return tabs


def _wp_tables(sh, sps):
    """[list][plane][ref] weight/offset tables with reference-style
    offset scaling (offset << (bd - 8)); log2wd per plane class."""
    wt = sh.weight_table
    w = np.zeros((2, 3, 16), np.int32)
    o = np.zeros((2, 3, 16), np.int32)
    if wt is None:
        return w, o, 0, 0
    os_l = sps.bit_depth_luma - 8
    os_c = sps.bit_depth_chroma - 8
    for li, (luma, chro) in enumerate(((wt.luma_l0, wt.chroma_l0),
                                       (wt.luma_l1, wt.chroma_l1))):
        for ridx in range(min(16, len(luma))):
            w[li, 0, ridx] = luma[ridx][1]
            o[li, 0, ridx] = luma[ridx][2] << os_l
        for ridx in range(min(16, len(chro))):
            _, ws, oss = chro[ridx]
            for c in (1, 2):
                w[li, c, ridx] = ws[c - 1]
                o[li, c, ridx] = oss[c - 1] << os_c
    log2wd_l = wt.luma_log2_denom + 14 - sps.bit_depth_luma
    log2wd_c = wt.chroma_log2_denom + 14 - sps.bit_depth_chroma
    return w, o, log2wd_l, log2wd_c


def records_to_plan(rec: np.ndarray, lvl: np.ndarray, plan: list) -> None:
    """Convert the native record stream into BlockRecords (decode order),
    appending to `plan`.  Level arrays are int32 copies of the int16
    pool slices (the NumPy oracle does int32 arithmetic)."""
    from ..decoder.core import BlockRecord
    rows = rec.tolist()
    made = [None] * len(rows)  # row index -> record (CCP luma refs)
    for ri, r in enumerate(rows):
        kind = r[REC_KIND]
        if kind == KIND_MC:
            plan.append(BlockRecord(
                plane=r[REC_PLANE], x=r[REC_X], y=r[REC_Y], size=r[REC_W],
                h=r[REC_H], mode=0, qp=0, levels=None, kind="mc",
                bi=bool(r[REC_FLAGS] & F_BI),
                lx=1 if (r[REC_FLAGS] & F_LX) else 0,
                mv=(r[REC_MVX0], r[REC_MVY0]), ref_idx=r[REC_REF0],
                mv1=(r[REC_MVX1], r[REC_MVY1]), ref_idx1=r[REC_REF1],
                wp=((r[REC_WPW0], r[REC_WPO0], r[REC_WPW1], r[REC_WPO1],
                     r[REC_LOG2WD]) if r[REC_LOG2WD] >= 0 else None)))
        elif kind == KIND_PCM:
            n = r[REC_W] * r[REC_H]
            blk = lvl[r[REC_LVL]:r[REC_LVL] + n].reshape(
                r[REC_H], r[REC_W]).astype(np.int32)
            plan.append(BlockRecord(
                plane=r[REC_PLANE], x=r[REC_X], y=r[REC_Y], size=r[REC_W],
                h=r[REC_H], mode=0, qp=0, levels=blk, kind="pcm"))
        else:
            size = r[REC_W]
            loff = r[REC_LVL]
            levels = None
            if loff >= 0:
                levels = lvl[loff:loff + size * size].reshape(
                    size, size).astype(np.int32)
            f = r[REC_FLAGS]
            obj = BlockRecord(
                plane=r[REC_PLANE], x=r[REC_X], y=r[REC_Y], size=size,
                mode=r[REC_MODE], qp=r[REC_QP], levels=levels,
                dst=bool(f & F_DST), ts=bool(f & F_TS), tqb=bool(f & F_TQB),
                kind="intra" if kind == KIND_INTRA else "resid",
                mtx=r[REC_MTX],
                rdpcm=2 if (f & F_RDPCM_V) else (1 if (f & F_RDPCM_H)
                                                 else 0),
                rot=bool(f & F_ROT), ccp=r[REC_CCP],
                ccp_ref=made[r[REC_CCPREF]] if r[REC_CCP] else None)
            made[ri] = obj
            plan.append(obj)


def plan_to_records(plan) -> tuple:
    """The inverse of ``records_to_plan``: BlockRecords (decode order) ->
    one native chunk ``(rec int32 [n, REC_NCOLS], lvl int16)``, the
    record stream the packer takes.  Serves pictures whose stage A ran in
    the Python syntax layer (dependent slice segments, no native build),
    so they go through the same pack and frame program."""
    rec = np.zeros((len(plan), REC_NCOLS), np.int32)
    pool, used = [], 0
    row_of = {}

    def put(levels):
        nonlocal used
        flat = np.asarray(levels).reshape(-1)
        pool.append(flat.astype(np.int16))
        used += flat.size
        return used - flat.size

    for i, b in enumerate(plan):
        r = rec[i]
        r[REC_PLANE], r[REC_X], r[REC_Y], r[REC_W] = b.plane, b.x, b.y, \
            b.size
        r[REC_H] = b.h or b.size
        if b.kind == "mc":
            r[REC_KIND] = KIND_MC
            r[REC_FLAGS] = (F_BI if b.bi else 0) | (F_LX if b.lx else 0)
            r[REC_MVX0], r[REC_MVY0] = b.mv
            r[REC_REF0] = b.ref_idx
            r[REC_MVX1], r[REC_MVY1] = b.mv1
            r[REC_REF1] = b.ref_idx1
            r[REC_WPW0:REC_LOG2WD + 1] = b.wp if b.wp is not None \
                else (0, 0, 0, 0, -1)
        elif b.kind == "pcm":
            r[REC_KIND] = KIND_PCM
            r[REC_LVL] = put(b.levels)
        else:
            r[REC_KIND] = KIND_INTRA if b.kind == "intra" else KIND_RESID
            r[REC_MODE], r[REC_QP], r[REC_MTX] = b.mode, b.qp, b.mtx
            r[REC_LVL] = -1 if b.levels is None else put(b.levels)
            r[REC_FLAGS] = ((F_DST if b.dst else 0) | (F_TS if b.ts else 0)
                            | (F_TQB if b.tqb else 0)
                            | (F_ROT if b.rot else 0)
                            | (F_RDPCM_H if b.rdpcm == 1 else 0)
                            | (F_RDPCM_V if b.rdpcm == 2 else 0))
            r[REC_CCP] = b.ccp
            if b.ccp:
                r[REC_CCPREF] = row_of[id(b.ccp_ref)]
            row_of[id(b)] = i
    lvl = np.concatenate(pool) if pool else np.zeros(0, np.int16)
    return rec, lvl


def sao_map_to_arrays(sao_map, sps) -> tuple:
    """The inverse of ``sao_arrays_to_map``: the Python syntax layer's
    per-CTB SaoParams -> the (type, band, offsets, eo_class) arrays the
    native stage A fills (``pic.sao_arrays``)."""
    ct = (3, sps.ctb_h, sps.ctb_w)
    t, b, e = (np.zeros(ct, np.int32) for _ in range(3))
    o = np.zeros(ct + (4,), np.int32)
    for (xc, yc), prm in sao_map.items():
        t[:, yc, xc] = prm.type_idx
        b[:, yc, xc] = prm.band_position
        o[:, yc, xc] = prm.offsets
        e[:, yc, xc] = prm.eo_class
    return t, b, o, e


def decode_slice_native(pic, sps, pps, sh, init_type: int, rbsp: bytes,
                        seg_starts, slice_idx: int, ref_list, ref_list_l1,
                        lt0, lt1, tmvp, cur_poc: int, chunk_slot=None,
                        n_threads=None, defer=False):
    """Full-native stage A for one slice segment chain.

    Appends BlockRecords to pic.plan, fills pic.sao_arrays, and updates
    the per-4x4 picture maps in place.  Returns the last decoded CTB
    address (raster scan).

    Slice-parallel mode (the analogue of the reference's PARALLEL_SLICE
    jobs, hevcdec.c:2909): defer=True returns a zero-argument callable
    that performs the native call — safe to run on a worker thread
    concurrently with other slices of the SAME picture (independent
    slices touch disjoint CTBs; record chunks land at `chunk_slot` in
    pic.native_chunks so tile-scan order is preserved).  The deferred
    form allocates private record buffers and uses `n_threads` workers
    inside the native call."""
    from ..cabac.ctx import TOTAL_CONTEXTS, init_context_states

    lib = _lib()
    P = NativeParams()
    slice_qp = pps.init_qp + sh.qp_delta
    P.width, P.height = sps.width, sps.height
    P.ctb_w, P.ctb_h = sps.ctb_w, sps.ctb_h
    P.h4, P.w4 = pic.h4, pic.w4
    P.log2_ctb = sps.log2_ctb_size
    P.log2_min_cb = sps.log2_min_cb_size
    P.log2_min_tb = sps.log2_min_tb_size
    P.log2_max_tb = sps.log2_max_tb_size
    P.max_tr_depth_intra = sps.max_transform_hierarchy_depth_intra
    P.max_tr_depth_inter = sps.max_transform_hierarchy_depth_inter
    P.chroma_fmt = sps.chroma_format_idc
    P.sub_w, P.sub_h = sps.sub_w, sps.sub_h
    P.bd_luma, P.bd_chroma = sps.bit_depth_luma, sps.bit_depth_chroma
    P.qp_bd_offset = sps.qp_bd_offset
    P.amp_enabled = int(sps.amp_enabled)
    P.pcm_enabled = int(sps.pcm_enabled)
    if sps.pcm_enabled:
        P.log2_min_pcm = sps.log2_min_pcm_cb_size
        P.log2_max_pcm = sps.log2_max_pcm_cb_size
        P.pcm_bd_luma = sps.pcm_bit_depth_luma
        P.pcm_bd_chroma = sps.pcm_bit_depth_chroma
        P.pcm_filter_disabled = int(sps.pcm_loop_filter_disabled)
    P.sao_enabled = int(sps.sao_enabled)
    P.slice_qp = slice_qp
    P.cu_qp_delta_enabled = int(pps.cu_qp_delta_enabled)
    P.diff_cu_qp_delta_depth = pps.diff_cu_qp_delta_depth
    P.tq_bypass_enabled = int(pps.transquant_bypass_enabled)
    P.ts_enabled = int(pps.transform_skip_enabled)
    P.log2_max_ts = pps.log2_max_transform_skip_block_size
    P.sdh = int(pps.sign_data_hiding)
    P.pps_cb_qp_offset = pps.cb_qp_offset
    P.pps_cr_qp_offset = pps.cr_qp_offset
    P.wpp = int(pps.entropy_coding_sync_enabled)
    P.tiles = int(pps.tiles_enabled)
    P.slice_type = sh.slice_type
    P.sao_luma, P.sao_chroma = int(sh.sao_luma), int(sh.sao_chroma)
    P.max_merge = sh.max_num_merge_cand()
    P.nref0 = sh.num_ref_idx_l0_active
    P.nref1 = sh.num_ref_idx_l1_active
    P.mvd_l1_zero = int(sh.mvd_l1_zero)
    P.slice_idx_val = slice_idx
    P.seg_addr = sh.segment_address
    P.sh_cb_qp_offset = sh.cb_qp_offset
    P.sh_cr_qp_offset = sh.cr_qp_offset
    P.n_segs = len(seg_starts)
    P.n_ctx = TOTAL_CONTEXTS
    # range-extension tools
    P.persistent_rice = int(sps.persistent_rice_adaptation)
    P.ts_context = int(sps.transform_skip_context)
    P.implicit_rdpcm = int(sps.implicit_rdpcm)
    P.explicit_rdpcm = int(sps.explicit_rdpcm)
    P.ts_rotation = int(sps.transform_skip_rotation)
    P.ccp_enabled = int(pps.cross_component_prediction_enabled)
    P.chroma_qp_offset_enabled = int(
        getattr(sh, "cu_chroma_qp_offset_enabled", 0))
    P.diff_cu_chroma_qp_offset_depth = \
        pps.diff_cu_chroma_qp_offset_depth
    P.n_chroma_offsets = len(pps.cb_qp_offset_list)
    cb_list = np.ascontiguousarray(
        (pps.cb_qp_offset_list or [0]), np.int32)
    cr_list = np.ascontiguousarray(
        (pps.cr_qp_offset_list or [0]), np.int32)

    # active scaling lists (mirror of SliceDecoder.__init__)
    scaling = None
    if sps.scaling_list_enabled:
        from ..coding.scaling import ScalingListData
        if pps.scaling_list_data_present:
            scaling = pps.scaling_list
        else:
            scaling = sps.scaling_list or ScalingListData()
    pic.scaling = scaling
    P.have_scaling = int(scaling is not None)

    # TMVP collocated arrays
    zero32 = np.zeros(2, np.int32)
    zero64 = np.zeros(1, np.int64)
    P.has_tmvp = int(tmvp is not None)
    if tmvp is not None:
        col = tmvp.col
        col_mv0 = np.ascontiguousarray(col["mv0"].reshape(-1), np.int32)
        col_poc0 = np.ascontiguousarray(col["poc0"].reshape(-1), np.int64)
        col_mv1 = np.ascontiguousarray(col["mv1"].reshape(-1), np.int32)
        col_poc1 = np.ascontiguousarray(col["poc1"].reshape(-1), np.int64)
        col_poc = int(col["poc"])
        P.no_backward = int(tmvp.no_backward)
        P.col_from_l0 = int(tmvp.col_from_l0)
    else:
        col_mv0 = col_mv1 = zero32
        col_poc0 = col_poc1 = zero64
        col_poc = 0

    # reference lists: poc + long-term flags
    def _list(refs, lts):
        n = max(1, len(refs))
        pocs = np.zeros(n, np.int64)
        lt = np.zeros(n, np.uint8)
        for i, (poc, _pl) in enumerate(refs):
            pocs[i] = poc
        for i, v in enumerate(lts or ()):
            lt[i] = int(bool(v))
        return pocs, lt

    pocs0, lts0 = _list(ref_list, lt0)
    pocs1, lts1 = _list(ref_list_l1, lt1)

    wp_w, wp_o, log2wd_l, log2wd_c = _wp_tables(sh, sps)
    P.has_wp = int(sh.weight_table is not None)
    P.wp_log2wd_luma = log2wd_l
    P.wp_log2wd_chroma = log2wd_c

    # SAO parameter maps, shared across the picture's slices
    if getattr(pic, "sao_arrays", None) is None:
        ct = (3, sps.ctb_h, sps.ctb_w)
        pic.sao_arrays = (np.zeros(ct, np.int32), np.zeros(ct, np.int32),
                          np.zeros(ct + (4,), np.int32),
                          np.zeros(ct, np.int32))
    sao_t, sao_b, sao_o, sao_e = pic.sao_arrays
    if sps.sao_enabled and (sh.sao_luma or sh.sao_chroma):
        pic.has_sao = True

    fresh = np.array(init_context_states(init_type, slice_qp), np.uint8)
    ctx = fresh.copy()
    stat = np.zeros(4, np.int32)
    scans, scan_off = _scan_bank()
    tabs = _pps_tables(pps)
    if defer:
        # private buffers: the shared geometry-keyed cache would race
        # across concurrent slice jobs
        n44 = pic.w4 * pic.h4
        cfrac = {0: 0, 1: 8, 2: 16, 3: 32}[sps.chroma_format_idc]
        rec = np.empty((4 * n44 + 1024, REC_NCOLS), np.int32)
        lvl = np.empty(16 * n44 + cfrac * n44 + 4096, np.int16)
    else:
        rec, lvl = _buffers(pic.w4, pic.h4, sps.chroma_format_idc)
    out_counts = np.zeros(4, np.int64)
    segs = np.ascontiguousarray(seg_starts, np.int64)
    threads = n_threads if n_threads else stagea_threads()

    def run():
        rc = lib.hevc_native_decode_slice(
            rbsp, len(rbsp), segs, C.byref(P),
            fresh, ctx, stat, _full_ctx_offsets(), scans, scan_off,
            tabs[0], tabs[1], tabs[2], tabs[3],
            pic.intra_mode_y, pic.is_intra.view(np.uint8), pic.ct_depth,
            pic.skip_flag.view(np.uint8), pic.qp_y, pic.slice_idx,
            pic.tq_bypass.view(np.uint8), pic.no_filter.view(np.uint8),
            pic.edge_v.view(np.uint8), pic.edge_h.view(np.uint8),
            pic.tu_edge_v.view(np.uint8), pic.tu_edge_h.view(np.uint8),
            pic.cbf_luma.view(np.uint8),
            pic.mv_l0.reshape(-1), pic.ref_l0,
            pic.ref_poc_l0.reshape(-1),
            pic.mv_l1.reshape(-1), pic.ref_l1,
            pic.ref_poc_l1.reshape(-1),
            pic.z_order.reshape(-1),
            pocs0, lts0, pocs1, lts1,
            col_mv0, col_poc0, col_mv1, col_poc1, col_poc, cur_poc,
            wp_w.reshape(-1), wp_o.reshape(-1),
            sao_t.reshape(-1), sao_b.reshape(-1), sao_o.reshape(-1),
            sao_e.reshape(-1), cb_list, cr_list,
            rec.reshape(-1), rec.shape[0], lvl, lvl.shape[0],
            threads, out_counts)
        if rc != 0:
            raise RuntimeError(f"native slice decode failed (rc={rc})")
        n_rec, lvl_used, last_rs = (int(out_counts[0]),
                                    int(out_counts[1]),
                                    int(out_counts[2]))
        # copy out the used slices so cached buffers can be reused
        rec_out = rec[:n_rec].copy()
        lvl_out = lvl[:lvl_used].copy()
        chunks = getattr(pic, "native_chunks", None)
        if chunks is not None:
            # fast path: raw record chunks straight into the packer
            if chunk_slot is None:
                chunks.append((rec_out, lvl_out))
            else:
                chunks[chunk_slot] = (rec_out, lvl_out)
        else:
            records_to_plan(rec_out, lvl_out, pic.plan)
        return last_rs

    if defer:
        return run
    return run()


def sao_arrays_to_map(pic) -> dict:
    """Convert native SAO parameter arrays into the Python sao_map shape
    (dict of (xc, yc) -> SaoParams) for the NumPy filter path."""
    from ..ops.sao import SaoParams
    t, b, o, e = pic.sao_arrays
    out = {}
    ys, xs = np.nonzero(t.any(axis=0))
    for yc, xc in zip(ys.tolist(), xs.tolist()):
        prm = SaoParams()
        for c in range(3):
            prm.type_idx[c] = int(t[c, yc, xc])
            prm.band_position[c] = int(b[c, yc, xc])
            prm.offsets[c] = o[c, yc, xc].tolist()
            prm.eo_class[c] = int(e[c, yc, xc])
        out[(xc, yc)] = prm
    return out


# ---------------------------------------------------------------------------
# Native packer: record stream -> PackedFrame arrays
# ---------------------------------------------------------------------------

class PackParams(C.Structure):
    """Mirror of stage_a_pack.h `struct PackP` (field order must match)."""
    _fields_ = [(n, C.c_int32) for n in (
        "width", "height", "sub_w", "sub_h", "h4", "w4",
        "log2_ctb", "ctb_w", "ctb_h",
        "chroma444", "smoothing_disabled", "strong_smoothing",
        "nrefs", "r0", "pad_ref", "tile_mc",
    )] + [("reg", C.c_int32 * 12)]


@lru_cache(maxsize=1)
def _pack_fn():
    lib = _lib()
    fn = lib.hevc_native_pack_records
    fn.restype = C.c_int64
    fn.argtypes = [
        _I32P, C.c_int64, C.POINTER(PackParams),
        _I64P, _I32P, _I32P,                  # z_order, slice_idx, tiles
        _I32P, _U8P, _I32P, _I32P, _I32P, _I32P,  # imeta..pcmrow
        _I64P,                                # out_counts
    ]
    return fn


@lru_cache(maxsize=1)
def _gather_levels_fn():
    lib = _lib()
    fn = lib.hevc_native_gather_levels
    fn.restype = None
    fn.argtypes = [_I16P, _I32P, C.c_int64,
                   _I32P, _I32P, _I32P, _I32P,   # rmeta per class
                   _I16P, _I16P, _I16P, _I16P]   # int16 levels per class
    return fn


def _concat_chunks(chunks):
    """Concatenate per-slice (rec, lvl) chunks, rebasing level offsets
    and CCP record-index references."""
    if len(chunks) == 1:
        return chunks[0]
    recs, lvls = [], []
    base = 0
    row_base = 0
    for rec, lvl in chunks:
        if base or row_base:
            rec = rec.copy()
            mask = rec[:, REC_LVL] >= 0
            rec[mask, REC_LVL] += base
            ccp = rec[:, REC_CCP] != 0
            rec[ccp, REC_CCPREF] += row_base
        recs.append(rec)
        lvls.append(lvl)
        base += lvl.shape[0]
        row_base += rec.shape[0]
    return np.concatenate(recs), np.concatenate(lvls)


def _scale_bank(pic):
    """Per-class scaling-matrix banks (slot 0 = flat 16), cached on the
    active ScalingListData."""
    scaling = getattr(pic, "scaling", None)
    if scaling is not None:
        bank = getattr(scaling, "_native_bank", None)
        if bank is not None:
            return bank
    bank = []
    for c in range(4):
        s_sz = 4 << c
        b = np.full((7, s_sz, s_sz), 16, np.int32)
        if scaling is not None:
            for mid in range(6):
                b[mid + 1] = scaling.factor(c + 2, mid)[0]
        bank.append(b)
    bank = tuple(bank)
    if scaling is not None:
        scaling._native_bank = bank
    return bank


def pack_frame_native(pic):
    """PackedFrame from the native record stream (pic.native_chunks) —
    bit-identical to tpu.pack.pack_frame on the equivalent BlockRecord
    plan (tests/test_native_pack.py)."""
    from ..pack import (DUMP, PAD_REF, PackedFrame, _pow2_at_least,
                        _round_up, region_offsets)
    sps = pic.sps
    reg, chh, cww = region_offsets(sps)
    rec, lvl = _concat_chunks(pic.native_chunks)
    n_rec = rec.shape[0]
    refs0 = getattr(pic, "ref_list_l0", []) or []
    refs1 = getattr(pic, "ref_list_l1", []) or []
    refs = list(refs0) + list(refs1)

    P = PackParams()
    P.width, P.height = sps.width, sps.height
    P.sub_w, P.sub_h = sps.sub_w, sps.sub_h
    P.h4, P.w4 = pic.h4, pic.w4
    P.log2_ctb = sps.log2_ctb_size
    P.ctb_w, P.ctb_h = sps.ctb_w, sps.ctb_h
    P.chroma444 = int(sps.chroma_format_idc == 3)
    P.smoothing_disabled = int(sps.intra_smoothing_disabled)
    P.strong_smoothing = int(sps.strong_intra_smoothing)
    P.nrefs, P.r0 = len(refs), len(refs0)
    P.pad_ref = PAD_REF
    P.tile_mc = 0  # untiled rows: mirrors pack_frame's per-PU grouping
    for p in range(3):
        for k in range(4):
            P.reg[p * 4 + k] = reg[p][k]

    imeta = np.empty((max(1, n_rec), 11), np.int32)
    iavail = np.zeros((max(1, n_rec), 128), np.uint8)
    lmeta = np.empty((max(1, n_rec), 11), np.int32)
    mcrow = np.empty((max(1, n_rec), 21), np.int32)
    residr = np.empty((max(1, n_rec), 4), np.int32)
    pcmrow = np.empty((max(1, n_rec), 6), np.int32)
    counts = np.zeros(8, np.int64)
    tabs = _pps_tables(pic.pps)
    rc = _pack_fn()(
        np.ascontiguousarray(rec).reshape(-1), n_rec, C.byref(P),
        pic.z_order.reshape(-1), pic.slice_idx.reshape(-1), tabs[3],
        imeta.reshape(-1), iavail.reshape(-1), lmeta.reshape(-1),
        mcrow.reshape(-1), residr.reshape(-1), pcmrow.reshape(-1), counts)
    if rc != 0:
        raise RuntimeError(f"native pack failed (rc={rc})")
    ni, nl, nm, nr, npcm, n_chunks_raw = (int(v) for v in counts[:6])

    canvas = np.zeros((chh, cww), np.int32)
    for plane, cy, cx, w, h, off in pcmrow[:npcm].tolist():
        canvas[cy:cy + h, cx:cx + w] = lvl[off:off + w * h].reshape(h, w)

    # per-class per-chunk scatter of prediction metadata
    n_chunks = _round_up(max(1, n_chunks_raw), 16)
    im = imeta[:ni]
    iv = iavail[:ni]
    cls_i = im[:, 0]
    scal, avail = [], []
    for c in range(4):
        sel = np.nonzero(cls_i == c)[0]
        cnt = int(im[sel, 2].max()) + 1 if sel.size else 0
        B = _pow2_at_least(cnt) if cnt else 0
        a = np.zeros((n_chunks, B, 8), np.int32)
        a[:, :, 0] = DUMP
        a[:, :, 1] = DUMP
        a[:, :, 2] = 1
        v = np.zeros((n_chunks, B, 128), bool)
        if sel.size:
            a[im[sel, 1], im[sel, 2]] = im[sel, 3:11]
            v[im[sel, 1], im[sel, 2]] = iv[sel].astype(bool)
        scal.append(a)
        avail.append(v)

    # per-class residual pools (slot order == emission order)
    lm = lmeta[:nl]
    levels, rmetas = [], []
    for c, s in enumerate((4, 8, 16, 32)):
        sel = np.nonzero(lm[:, 0] == c)[0]
        nlv = _round_up(len(sel) + 1, 16)
        arr = np.zeros((nlv, s, s), np.int32)
        rm = np.zeros((nlv, 9), np.int32)
        if sel.size:
            offs = lm[sel, 1].astype(np.int64)
            vals = lvl[np.maximum(offs[:, None], 0)
                       + np.arange(s * s)[None, :]].reshape(-1, s, s)
            vals[offs < 0] = 0  # CCP-only rows: zero-level slot
            arr[:len(sel)] = vals
            rm[:len(sel)] = lm[sel, 2:11]
        levels.append(arr)
        rmetas.append(rm)

    # MC groups keyed (is_chroma, bi, w, h, wp), stable within groups
    mcr = mcrow[:nm]
    mc_groups = []
    if nm:
        wp_col = (mcr[:, 20] >= 0).astype(np.int32)
        order = np.lexsort((wp_col, mcr[:, 3], mcr[:, 2], mcr[:, 1],
                            mcr[:, 0]))
        srt = mcr[order]
        keys = np.column_stack([srt[:, :4], wp_col[order]])
        bounds = [0] + (np.nonzero(np.any(np.diff(keys, axis=0) != 0,
                                          axis=1))[0] + 1).tolist() \
            + [nm]
        for a, b in zip(bounds[:-1], bounds[1:]):
            is_ch, bi, w, h, wp = (int(v) for v in keys[a])
            cols = list(range(4, 14)) + [14, 15] if bi \
                else [4, 5, 6, 7, 8, 14, 15]
            if wp:
                cols += [16, 17, 18, 19, 20]
            mc_groups.append((bool(is_ch), bool(bi), w, h, bool(wp),
                              np.ascontiguousarray(srt[a:b][:, cols])))
    mc_groups = tuple(mc_groups)

    rr = residr[:nr]
    resid_groups = tuple(
        np.ascontiguousarray(rr[rr[:, 0] == c][:, 1:4])
        if (rr[:, 0] == c).any() else np.zeros((0, 3), np.int32)
        for c in range(4))

    if refs:
        pad = ((PAD_REF, PAD_REF), (PAD_REF, PAD_REF))
        refs_l = np.stack([np.pad(pl[0], pad, mode="edge")
                           for _, pl in refs]).astype(np.int32)
        refs_c = np.stack(
            [np.pad(pl[1], pad, mode="edge") for _, pl in refs]
            + [np.pad(pl[2], pad, mode="edge") for _, pl in refs]
        ).astype(np.int32)
        for is_ch, bi, w, h, _wp, fields in mc_groups:
            hp, wp_ = (refs_c.shape[1:] if is_ch else refs_l.shape[1:])
            ext = (3 if is_ch else 7)
            assert ((fields[:, 1] + h + ext <= hp).all()
                    and (fields[:, 2] + w + ext <= wp_).all()), \
                "MV exceeds PAD_REF"
            if bi:
                assert ((fields[:, 6] + h + ext <= hp).all()
                        and (fields[:, 7] + w + ext <= wp_).all()), \
                    "MV exceeds PAD_REF"
    else:
        refs_l = np.zeros((1, 8, 8), np.int32)
        refs_c = np.zeros((1, 8, 8), np.int32)

    return PackedFrame(canvas=canvas, scal=tuple(scal), avail=tuple(avail),
                       levels=tuple(levels), rmeta=tuple(rmetas),
                       n_chunks=n_chunks, region=reg,
                       bit_depth=sps.bit_depth_luma,
                       mc_groups=mc_groups, resid_groups=resid_groups,
                       refs_l=refs_l, refs_c=refs_c,
                       scale_bank=_scale_bank(pic))


@lru_cache(maxsize=1)
def _bs_fn():
    lib = _lib()
    fn = lib.hevc_native_compute_bs
    fn.restype = None
    fn.argtypes = [C.c_int32, C.c_int32,
                   _U8P, _U8P, _U8P, _U8P, _U8P, _U8P,
                   _I32P, _I64P, _I32P, _I64P, _I8P, _I8P]
    return fn


def compute_bs_native(pic) -> None:
    """Fill pic.bs_v/bs_h from the per-4x4 maps (C++ path; bit-identical
    to PictureState.compute_bs_numpy)."""
    _bs_fn()(pic.h4, pic.w4,
             pic.is_intra.view(np.uint8), pic.cbf_luma.view(np.uint8),
             pic.edge_v.view(np.uint8), pic.edge_h.view(np.uint8),
             pic.tu_edge_v.view(np.uint8), pic.tu_edge_h.view(np.uint8),
             pic.mv_l0.reshape(-1), pic.ref_poc_l0.reshape(-1),
             pic.mv_l1.reshape(-1), pic.ref_poc_l1.reshape(-1),
             pic.bs_v.reshape(-1), pic.bs_h.reshape(-1))
