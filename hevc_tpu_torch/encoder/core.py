"""Intra HEVC encoder — the framework's bitstream generator.

The reference decoder ships no encoder; we need one to create conformant
test/benchmark streams that the openHEVC oracle binary can cross-check
(decoded-picture-hash SEI → "Correct MD5").  The encoder reuses the same
PictureState/ops as the decoder, so its reconstruction is by construction
the decode result; the embedded MD5 makes any drift observable.

Forward transform + quantization follow the HM informative design
(quantScales, qbits = 29 + qp/6 − bitDepth − log2TrafoSize).

The CU/TU decision policies ("fixed", "variance", "random") exist to
exercise every decoder path (quadtree depths, NxN partitions, TU splits,
4x4 DST + mode-dependent scans) against the oracle, not to win rate-
distortion contests.

Copied from ``hevc_tpu/encoder/core.py`` at e99b487.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..bitstream import nal as nalmod
from ..bitstream.ps import PPS, SPS, VPS
from ..bitstream.sei import (SEI_TYPE_DECODED_PICTURE_HASH,
                             DecodedPictureHash, picture_md5, write_sei_rbsp)
from ..bitstream.slice import SLICE_I, SliceHeader
from ..cabac.ctx import ContextModel
from ..cabac.engine import CabacEncoder
from ..coding.picture import PictureState, crop_conf_win, mpm_list
from ..coding.residual import encode_residual
from ..coding.scans import scan_idx_for_intra
from ..ops import reference as R

QUANT_SCALES = (26214, 23302, 20560, 18396, 16384, 14564)


def forward_transform(res: np.ndarray, bit_depth: int,
                      dst: bool = False) -> np.ndarray:
    """Forward integer transform (HM informative): res[n,n] → coeff[n,n]."""
    n = res.shape[0]
    log2 = int(np.log2(n))
    T = R.DST4 if dst else R.dct_matrix(n)
    s1 = log2 + bit_depth - 9
    s2 = log2 + 6
    tmp = (T.astype(np.int64) @ res.astype(np.int64)
           + (1 << (s1 - 1))) >> s1
    out = (tmp @ T.T.astype(np.int64) + (1 << (s2 - 1))) >> s2
    return out.astype(np.int64)


def quantize(coef: np.ndarray, qp: int, log2_size: int, bit_depth: int,
             intra: bool = True) -> np.ndarray:
    qbits = 29 + qp // 6 - bit_depth - log2_size
    scale = QUANT_SCALES[qp % 6]
    offset = (171 if intra else 85) << (qbits - 9)
    mag = (np.abs(coef.astype(np.int64)) * scale + offset) >> qbits
    lv = np.sign(coef) * mag
    return np.clip(lv, -32768, 32767).astype(np.int32)


@dataclass
class EncoderConfig:
    width: int = 416
    height: int = 240
    qp: int = 32
    log2_ctb_size: int = 4
    log2_min_cb_size: int = 3
    bit_depth: int = 8
    # bit depth of the planes handed to encode_frame; 0 = bit_depth.  A
    # lower depth is shifted up to bit_depth before coding (an 8-bit
    # master carried in a 10-bit chain); the variance policy's threshold
    # is scaled with it
    source_bit_depth: int = 0
    chroma_format_idc: int = 1
    log2_cu_size: int = 4  # target CU size for the "fixed" policy
    candidate_modes: tuple = (R.INTRA_PLANAR, R.INTRA_DC, 10, 26, 2, 18, 34)
    sei_hash: bool = True
    # side-data SEIs to emit in the first AU: tuple of (payload_type, msg)
    # where msg has .payload() (see bitstream/sei.py dataclasses)
    sei_side_data: tuple = ()
    deblocking: bool = False  # in-loop deblocking (decoder filter stage)
    sao: bool = False  # emit random SAO params (exercises the SAO stage)
    transform_skip: bool = False  # use transform_skip on some 4x4 TUs
    # structure policies: "fixed" | "variance" | "random"
    split_policy: str = "fixed"
    max_transform_hierarchy_depth_intra: int = 0
    nxn_probability: float = 0.5   # random policy: NxN at min CB
    tu_split_probability: float = 0.5
    seed: int = 0
    full_mode_search: bool = False  # search all 35 intra modes
    # parallel entropy structures
    wpp: bool = False            # entropy_coding_sync (one segment per row)
    tiles: tuple = ()            # (num_cols, num_rows) uniform tiles
    # inter coding
    gop: str = "all_intra"  # "all_intra"|"ipp"|"lowb"|"ra" (hierarchical B)
    search_range: int = 4   # integer-pel motion search radius
    p_intra_fallback: bool = True  # allow intra CUs inside P frames
    tmvp: bool = False      # temporal MV prediction
    # scaling lists (quantization matrices): None = off, "default" =
    # signal scaling_list_enabled with the Table 7-5/7-6 defaults,
    # "custom" = emit explicit matrices in the SPS
    scaling_lists: object = None
    # gop="ra": code non-first anchors as CRA_NUT with the in-between Bs
    # as RASL leading pictures (true random-access points; the decoder's
    # max_ra logic drops the RASLs when decode starts at the CRA)
    cra_anchors: bool = False
    tmvp_col_ref_idx: int = 0  # collocated_ref_idx (L0)
    weighted_pred: bool = False  # explicit weighted prediction (P + B)
    # PCM coding units: None = off, "all" = every eligible CU, float =
    # per-CU probability.  pcm_bit_depth 0 = same as bit_depth (exercises
    # the raw-sample path; a smaller value exercises the shift).
    pcm: object = None
    pcm_bit_depth: int = 0
    pcm_loop_filter_disabled: bool = False
    # per-CU QP: -1 = off, else diff_cu_qp_delta_depth (0 = one QG per
    # CTB).  When on, the target QP varies deterministically per QG in
    # [qp-3, qp+3] and the delta is signalled via cu_qp_delta.
    cu_qp_delta_depth: int = -1
    # asymmetric motion partitions: None = off, float = per-CU
    # probability, "all" = every eligible inter CU.  Requires
    # log2_ctb_size <= 5 (single CU-sized TU).
    amp: object = None
    # long-term reference picture (ipp/lowb): keep frame 0 as an LT ref
    # in every P frame's L0 — exercises the LT RPS syntax and the
    # no-MV-scaling long-term rules.  "mod" additionally signals
    # ref_pic_lists_modification and swaps the two L0 entries.
    long_term_ref: object = None  # None | True | "mod"
    # ---- range-extension tools (SPS/PPS rext flags + emission) ----
    rext_persistent_rice: bool = False   # StatCoeff Rice adaptation
    rext_ts_context: bool = False        # skip-block sig contexts
    rext_ts_rotation: bool = False       # 4x4 skip 180° rotation
    rext_implicit_rdpcm: bool = False    # intra hor/ver skip DPCM
    # cu_chroma_qp_offset: tuple of (cb, cr) PPS offset pairs; the
    # encoder cycles through them per CTB (chroma QG)
    rext_chroma_qp_offsets: tuple = ()
    # explicit RDPCM: inter CUs code their (CU-sized) TU with
    # transform_skip + DPCM diffs; raises log2_max_transform_skip to 5
    rext_explicit_rdpcm: bool = False
    # cross-component prediction (4:4:4 only): chroma residuals coded
    # against an alpha-scaled copy of the TU's luma residual
    rext_ccp: bool = False
    # dependent slice segments: N extra segments per picture (split at
    # CTB-row bounds); contexts/QP state continue across segments
    dependent_slices: int = 0
    # independent multi-slice pictures: N slices split at CTB-row
    # bounds (or whole-tile runs when tiles are on); CABAC/QP state
    # restarts per slice and intra prediction never crosses a slice
    # (reference: tab_slice_address semantics, hevcdec.c:2822-2840)
    slices: int = 1
    # per-slice filter overrides: tuple of dicts with any of
    # beta_offset, tc_offset (even values), disable (deblock off for
    # the slice), sao_luma, sao_chroma, lf_across (the slice's
    # slice_loop_filter_across_slices_enabled_flag).  Shorter tuples
    # cycle.  Non-empty enables pps deblocking_filter_override.
    slice_filter_params: tuple = ()
    # pps_loop_filter_across_tiles_enabled_flag (tiles only): 0 turns
    # off deblock/SAO across tile boundaries
    lf_across_tiles: bool = True


class _TuPlan:
    """One planned transform-tree node."""
    __slots__ = ("x0", "y0", "log2", "depth", "blk_idx", "split", "children",
                 "lv_y", "cbf_luma", "lv_cb", "lv_cr", "cbf_cb", "cbf_cr",
                 "chroma_leaf", "ts", "rdpcm", "rot", "ccp_alpha", "ccp_ry")

    def __init__(self, x0, y0, log2, depth, blk_idx):
        self.x0, self.y0, self.log2 = x0, y0, log2
        self.depth, self.blk_idx = depth, blk_idx
        self.split = False
        self.children: List[_TuPlan] = []
        self.lv_y = None
        self.cbf_luma = 0
        self.rdpcm = 0       # 0 none / 1 hor / 2 ver (implicit, luma)
        self.rot = False     # 4x4 skip rotation active for lv_y
        self.ccp_alpha = (0, 0)  # cross-component res_scale per cb/cr
        self.ccp_ry = None       # the TU's reconstructed luma residual
        self.lv_cb = []      # per chroma TB (2 for 4:2:2)
        self.lv_cr = []
        self.cbf_cb = (0, 0)
        self.cbf_cr = (0, 0)
        self.chroma_leaf = False
        self.ts = False


class IntraEncoder:
    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
        # pic_width/height_in_luma_samples must be min-CB multiples;
        # arbitrary sizes are padded and signalled via the conformance
        # window (reference: hevc_ps.c conf_win, output crop
        # openhevc.c:662-740 oh_output_cropped_cpy)
        mcb = 1 << cfg.log2_min_cb_size
        self.out_w, self.out_h = cfg.width, cfg.height
        pad_w, pad_h = -cfg.width % mcb, -cfg.height % mcb
        coded_w, coded_h = cfg.width + pad_w, cfg.height + pad_h
        sub_w = 2 if cfg.chroma_format_idc in (1, 2) else 1
        sub_h = 2 if cfg.chroma_format_idc == 1 else 1
        assert pad_w % sub_w == 0 and pad_h % sub_h == 0, \
            "pad must be a chroma-unit multiple"
        self.vps = VPS()
        self.sps = SPS(
            width=coded_w, height=coded_h,
            conf_win=(0, pad_w // sub_w, 0, pad_h // sub_h),
            bit_depth_luma=cfg.bit_depth, bit_depth_chroma=cfg.bit_depth,
            chroma_format_idc=cfg.chroma_format_idc,
            log2_min_cb_size=cfg.log2_min_cb_size,
            log2_ctb_size=cfg.log2_ctb_size,
            log2_min_tb_size=2,
            log2_max_tb_size=min(5, cfg.log2_ctb_size),
            max_transform_hierarchy_depth_intra=(
                cfg.max_transform_hierarchy_depth_intra),
            sao_enabled=1 if cfg.sao else 0,
            temporal_mvp_enabled=1 if cfg.tmvp else 0,
        ).derive()
        if cfg.amp:
            assert cfg.log2_ctb_size <= 5, \
                "amp requires CU-sized TUs (log2_ctb_size <= 5)"
            self.sps.amp_enabled = 1
            # depth 1 so AMP CUs keep a single CU-sized TU (no forced
            # interSplit) — the flag is then coded and we emit 0
            self.sps.max_transform_hierarchy_depth_inter = 1
        if cfg.pcm:
            pbd = cfg.pcm_bit_depth or cfg.bit_depth
            self.sps.pcm_enabled = 1
            self.sps.pcm_bit_depth_luma = pbd
            self.sps.pcm_bit_depth_chroma = pbd
            self.sps.log2_min_pcm_cb_size = max(3, cfg.log2_min_cb_size)
            self.sps.log2_max_pcm_cb_size = min(5, cfg.log2_ctb_size)
            self.sps.pcm_loop_filter_disabled = \
                1 if cfg.pcm_loop_filter_disabled else 0
        if cfg.bit_depth == 10:
            self.sps.ptl.profile_idc = 2  # Main 10
            self.sps.ptl.compat_flags = (1 << 30) | (1 << 29)
        if cfg.chroma_format_idc != 1:
            self.sps.ptl.profile_idc = 4  # Range extensions
            self.sps.ptl.compat_flags = 1 << (31 - 4)
        self.pps = PPS(
            init_qp=cfg.qp,
            weighted_pred=1 if cfg.weighted_pred else 0,
            weighted_bipred=1 if cfg.weighted_pred else 0,
            transform_skip_enabled=1 if cfg.transform_skip else 0,
            deblocking_filter_control_present=0 if cfg.deblocking else 1,
            deblocking_filter_disabled=0 if cfg.deblocking else 1,
            cu_qp_delta_enabled=1 if cfg.cu_qp_delta_depth >= 0 else 0,
            diff_cu_qp_delta_depth=max(0, cfg.cu_qp_delta_depth),
            entropy_coding_sync_enabled=1 if cfg.wpp else 0,
            tiles_enabled=1 if cfg.tiles else 0,
            num_tile_columns=cfg.tiles[0] if cfg.tiles else 1,
            num_tile_rows=cfg.tiles[1] if cfg.tiles else 1,
            loop_filter_across_tiles=1 if cfg.lf_across_tiles else 0,
            dependent_slice_segments_enabled=1 if cfg.dependent_slices
            else 0,
        ).derive(self.sps)
        if cfg.tiles:
            assert cfg.tiles[0] <= self.sps.ctb_w \
                    and cfg.tiles[1] <= self.sps.ctb_h, \
                "tile grid exceeds the picture's CTB grid (found by the " \
                "fuzz matrix: degenerate tiles decode asymmetrically)"
        if cfg.slices > 1:
            if cfg.tiles:
                assert (cfg.tiles[0] * cfg.tiles[1]) % cfg.slices == 0, \
                    "multi-slice + tiles: slices must be whole-tile runs"
            if cfg.slice_filter_params:
                # per-slice deblock overrides travel in slice headers
                self.pps.deblocking_filter_control_present = 1
                self.pps.deblocking_filter_override_enabled = 1
            # pps_loop_filter_across_slices_enabled: slice headers
            # carry the per-slice flag
            self.pps.loop_filter_across_slices = 1
        if (cfg.rext_persistent_rice or cfg.rext_ts_context
                or cfg.rext_ts_rotation or cfg.rext_implicit_rdpcm
                or cfg.rext_explicit_rdpcm):
            self.sps.range_ext = 1
            self.sps.persistent_rice_adaptation = \
                int(cfg.rext_persistent_rice)
            self.sps.transform_skip_context = int(cfg.rext_ts_context)
            self.sps.transform_skip_rotation = int(cfg.rext_ts_rotation)
            self.sps.implicit_rdpcm = int(cfg.rext_implicit_rdpcm)
            self.sps.explicit_rdpcm = int(cfg.rext_explicit_rdpcm)
            self.sps.ptl.profile_idc = 4  # Range extensions
            self.sps.ptl.compat_flags = 1 << (31 - 4)
            assert not (cfg.rext_ts_rotation and cfg.scaling_lists), \
                "ts rotation + scaling lists: matrix applies pre-rotation"
        if cfg.rext_explicit_rdpcm:
            # CU-sized inter TUs skip the transform: allow big TS blocks
            self.pps.range_ext = 1
            self.pps.transform_skip_enabled = 1
            self.pps.log2_max_transform_skip_block_size = 5
            assert cfg.log2_ctb_size <= 5, \
                "explicit rdpcm: CU-sized TS TUs need log2_ctb <= 5"
        if cfg.rext_ccp:
            assert cfg.chroma_format_idc == 3, "CCP is 4:4:4 only"
            self.pps.range_ext = 1
            self.pps.cross_component_prediction_enabled = 1
            self.sps.ptl.profile_idc = 4
            self.sps.ptl.compat_flags = 1 << (31 - 4)
        if cfg.rext_chroma_qp_offsets:
            self.pps.range_ext = 1
            self.pps.chroma_qp_offset_list_enabled = 1
            self.pps.diff_cu_chroma_qp_offset_depth = 0
            self.pps.cb_qp_offset_list = \
                [cb for cb, _cr in cfg.rext_chroma_qp_offsets]
            self.pps.cr_qp_offset_list = \
                [cr for _cb, cr in cfg.rext_chroma_qp_offsets]
            # PPS rext parse is gated on the rext profile (reference:
            # hevc_ps.c:3155 profile_idc == FF_PROFILE_HEVC_REXT)
            self.sps.ptl.profile_idc = 4
            self.sps.ptl.compat_flags = 1 << (31 - 4)
        self.scaling = None
        if cfg.scaling_lists:
            from ..coding.scaling import ScalingListData
            self.scaling = ScalingListData()
            self.sps.scaling_list_enabled = 1
            if cfg.scaling_lists == "custom":
                # deterministic non-default matrices exercising every
                # size class + separate DC scales
                for sz in range(4):
                    n = 16 if sz == 0 else 64
                    w = 4 if sz == 0 else 8
                    for mid in range(6):
                        base = 16 + ((mid * 5) % 7)
                        row = np.arange(n, dtype=np.int32)
                        self.scaling.sl[sz][mid] = \
                            base + (row // w + row % w + mid) % 9
                self.scaling.sl_dc[:] = \
                    16 + (np.arange(12, dtype=np.int32) % 5).reshape(2, 6)
                self.scaling.remap_444()
                self.sps.scaling_list = self.scaling
        if cfg.gop in ("ipp", "lowb"):
            from ..bitstream.ps import ShortTermRPS
            self.sps.st_rps = [ShortTermRPS(delta_poc_s0=[-1], used_s0=[1])]
            if cfg.long_term_ref:
                self.sps.long_term_ref_pics_present = 1
                self.pps.lists_modification_present = \
                    1 if cfg.long_term_ref == "mod" else 0
        elif cfg.gop == "ra":
            from ..bitstream.ps import ShortTermRPS
            # one RPS per mini-GOP position (+ a {-1} for flush tails);
            # unused entries keep future anchors alive in the DPB
            self.sps.st_rps = [
                ShortTermRPS(delta_poc_s0=[-4], used_s0=[1]),
                ShortTermRPS(delta_poc_s0=[-2], used_s0=[1],
                             delta_poc_s1=[2], used_s1=[1]),
                ShortTermRPS(delta_poc_s0=[-1], used_s0=[1],
                             delta_poc_s1=[1, 3], used_s1=[1, 0]),
                ShortTermRPS(delta_poc_s0=[-1], used_s0=[1],
                             delta_poc_s1=[1], used_s1=[1]),
                ShortTermRPS(delta_poc_s0=[-1], used_s0=[1]),
            ]
            if cfg.cra_anchors:
                # CRA anchor RPS: keep the previous anchor alive for the
                # RASL leading pictures without referencing it (used=0 ->
                # an ST_FOLL entry in the reference's rps terms)
                self.sps.st_rps.append(
                    ShortTermRPS(delta_poc_s0=[-4], used_s0=[0]))
            # three temporal sublayers: tid0 = I/P anchors, tid1 = the
            # mid B, tid2 = leaf Bs (droppable TRAIL_N); per-sublayer
            # DPB ordering info (reference: temporal-layer-id AVOption
            # hevcdec.c:4642-4668, oh_select_temporal_layer)
            for ps in (self.sps, self.vps):
                ps.max_sub_layers = 3
                ps.num_reorder_pics = [0, 1, 2]
                ps.max_dec_pic_buffering = [2, 3, 5]
                ps.max_latency_increase = [0, 0, 0]
        # decode-order schedule override for out-of-order GOPs:
        # (poc, "I"|"P"|"B", rps_idx, ref_pocs_l0, ref_pocs_l1,
        #  temporal_id, nal_type_override)
        self._sched = None
        self._temporal_id = 0
        self.frames_encoded = 0
        self.rng = np.random.default_rng(cfg.seed)
        self.dpb: List = []  # [(poc, [int32 planes])]
        self.dpb_motion = {}
        self.poc = 0
        # SHVC hooks (overridden by the EL encoder, encoder/shvc.py)
        self.layer_id = 0
        self.include_headers_in_first_au = True

    def _deq(self, lv, qp, log2, bd, c_idx, is_inter, ts=False):
        """Dequant honouring the active scaling lists (8.6.3 gating as in
        the decoder / reference hevc_cabac.c:1487)."""
        if self.scaling is None or (ts and log2 > 2):
            return R.dequant(lv, qp, log2, bd)
        from ..coding.scaling import matrix_id_for
        m, dc = self.scaling.factor(log2, matrix_id_for(is_inter, c_idx))
        return R.dequant(lv, qp, log2, bd, scale_matrix=m, dc_scale=dc)

    def headers_annexb(self) -> bytes:
        return nalmod.write_annexb([
            (nalmod.NAL_VPS, 0, 0, self.vps.write_rbsp()),
            (nalmod.NAL_SPS, 0, 0, self.sps.write_rbsp()),
            (nalmod.NAL_PPS, 0, 0, self.pps.write_rbsp()),
        ])

    # ---- one frame -------------------------------------------------------
    def encode_frame(self, planes: List[np.ndarray]) -> bytes:
        """planes: [Y, Cb, Cr] source arrays.  Returns the AU (Annex-B)."""
        sps, pps, cfg = self.sps, self.pps, self.cfg
        if self._sched is not None:
            poc, ftype = self._sched[0], self._sched[1]
            self.is_p = ftype in ("P", "B")
            self.is_b = ftype == "B"
            # "CRA": intra-coded non-IDR random-access point — keeps POC
            # continuity and the DPB (leading RASLs still reference it)
            reset = ftype == "I"
            self.poc = poc
            self._temporal_id = self._sched[5]
        else:
            self.is_p, self.is_b, reset = self._frame_type()
            self._temporal_id = 0
        if reset:
            self.poc = 0
            self.dpb = []
        self.pic = PictureState(sps, pps)
        self.src = []
        up = cfg.bit_depth - (cfg.source_bit_depth or cfg.bit_depth)
        self.src_scale = 1 << up
        for ci, p in enumerate(planes):
            p = p.astype(np.int32) << up
            tw = sps.width // (1 if ci == 0 else sps.sub_w)
            th = sps.height // (1 if ci == 0 else sps.sub_h)
            if p.shape != (th, tw):  # conformance-window padding
                p = np.pad(p, ((0, th - p.shape[0]),
                               (0, tw - p.shape[1])), mode="edge")
            self.src.append(p)
        self.e = CabacEncoder()
        self.cm = ContextModel(
            2 if self.is_b else (1 if self.is_p else 0), cfg.qp)
        self.qp_y = cfg.qp
        # per-QG QP: qpst mirrors the decoder's state machine; cur_qp is
        # the target QP the quantizer uses (== slice QP when disabled)
        from ..coding.qp import QpState
        self.qpst = QpState(cfg.qp)
        self.cur_qp = cfg.qp
        # rext residual-coding state (mirror of SliceDecoder.rext)
        from ..coding.residual import RextCtx
        self.rext_enc = None
        if self.sps.range_ext:
            self.rext_enc = RextCtx(
                persistent_rice=bool(self.sps.persistent_rice_adaptation),
                ts_context=bool(self.sps.transform_skip_context),
                implicit_rdpcm=bool(self.sps.implicit_rdpcm),
                explicit_rdpcm=bool(self.sps.explicit_rdpcm))
        self._setup_refs()
        self.tmvp_ctx = self._setup_tmvp() if (cfg.tmvp and self.is_p) \
            else None

        self.sao_map = {}
        n_ctbs = sps.ctb_w * sps.ctb_h
        init_type = 2 if self.is_b else (1 if self.is_p else 0)
        # segment the CTU walk (tile-scan order) by tile / WPP-row bounds
        order = [int(pps.ctb_addr_ts_to_rs[ts]) for ts in range(n_ctbs)]

        def tile_col_start(xc, yc):
            return xc == 0 or (cfg.tiles
                               and int(pps.tile_of_ctb[yc, xc - 1])
                               != int(pps.tile_of_ctb[yc, xc]))

        dep_n = int(cfg.dependent_slices or 0)
        n_slices = max(1, int(cfg.slices or 1))
        # independent-slice cut positions (tile-scan index i): CTB-row
        # splits, or whole-tile runs when tiles are on
        slice_cut = set()
        if n_slices > 1:
            if cfg.tiles:
                n_tiles = cfg.tiles[0] * cfg.tiles[1]
                per = n_tiles // n_slices
                for i in range(1, n_ctbs):
                    tid = int(pps.tile_id_of_ts[i])
                    if tid != int(pps.tile_id_of_ts[i - 1])                             and tid % per == 0:
                        slice_cut.add(i)
            else:
                cut_rows = {round((k * sps.ctb_h) / n_slices)
                            for k in range(1, n_slices)}
                for i, rs in enumerate(order):
                    if (i > 0 and rs % sps.ctb_w == 0
                            and rs // sps.ctb_w in cut_rows):
                        slice_cut.add(i)
        # dependent-segment cut positions: row splits, or (combined with
        # wpp/tiles) every wpp-row / tile start becomes its own
        # dependent segment — identical CABAC state evolution to the
        # single-slice wpp/tile stream, different NAL packaging
        dep_cut = set()
        if dep_n:
            if cfg.wpp or cfg.tiles:
                for i, rs in enumerate(order):
                    if i == 0:
                        continue
                    tb = cfg.tiles and (int(pps.tile_id_of_ts[i])
                                        != int(pps.tile_id_of_ts[i - 1]))
                    rb = (cfg.wpp and not tb
                          and tile_col_start(rs % sps.ctb_w,
                                             rs // sps.ctb_w))
                    if tb or rb:
                        dep_cut.add(i)
            else:
                cut_rows = {round((k * sps.ctb_h) / (dep_n + 1))
                            for k in range(1, dep_n + 1)}
                for i, rs in enumerate(order):
                    if (i > 0 and rs % sps.ctb_w == 0
                            and rs // sps.ctb_w in cut_rows):
                        dep_cut.add(i)
        # walk: segments (payload chunks), their owning NAL and slice
        segments = [[]]       # CTB rs lists, one per payload segment
        seg_kind = [0]        # 0 = starts a NAL (indep/dep), 1 = subset
        seg_slice = [0]       # slice index of each segment
        seg_dep = [False]     # segment is a dependent-slice NAL
        cur_slice = 0
        for i, rs in enumerate(order):
            if i > 0:
                tb = cfg.tiles and (int(pps.tile_id_of_ts[i])
                                    != int(pps.tile_id_of_ts[i - 1]))
                rb = (cfg.wpp and not tb
                      and tile_col_start(rs % sps.ctb_w,
                                         rs // sps.ctb_w))
                if i in slice_cut:
                    cur_slice += 1
                    segments.append([])
                    seg_kind.append(0)
                    seg_slice.append(cur_slice)
                    seg_dep.append(False)
                elif dep_n and i in dep_cut:
                    segments.append([])
                    seg_kind.append(0)
                    seg_slice.append(cur_slice)
                    seg_dep.append(True)
                elif not dep_n and (tb or rb):
                    segments.append([])
                    seg_kind.append(1)
                    seg_slice.append(cur_slice)
                    seg_dep.append(False)
            segments[-1].append(rs)
        seg_payloads = []
        wpp_saved = None
        gi = 0  # global tile-scan index (for QP-prediction restarts)
        for si, seg in enumerate(segments):
            self.e = CabacEncoder()
            if si > 0:
                new_tile = cfg.tiles and (
                    int(pps.tile_id_of_ts[gi])
                    != int(pps.tile_id_of_ts[gi - 1]))
                new_slice = seg_slice[si] != seg_slice[si - 1]
                if new_slice:
                    # independent slice: full CABAC/QP/rice restart;
                    # the WPP saved state never crosses a slice (the
                    # above-right CTB is unavailable to the new slice)
                    self.cm = ContextModel(init_type, cfg.qp)
                    wpp_saved = None
                    self.qpst = QpState(cfg.qp)
                    if self.rext_enc is not None:
                        self.rext_enc.stats = [0, 0, 0, 0]
                elif new_tile:
                    self.cm = ContextModel(init_type, cfg.qp)
                    wpp_saved = None  # rows never cross a tile edge
                    if self.rext_enc is not None:
                        self.rext_enc.stats = [0, 0, 0, 0]
                elif wpp_saved is not None and sps.ctb_w > 1 \
                        and cfg.wpp:
                    self.cm = ContextModel(init_type, cfg.qp)
                    self.cm.load(wpp_saved[0])
                    if self.rext_enc is not None \
                            and wpp_saved[1] is not None:
                        self.rext_enc.stats = list(wpp_saved[1])
                elif seg_dep[si]:
                    pass  # dependent segment: contexts/QP continue
                else:
                    self.cm = ContextModel(init_type, cfg.qp)
                    if self.rext_enc is not None:
                        self.rext_enc.stats = [0, 0, 0, 0]
            for rs in seg:
                xc, yc = rs % sps.ctb_w, rs // sps.ctb_w
                # chroma QG (one per CTB): plan this CTB's cu offsets +
                # re-arm the flag (mirror of the decoder's QG reset)
                if cfg.rext_chroma_qp_offsets:
                    idx = (xc + yc) % len(cfg.rext_chroma_qp_offsets)
                    self._chroma_off_plan = idx
                    self.qpst.is_cu_chroma_qp_offset_coded = False
                    self.qpst.cu_qp_offset_cb = \
                        self.pps.cb_qp_offset_list[idx]
                    self.qpst.cu_qp_offset_cr = \
                        self.pps.cr_qp_offset_list[idx]
                # QP prediction restarts at WPP-row / tile starts
                # (mirror of decoder SliceDecoder.decode_ctus)
                if cfg.wpp and tile_col_start(xc, yc):
                    self.qpst.first_qp_group = True
                if cfg.tiles and gi > 0 and (
                        int(pps.tile_id_of_ts[gi])
                        != int(pps.tile_id_of_ts[gi - 1])):
                    self.qpst.first_qp_group = True
                gi += 1
                self.pic.set_ctb_slice(xc, yc, seg_slice[si])
                if cfg.sao and self._slice_fp(seg_slice[si])["sao"]:
                    self._encode_sao(xc, yc)
                x0, y0 = xc << sps.log2_ctb_size, yc << sps.log2_ctb_size
                self._quadtree(x0, y0, sps.log2_ctb_size, 0)
                if cfg.wpp and xc > 0 and tile_col_start(xc - 1, yc) \
                        and (not cfg.tiles
                             or int(pps.tile_of_ctb[yc, xc - 1])
                             == int(pps.tile_of_ctb[yc, xc])):
                    wpp_saved = (self.cm.save(),
                                 list(self.rext_enc.stats)
                                 if self.rext_enc is not None else None)
                # end_of_slice_segment_flag: 1 at the last CTB of the
                # NAL's slice segment (subset segments share one NAL)
                ends_nal = (si == len(segments) - 1
                            or seg_kind[si + 1] == 0)
                last = ends_nal and rs == seg[-1]
                self.e.encode_terminate(1 if last else 0)
            if not ends_nal:
                self.e.encode_terminate(1)  # end_of_subset_one_bit
            self.e.terminate_and_align()
            seg_payloads.append(self.e.getvalue())
        payload = b"".join(seg_payloads)
        self._seg_payloads = seg_payloads
        if n_slices > 1 or (cfg.tiles and not cfg.lf_across_tiles):
            # multi-slice / restricted-tile recon filtering: per-slice
            # params + boundary gating (must match the decoder exactly)
            from ..ops.boundaries import filter_frame_multislice
            self.pic.compute_bs()
            params = [self._slice_fp(s) for s in range(n_slices)]
            filter_frame_multislice(
                self.pic.planes, self.pic.qp_y.astype(np.int32),
                self.pic.bs_v, self.pic.bs_h, self.pic.slice_idx,
                np.asarray(pps.tile_of_ctb) if cfg.tiles else
                np.zeros_like(self.pic.slice_idx),
                params, self.sao_map if cfg.sao else {},
                1 << sps.log2_ctb_size, sps.bit_depth_luma,
                sps.chroma_format_idc, pps.cb_qp_offset,
                pps.cr_qp_offset,
                bool(pps.loop_filter_across_tiles), bool(cfg.tiles),
                sps.sub_w, sps.sub_h,
                no_filter4=self.pic.no_filter)
        elif cfg.deblocking or cfg.sao:
            if cfg.deblocking:
                from ..ops.deblock import deblock_frame
                self.pic.compute_bs()
                deblock_frame(self.pic.planes,
                              self.pic.qp_y.astype(np.int32),
                              self.pic.bs_v, self.pic.bs_h,
                              no_filter4=self.pic.no_filter,
                              bit_depth=sps.bit_depth_luma,
                              chroma_format_idc=sps.chroma_format_idc,
                              cb_qp_offset=pps.cb_qp_offset,
                              cr_qp_offset=pps.cr_qp_offset)
            if cfg.sao:
                from ..ops.sao import apply_sao_frame
                apply_sao_frame(self.pic.planes, self.sao_map,
                                1 << sps.log2_ctb_size,
                                sps.bit_depth_luma,
                                sps.sub_w, sps.sub_h,
                                no_filter4=self.pic.no_filter)

        from ..bitstream.slice import SLICE_B, SLICE_P
        stype = SLICE_B if self.is_b else (SLICE_P if self.is_p else SLICE_I)
        wt = None
        if cfg.weighted_pred and self.is_p:
            from ..bitstream.slice import WeightTable
            wt = WeightTable(luma_log2_denom=6, chroma_log2_denom=6)
            # one row per ACTIVE ref (long_term_ref extends L0 to 2;
            # the same weights apply to every ref — found by the fuzz
            # matrix: a 1-row table under-runs the writer at n=2)
            n_l0 = 2 if cfg.long_term_ref else 1
            lw = [(1, (1 << 6) + 8, -2) for _ in range(n_l0)]
            cw = [(1, [(1 << 6) - 6, (1 << 6) + 4], [3, -4])
                  for _ in range(n_l0)]
            wt.luma_l0, wt.chroma_l0 = lw, cw
            wt.luma_l1, wt.chroma_l1 = [lw[0]], [
                (1, list(cw[0][1]), list(cw[0][2]))]
        sh = SliceHeader(slice_type=stype,
                         weight_table=wt,
                         pps_id=pps.pps_id,
                         slice_temporal_mvp_enabled=(
                             1 if self.tmvp_ctx is not None else 0),
                         collocated_ref_idx=cfg.tmvp_col_ref_idx,
                         qp_delta=cfg.qp - pps.init_qp,
                         sao_luma=1 if cfg.sao else 0,
                         sao_chroma=1 if (cfg.sao
                                          and cfg.chroma_format_idc)
                         else 0,
                         pic_order_cnt_lsb=self.poc & (sps.max_poc_lsb - 1),
                         short_term_rps_sps_flag=1,
                         short_term_rps_idx=(
                             self._sched[2] if self._sched else 0),
                         num_ref_idx_l0_active=max(1, len(self.ref_list)),
                         num_ref_idx_l1_active=max(1,
                                                   len(self.ref_list_l1)),
                         five_minus_max_num_merge_cand=0,
                         cu_chroma_qp_offset_enabled=(
                             1 if cfg.rext_chroma_qp_offsets else 0))
        if cfg.long_term_ref and self.is_p and any(self.ref_lt0):
            # frame 0 as LT: poc_lsb 0 + explicit msb cycle (7.4.7.1)
            sh.lt_entries = [(0, 1, 1,
                              self.poc >> sps.log2_max_poc_lsb)]
            if cfg.long_term_ref == "mod":
                sh.list_entry_l0 = [1, 0]
        nal_type = self._nal_type()
        if self._sched is not None and self._sched[6] is not None:
            nal_type = self._sched[6]
        # group payload segments into NALs (a NAL = one slice segment:
        # a kind-0 segment plus its trailing kind-1 wpp/tile subsets)
        import dataclasses as _dc
        nal_runs = []
        start = 0
        for si in range(1, len(segments) + 1):
            if si == len(segments) or seg_kind[si] == 0:
                nal_runs.append((start, si))
                start = si
        dep_rbsps = []
        slice_rbsp = None
        for a, b in nal_runs:
            pays = self._seg_payloads[a:b]
            pay = b"".join(pays)
            if seg_dep[a]:
                dsh = SliceHeader(
                    first_slice_in_pic=0, dependent_slice_segment=1,
                    segment_address=segments[a][0], pps_id=pps.pps_id)
                if len(pays) > 1:
                    dsh.entry_point_offsets = self._entry_offsets(
                        dsh, nal_type, pays)
                dep_rbsps.append(dsh.write_rbsp(
                    sps, pps, nal_type, pay,
                    nuh_layer_id=self.layer_id, vps=self.vps))
                continue
            sl = seg_slice[a]
            fp = self._slice_fp(sl)
            sh_i = sh if a == 0 else _dc.replace(
                sh, first_slice_in_pic=0,
                segment_address=segments[a][0],
                entry_point_offsets=[])
            if cfg.slices > 1:
                sh_i.sao_luma = 1 if (cfg.sao and fp["sao"]) else 0
                sh_i.sao_chroma = sh_i.sao_luma
                sh_i.loop_filter_across_slices =                     1 if fp["lf_across"] else 0
                if cfg.slice_filter_params:
                    sh_i.deblocking_filter_override = 1
                    sh_i.deblocking_filter_disabled =                         1 if fp["disable"] else 0
                    sh_i.beta_offset = fp["beta_offset"]
                    sh_i.tc_offset = fp["tc_offset"]
            if len(pays) > 1:
                sh_i.entry_point_offsets = self._entry_offsets(
                    sh_i, nal_type, pays)
            rbsp = sh_i.write_rbsp(sps, pps, nal_type, pay,
                                   nuh_layer_id=self.layer_id,
                                   vps=self.vps)
            if a == 0:
                slice_rbsp = rbsp
            else:
                dep_rbsps.append(rbsp)
        au = []
        if self.frames_encoded == 0 and self.include_headers_in_first_au:
            au += [
                (nalmod.NAL_VPS, 0, 0, self.vps.write_rbsp()),
                (nalmod.NAL_SPS, self.layer_id, 0, self.sps.write_rbsp()),
                (nalmod.NAL_PPS, self.layer_id, 0, self.pps.write_rbsp()),
            ]
        sei_msgs = []
        if self.frames_encoded == 0 and cfg.sei_side_data:
            sei_msgs += [(t, m.payload()) for t, m in cfg.sei_side_data]
        if sei_msgs:
            au.append((nalmod.NAL_SEI_PREFIX, self.layer_id,
                       self._temporal_id, write_sei_rbsp(sei_msgs)))
        au.append((nal_type, self.layer_id, self._temporal_id, slice_rbsp))
        for rbsp in dep_rbsps:
            au.append((nal_type, self.layer_id, self._temporal_id, rbsp))
        if cfg.sei_hash:
            # decoded-picture-hash is a SUFFIX SEI (D.2.1; the reference
            # only consumes it there — hevc_sei.c:307)
            md5s = picture_md5(self.pic.planes, sps.bit_depth_luma)
            sei = DecodedPictureHash(hash_type=0, md5=md5s)
            au.append((nalmod.NAL_SEI_SUFFIX, self.layer_id,
                       self._temporal_id, write_sei_rbsp(
                           [(SEI_TYPE_DECODED_PICTURE_HASH,
                             sei.payload())])))
        self.frames_encoded += 1
        self.dpb.append((self.poc, [p.astype(np.int32)
                                    for p in self.pic.planes]))
        self.dpb_motion[self.poc] = {
            "mv0": self.pic.mv_l0.copy(),
            "poc0": self.pic.ref_poc_l0.copy(),
            "mv1": self.pic.mv_l1.copy(),
            "poc1": self.pic.ref_poc_l1.copy(), "poc": self.poc}
        keep = self.dpb[-8:]
        if self.cfg.long_term_ref and self.dpb and self.dpb[0][0] == 0 \
                and keep[0][0] != 0:
            keep = [self.dpb[0]] + keep  # frame 0 stays (long-term)
        self.dpb = keep
        self.poc += 1
        return nalmod.write_annexb(au)

    def _frame_type(self):
        """(is_p, is_b, reset_dpb) for this frame.  The EL encoder
        overrides: EL IRAP pictures carry P slices predicting from the
        inter-layer ref only."""
        is_p = self.cfg.gop in ("ipp", "lowb") and self.frames_encoded > 0
        is_b = self.cfg.gop == "lowb" and self.frames_encoded > 0
        return is_p, is_b, not is_p

    def _setup_refs(self):
        """Build this frame's L0/L1 (+ long-term flags).  The EL
        encoder overrides this to insert the inter-layer ref."""
        if self._sched is not None:
            by_poc = dict(self.dpb)
            l0, l1 = self._sched[3], self._sched[4]
            self.ref_list = [(p, by_poc[p]) for p in l0]
            self.ref_list_l1 = [(p, by_poc[p]) for p in l1]
            self.ref_lt0 = [False] * len(self.ref_list)
            self.ref_lt1 = [False] * len(self.ref_list_l1)
            return
        if self.is_p:
            self.ref_list = [self.dpb[-1]]
            self.ref_list_l1 = [self.dpb[-1]] if self.is_b else []
        else:
            self.ref_list = []
            self.ref_list_l1 = []
        self.ref_lt0 = [False] * len(self.ref_list)
        self.ref_lt1 = [False] * len(self.ref_list_l1)
        if self.cfg.long_term_ref and self.is_p and self.poc > 1:
            lt_entry = (0, dict(self.dpb)[0])
            if self.cfg.long_term_ref == "mod":
                # modified order: LT first (list_entry_l0 = [1, 0])
                self.ref_list = [lt_entry] + self.ref_list
                self.ref_lt0 = [True] + self.ref_lt0
            else:
                self.ref_list = self.ref_list + [lt_entry]
                self.ref_lt0 = self.ref_lt0 + [True]

    def _nal_type(self):
        return nalmod.NAL_TRAIL_R if self.is_p else nalmod.NAL_IDR_W_RADL

    def _setup_tmvp(self):
        """TemporalCtx for the collocated L0 ref (idx
        cfg.tmvp_col_ref_idx); EL overrides for the IL collocated
        case."""
        from ..coding.mvs import TemporalCtx
        sps = self.sps
        col_poc = self.ref_list[self.cfg.tmvp_col_ref_idx][0]
        all_pocs = [p for p, _ in self.ref_list] \
            + [p for p, _ in getattr(self, "ref_list_l1", [])]
        return TemporalCtx(
            col=self.dpb_motion[col_poc], cur_poc=self.poc,
            ctb_log2=sps.log2_ctb_size, pic_w=sps.width,
            pic_h=sps.height,
            no_backward=all(p <= self.poc for p in all_pocs),
            col_from_l0=True)

    @property
    def recon_planes(self):
        return self.pic.planes

    @property
    def output_planes(self):
        """Reconstruction cropped to the conformance window (what a
        conformant decoder outputs)."""
        return crop_conf_win(self.pic.planes, self.sps)

    # ---- split policies --------------------------------------------------
    def _want_cu_split(self, x0, y0, log2_size, depth) -> bool:
        cfg = self.cfg
        if getattr(self, "is_p", False):
            # P CUs use a single TU at CU size: cap at the max TB size
            return log2_size > min(cfg.log2_cu_size,
                                   self.sps.log2_max_tb_size)
        if cfg.split_policy == "fixed":
            return log2_size > cfg.log2_cu_size
        if cfg.split_policy == "random":
            return bool(self.rng.random() < 0.5)
        # variance: split when the luma block is busy, in the source's
        # units (a shifted-up source splits as it would at its own depth)
        size = 1 << log2_size
        blk = self.src[0][y0:y0 + size, x0:x0 + size]
        return float(blk.std()) > 18.0 * self.src_scale

    def _want_nxn(self) -> bool:
        cfg = self.cfg
        if cfg.split_policy == "random":
            return bool(self.rng.random() < cfg.nxn_probability)
        return cfg.split_policy == "variance"

    def _want_tu_split(self, log2_size, depth) -> bool:
        cfg = self.cfg
        if cfg.split_policy == "random":
            return bool(self.rng.random() < cfg.tu_split_probability)
        return False

    # ---- SAO (random parameter policy, mirrors decoder parse) ------------
    def _sao_mergeable(self, xn, yn, xc, yc):
        # SAO merge candidates must share slice AND tile (the decoder
        # only reads the merge flag when the neighbour is available)
        return (self.pic.slice_idx[yn, xn] == self.pic.slice_idx[yc, xc]
                and self.pps.tile_of_ctb[yn, xn]
                == self.pps.tile_of_ctb[yc, xc])

    def _encode_sao(self, xc, yc):
        from ..ops.sao import SAO_BAND, SAO_EDGE, SaoParams
        e, cm, sps = self.e, self.cm, self.sps
        rng = self.rng
        can_left = xc > 0 and self._sao_mergeable(xc - 1, yc, xc, yc)
        can_up = yc > 0 and self._sao_mergeable(xc, yc - 1, xc, yc)
        merge_left = int(can_left and rng.random() < 0.2)
        if merge_left:
            e.encode_bin(cm.at("sao_merge_flag", 0), 1)
            self.sao_map[(xc, yc)] = self.sao_map[(xc - 1, yc)].copy()
            return
        if can_left:
            e.encode_bin(cm.at("sao_merge_flag", 0), 0)
        merge_up = int(can_up and rng.random() < 0.2)
        if can_up:
            e.encode_bin(cm.at("sao_merge_flag", 0), merge_up)
        if merge_up:
            self.sao_map[(xc, yc)] = self.sao_map[(xc, yc - 1)].copy()
            return
        prm = SaoParams()
        cmax = (1 << (min(sps.bit_depth_luma, 10) - 5)) - 1
        for c_idx in range(3 if sps.chroma_format_idc else 1):
            if c_idx in (0, 1):
                t = int(rng.choice([0, SAO_BAND, SAO_EDGE],
                                   p=[0.4, 0.3, 0.3]))
                prm.type_idx[c_idx] = t
                if c_idx == 1:
                    prm.type_idx[2] = t
                if t == 0:
                    e.encode_bin(cm.at("sao_type_idx", 0), 0)
                else:
                    e.encode_bin(cm.at("sao_type_idx", 0), 1)
                    e.encode_bypass(1 if t == SAO_EDGE else 0)
            t = prm.type_idx[c_idx]
            if t == 0:
                continue
            abs_offs = [int(rng.integers(0, cmax + 1)) for _ in range(4)]
            for a in abs_offs:
                for _ in range(a):
                    e.encode_bypass(1)
                if a < cmax:
                    e.encode_bypass(0)
            if t == SAO_BAND:
                offs = []
                for a in abs_offs:
                    if a:
                        neg = int(rng.integers(0, 2))
                        e.encode_bypass(neg)
                        offs.append(-a if neg else a)
                    else:
                        offs.append(0)
                prm.offsets[c_idx] = offs
                pos = int(rng.integers(0, 29))
                prm.band_position[c_idx] = pos
                e.encode_bypass_bits(pos, 5)
            else:
                if c_idx == 0:
                    ec = int(rng.integers(0, 4))
                    prm.eo_class[0] = ec
                    e.encode_bypass_bits(ec, 2)
                elif c_idx == 1:
                    ec = int(rng.integers(0, 4))
                    prm.eo_class[1] = prm.eo_class[2] = ec
                    e.encode_bypass_bits(ec, 2)
                prm.offsets[c_idx] = [abs_offs[0], abs_offs[1],
                                      -abs_offs[2], -abs_offs[3]]
        self.sao_map[(xc, yc)] = prm

    # ---- quadtree --------------------------------------------------------
    def _target_qp(self, x0, y0) -> int:
        """Deterministic per-QG target QP in [qp-3, qp+3]."""
        qgl = self.sps.log2_ctb_size - self.pps.diff_cu_qp_delta_depth
        v = ((x0 >> qgl) + 2 * (y0 >> qgl)) % 7 - 3
        return min(51, max(1, self.cfg.qp + v))

    def _quadtree(self, x0, y0, log2_size, depth):
        sps, pps = self.sps, self.pps
        size = 1 << log2_size
        w, h = sps.width, sps.height
        inside = x0 + size <= w and y0 + size <= h
        if inside and log2_size > sps.log2_min_cb_size:
            split = 1 if self._want_cu_split(x0, y0, log2_size, depth) else 0
            ctx = self.pic.ctdepth_gt(x0, y0, depth)
            self.e.encode_bin(self.cm.at("split_cu_flag", ctx), split)
        elif not inside:
            split = 1 if log2_size > sps.log2_min_cb_size else 0
        else:
            split = 0
        if pps.cu_qp_delta_enabled and log2_size >= \
                sps.log2_ctb_size - pps.diff_cu_qp_delta_depth:
            self.qpst.is_cu_qp_delta_coded = False
            self.qpst.cu_qp_delta_val = 0
            self.cur_qp = self._target_qp(x0, y0)
        if split:
            half = size >> 1
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                x1, y1 = x0 + dx * half, y0 + dy * half
                if x1 < w and y1 < h:
                    self._quadtree(x1, y1, log2_size - 1, depth + 1)
            if pps.cu_qp_delta_enabled:
                from ..coding.qp import qg_mask
                m = qg_mask(sps, pps)
                if ((x0 + size) & m) == 0 and ((y0 + size) & m) == 0:
                    self.qpst.qp_pred_state = self.qpst.cur_qp
        else:
            self._coding_unit(x0, y0, log2_size, depth)
            if pps.cu_qp_delta_enabled:
                from ..coding.qp import end_of_cu
                end_of_cu(self.qpst, self.pic, sps, pps, x0, y0, log2_size)

    def _choose_mode(self, x0, y0, size) -> int:
        # intra prediction operates per-TU (max 32); for a 64x64 CU evaluate
        # the top-left 32x32 as the mode-decision proxy
        size = min(size, 32)
        src = self.src[0][y0:y0 + size, x0:x0 + size]
        cand = (range(35) if self.cfg.full_mode_search
                else self.cfg.candidate_modes)
        best, best_cost = R.INTRA_DC, None
        for mode in cand:
            pred = self.pic.predict_intra(0, x0, y0, size, mode)
            cost = int(np.abs(src - pred).sum())
            if best_cost is None or cost < best_cost:
                best, best_cost = mode, cost
        return best

    # ---- coding unit -----------------------------------------------------
    def _coding_unit(self, x0, y0, log2_size, depth):
        pps, e, cm = self.pps, self.e, self.cm
        if pps.transquant_bypass_enabled:
            e.encode_bin(cm.at("cu_transquant_bypass_flag", 0), 0)
        if getattr(self, "is_p", False):
            self._coding_unit_p(x0, y0, log2_size, depth)
        else:
            self._intra_cu_body(x0, y0, log2_size, depth)

    def _intra_cu_body(self, x0, y0, log2_size, depth):
        sps, pps, e, cm, pic = self.sps, self.pps, self.e, self.cm, self.pic
        size = 1 << log2_size
        intra_split = False
        if log2_size == sps.log2_min_cb_size:
            intra_split = self._want_nxn()
            e.encode_bin(cm.at("part_mode", 0), 0 if intra_split else 1)

        # pcm_flag (7.3.8.5; terminate-coded per 9.3.1)
        if (sps.pcm_enabled and not intra_split
                and sps.log2_min_pcm_cb_size <= log2_size
                <= sps.log2_max_pcm_cb_size):
            want = (self.cfg.pcm == "all"
                    or (self.cfg.pcm not in (None, False)
                        and self.rng.random() < float(self.cfg.pcm)))
            e.encode_terminate(1 if want else 0)
            if want:
                self._encode_pcm_cu(x0, y0, log2_size, depth)
                return

        gq = size >> 2
        pic.ct_depth[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = depth
        pic.qp_y[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = self.qp_y

        # ---- choose + emit luma modes (PB order; map updated per PB so the
        # next PB's MPM derivation and prediction see it, matching decode) --
        n_pb = 4 if intra_split else 1
        pb_size = size >> 1 if intra_split else size
        modes = []
        syntax = []  # (prev_flag, payload)
        for i in range(n_pb):
            xp = x0 + (i & 1) * pb_size
            yp = y0 + (i >> 1) * pb_size
            mode = self._choose_mode(xp, yp, pb_size)
            ca, cb = pic.luma_intra_mode_cand(xp, yp)
            cands = mpm_list(ca, cb)
            if mode in cands:
                syntax.append((1, cands.index(mode)))
            else:
                rem = mode
                for m in sorted(cands, reverse=True):
                    if rem > m:
                        rem -= 1
                syntax.append((0, rem))
            modes.append(mode)
            g = pb_size >> 2
            pic.intra_mode_y[yp >> 2:(yp >> 2) + g,
                             xp >> 2:(xp >> 2) + g] = mode
            pic.is_intra[yp >> 2:(yp >> 2) + g, xp >> 2:(xp >> 2) + g] = True
        for prev, _ in syntax:
            e.encode_bin(cm.at("prev_intra_luma_pred_flag", 0), prev)
        for prev, payload in syntax:
            if prev:
                if payload == 0:
                    e.encode_bypass(0)
                else:
                    e.encode_bypass(1)
                    e.encode_bypass(payload - 1)
            else:
                e.encode_bypass_bits(payload, 5)

        # chroma mode: derived (DM); binarization '0' (absent for
        # monochrome; PER PB for 4:4:4 NxN, 7.3.8.5)
        chroma_mode = modes[0]
        if sps.chroma_format_idc:
            n_cpb = (len(modes) if sps.chroma_format_idc == 3
                     and intra_split else 1)
            for _ in range(n_cpb):
                e.encode_bin(cm.at("intra_chroma_pred_mode", 0), 0)

        # ---- transform tree: plan, compute (z-order), then emit ----------
        max_trafo_depth = (sps.max_transform_hierarchy_depth_intra
                           + (1 if intra_split else 0))
        root = self._plan_tu(x0, y0, log2_size, 0, 0, intra_split,
                             max_trafo_depth)
        self._compute_tu(root, modes, chroma_mode, x0, y0, intra_split,
                         pb_size)
        self._propagate_cbf(root)
        self._emit_tu(root, intra_split, max_trafo_depth, chroma_mode,
                      (1, 1), (1, 1), (x0, y0))

    def _encode_pcm_cu(self, x0, y0, log2_size, depth):
        """pcm_sample payload (7.3.8.7): raw u(v) samples, engine
        restarted after (9.3.2.5).  Mirrors decoder/core.py _pcm_cu."""
        sps, e, pic = self.sps, self.e, self.pic
        size = 1 << log2_size
        e.begin_pcm()
        for c_idx in range(3 if sps.chroma_format_idc else 1):
            if c_idx == 0:
                w = h = size
                pbd, bd = sps.pcm_bit_depth_luma, sps.bit_depth_luma
                xs, ys = x0, y0
            else:
                w, h = size // sps.sub_w, size // sps.sub_h
                pbd, bd = sps.pcm_bit_depth_chroma, sps.bit_depth_chroma
                xs, ys = x0 // sps.sub_w, y0 // sps.sub_h
            shift = bd - pbd
            src = self.src[c_idx][ys:ys + h, xs:xs + w] >> shift
            for row in src:
                for v in row:
                    e.write_raw(int(v), pbd)
            pic.planes[c_idx][ys:ys + h, xs:xs + w] = \
                (src << shift).astype(pic.planes[c_idx].dtype)
        e.restart()
        gq = size >> 2
        ysl = slice(y0 >> 2, (y0 >> 2) + gq)
        xsl = slice(x0 >> 2, (x0 >> 2) + gq)
        pic.intra_mode_y[ysl, xsl] = 1  # INTRA_DC (8.4.2 neighbour rule)
        pic.is_intra[ysl, xsl] = True
        pic.ct_depth[ysl, xsl] = depth
        pic.qp_y[ysl, xsl] = self.qp_y
        if sps.pcm_loop_filter_disabled:
            pic.no_filter[ysl, xsl] = True
        pic.mark_intra_tu_edges(x0, y0, size)

    def _maybe_emit_cu_qp_delta(self, cu_x0, cu_y0, any_cbf):
        """Emit cu_qp_delta_abs/sign at the QG's first residual-carrying
        TU (mirror of decoder _decode_cu_qp_delta; 9.3.3.9 TR+EG0)."""
        if (not self.pps.cu_qp_delta_enabled
                or self.qpst.is_cu_qp_delta_coded or not any_cbf):
            return
        from ..coding.qp import qp_pred
        # flag first: qp_pred's first_qp_group handoff reads it (mirrors
        # the decoder's decode-then-set_qpy order)
        self.qpst.is_cu_qp_delta_coded = True
        pred = qp_pred(self.qpst, self.pic, self.sps, self.pps,
                       cu_x0, cu_y0)
        delta = self.cur_qp - pred
        e, cm = self.e, self.cm
        a = abs(delta)
        prefix = min(a, 5)
        for i in range(prefix):
            e.encode_bin(cm.at("cu_qp_delta", 0 if i == 0 else 1), 1)
        if prefix < 5:
            e.encode_bin(cm.at("cu_qp_delta", 0 if prefix == 0 else 1), 0)
        else:
            # EG0 suffix of (a - 5): value = 2^k - 1 + b
            v = a - 5
            k = (v + 1).bit_length() - 1
            b = v + 1 - (1 << k)
            for _ in range(k):
                e.encode_bypass(1)
            e.encode_bypass(0)
            e.encode_bypass_bits(b, k)
        if a:
            e.encode_bypass(1 if delta < 0 else 0)
        self.qpst.cu_qp_delta_val = delta
        self.qpst.cur_qp = self.cur_qp  # == set_qpy result (no wrap)

    def _maybe_emit_cu_chroma_qp_offset(self, cbf_chroma):
        """Emit cu_chroma_qp_offset_flag/idx at the chroma QG's first
        chroma-residual TU (mirror of decoder
        _decode_cu_chroma_qp_offset; reference hevcdec.c:1367)."""
        if (not self.cfg.rext_chroma_qp_offsets or not cbf_chroma
                or self.qpst.is_cu_chroma_qp_offset_coded):
            return
        e, cm = self.e, self.cm
        idx = self._chroma_off_plan
        e.encode_bin(cm.at("cu_chroma_qp_offset_flag", 0), 1)
        n = len(self.cfg.rext_chroma_qp_offsets)
        if n > 1:
            cmax = max(5, n - 1)
            for _ in range(idx):
                e.encode_bin(cm.at("cu_chroma_qp_offset_idx", 0), 1)
            if idx < cmax:
                e.encode_bin(cm.at("cu_chroma_qp_offset_idx", 0), 0)
        self.qpst.is_cu_chroma_qp_offset_coded = True

    def _emit_ccp(self, idx, val):
        """cross_comp_pred syntax (mirror of decoder _decode_ccp)."""
        e, cm = self.e, self.cm
        k = 0 if val == 0 else abs(val).bit_length()
        for i in range(k):
            e.encode_bin(cm.at("log2_res_scale_abs", 4 * idx + i), 1)
        if k < 4:
            e.encode_bin(cm.at("log2_res_scale_abs", 4 * idx + k), 0)
        if k:
            e.encode_bin(cm.at("res_scale_sign_flag", idx),
                         1 if val < 0 else 0)

    def _plan_tu(self, x0, y0, log2, depth, blk_idx, intra_split,
                 max_trafo_depth) -> _TuPlan:
        sps = self.sps
        node = _TuPlan(x0, y0, log2, depth, blk_idx)
        must = (log2 > sps.log2_max_tb_size
                or (intra_split and depth == 0))
        can = (log2 <= sps.log2_max_tb_size
               and log2 > sps.log2_min_tb_size
               and depth < max_trafo_depth)
        node.split = must or (can and self._want_tu_split(log2, depth))
        if node.split:
            half = 1 << (log2 - 1)
            for i, (dx, dy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                node.children.append(self._plan_tu(
                    x0 + dx * half, y0 + dy * half, log2 - 1, depth + 1, i,
                    intra_split, max_trafo_depth))
        return node

    def _compute_tu(self, node: _TuPlan, modes, chroma_mode, cu_x0, cu_y0,
                    intra_split, pb_size):
        """Pass 1: z-order prediction → transform → quant → recon."""
        if node.split:
            for ch in node.children:
                self._compute_tu(ch, modes, chroma_mode, cu_x0, cu_y0,
                                 intra_split, pb_size)
            return
        sps, pic = self.sps, self.pic
        size = 1 << node.log2
        bd = sps.bit_depth_luma
        maxv = (1 << bd) - 1
        x0, y0 = node.x0, node.y0
        pic.mark_intra_tu_edges(x0, y0, size)
        mode = int(pic.intra_mode_y[y0 >> 2, x0 >> 2])
        pred = pic.predict_intra(0, x0, y0, size, mode)
        res = self.src[0][y0:y0 + size, x0:x0 + size] - pred
        use_dst = node.log2 == 2
        node.ts = (self.cfg.transform_skip and node.log2 == 2
                   and self.rng.random() < 0.5)
        node.rdpcm = 0
        if (self.cfg.rext_implicit_rdpcm and node.ts
                and mode in (10, 26)):
            node.rdpcm = 2 if mode == 26 else 1
        node.rot = bool(self.cfg.rext_ts_rotation and node.ts)
        if node.ts:
            src = res
            if node.rdpcm:  # DPCM: quantize the directional diffs
                src = res.copy()
                if node.rdpcm == 2:
                    src[1:, :] -= res[:-1, :]
                else:
                    src[:, 1:] -= res[:, :-1]
            coef = src.astype(np.int64) << (13 - bd)
        else:
            coef = forward_transform(res, bd, dst=use_dst)
        lv = quantize(coef, self.cur_qp + sps.qp_bd_offset, node.log2, bd)
        node.lv_y = lv
        node.cbf_luma = 1 if lv.any() else 0
        if node.cbf_luma:
            dq = self._deq(lv, self.cur_qp + sps.qp_bd_offset, node.log2,
                           bd, 0, False, node.ts)
            r = (R.transform_skip_residual(dq, bd) if node.ts
                 else R.inverse_transform(dq, bd, dst=use_dst))
            if node.rdpcm:  # decoder-identical accumulate (int16 wrap)
                axis = 0 if node.rdpcm == 2 else 1
                r = np.cumsum(r.astype(np.int16), axis=axis,
                              dtype=np.int16).astype(np.int32)
            rec = np.clip(pred + r, 0, maxv)
        else:
            rec = pred
            r = None
        pic.planes[0][y0:y0 + size, x0:x0 + size] = \
            rec.astype(pic.planes[0].dtype)
        # cross-component prediction (4:4:4, DM chroma): alpha cycles
        # deterministically per TU
        if (self.cfg.rext_ccp and node.cbf_luma
                and sps.chroma_format_idc == 3):
            pool = (1, -1, 2, -2, 4, -4, 8, -8)
            i = ((x0 >> 2) + (y0 >> 2)) % 8
            node.ccp_alpha = (pool[i], pool[(i + 3) % 8])
            node.ccp_ry = r
        # chroma leaf? (4:4:4/4:2:2: per format; 4:2:0: log2>2 or 4th 4x4)
        fmt = sps.chroma_format_idc
        if fmt == 3:
            node.chroma_leaf = True
            # DM per PB: a 4:4:4 NxN leaf's chroma mode is ITS PB's
            # luma mode (all signalled modes are DM)
            cmode = int(self.pic.intra_mode_y[y0 >> 2, x0 >> 2])
            self._compute_chroma(node, [(x0, y0, node.log2)], cmode)
        elif fmt == 2:
            if node.log2 > 2:
                node.chroma_leaf = True
                lc = node.log2 - 1
                self._compute_chroma(
                    node, [(x0 >> 1, y0, lc), (x0 >> 1, y0 + (1 << lc), lc)],
                    chroma_mode)
            elif node.blk_idx == 3:
                node.chroma_leaf = True
                xb, yb = x0 - 4, y0 - 4
                self._compute_chroma(
                    node, [(xb >> 1, yb, 2), (xb >> 1, yb + 4, 2)],
                    chroma_mode)
        elif fmt == 0:
            pass  # monochrome: no chroma TBs
        elif node.log2 > 2:
            node.chroma_leaf = True
            self._compute_chroma(node, [(x0 >> 1, y0 >> 1, node.log2 - 1)],
                                 chroma_mode)
        elif node.blk_idx == 3:
            node.chroma_leaf = True
            # chroma block of the parent 8x8 area
            self._compute_chroma(node,
                                 [((x0 - 4) >> 1, (y0 - 4) >> 1, 2)],
                                 chroma_mode)

    def _compute_chroma(self, node: _TuPlan, blocks, chroma_mode):
        """blocks: [(xc, yc, log2c)] chroma TBs (2 stacked for 4:2:2)."""
        from ..coding.picture import CHROMA_422_MODE
        sps, pps, pic = self.sps, self.pps, self.pic
        bd = sps.bit_depth_chroma
        maxv = (1 << bd) - 1
        mode = chroma_mode
        if sps.chroma_format_idc == 2:
            mode = CHROMA_422_MODE[chroma_mode]
        for c_idx in (1, 2):
            off = pps.cb_qp_offset if c_idx == 1 else pps.cr_qp_offset
            off += (self.qpst.cu_qp_offset_cb if c_idx == 1
                    else self.qpst.cu_qp_offset_cr)
            qp = R.chroma_qp(self.cur_qp, off, sps.chroma_format_idc,
                             sps.qp_bd_offset)
            alpha = node.ccp_alpha[c_idx - 1] if node.ccp_ry is not None \
                else 0
            add = None
            if alpha:
                add = ((alpha * node.ccp_ry.astype(np.int32)) >> 3) \
                    .astype(np.int16)
            lvs, cbfs = [], []
            for (xc, yc, log2c) in blocks:
                csize = 1 << log2c
                pred = pic.predict_intra(c_idx, xc, yc, csize, mode)
                res = self.src[c_idx][yc:yc + csize, xc:xc + csize] - pred
                if add is not None:
                    res = res - add
                lv = quantize(forward_transform(res, bd), qp, log2c, bd)
                cbf = 1 if lv.any() else 0
                if cbf:
                    dq = self._deq(lv, qp, log2c, bd, c_idx, False)
                    r = R.inverse_transform(dq, bd)
                elif add is not None:
                    r = np.zeros_like(pred)
                else:
                    r = None
                if r is not None and add is not None:
                    # decoder-identical cross add (int16 wrap)
                    r = (r.astype(np.int16) + add).astype(np.int32)
                rec = np.clip(pred + r, 0, maxv) if r is not None else pred
                pic.planes[c_idx][yc:yc + csize, xc:xc + csize] = \
                    rec.astype(pic.planes[c_idx].dtype)
                lvs.append(lv)
                cbfs.append(cbf)
            while len(cbfs) < 2:
                cbfs.append(0)
            if c_idx == 1:
                node.lv_cb, node.cbf_cb = lvs, tuple(cbfs)
            else:
                node.lv_cr, node.cbf_cr = lvs, tuple(cbfs)

    def _propagate_cbf(self, node: _TuPlan):
        """cbf_cb/cr at internal nodes = OR over children."""
        if not node.split:
            return
        for ch in node.children:
            self._propagate_cbf(ch)
        # elementwise OR: in 4:2:2 a split log2==3 node still signals
        # the PAIR for its two stacked chroma TBs (coded at blk 3), so
        # the second flag must survive propagation (found by the fuzz
        # matrix: (any, 0) dropped the lower TB's cbf)
        node.cbf_cb = (int(any(ch.cbf_cb[0] for ch in node.children)),
                       int(any(ch.cbf_cb[1] for ch in node.children)))
        node.cbf_cr = (int(any(ch.cbf_cr[0] for ch in node.children)),
                       int(any(ch.cbf_cr[1] for ch in node.children)))

    def _emit_tu(self, node: _TuPlan, intra_split, max_trafo_depth,
                 chroma_mode, cbf_cb_par, cbf_cr_par, cu_xy=(0, 0)):
        """Pass 2: emit the transform tree syntax (mirrors decode)."""
        sps, e, cm = self.sps, self.e, self.cm
        log2, depth = node.log2, node.depth
        intra_split_here = intra_split and depth == 0
        if (log2 <= sps.log2_max_tb_size and log2 > sps.log2_min_tb_size
                and depth < max_trafo_depth and not intra_split_here):
            e.encode_bin(cm.at("split_transform_flag", 5 - log2),
                         1 if node.split else 0)
        chroma_here = sps.chroma_format_idc != 0 \
            and (log2 > 2 or sps.chroma_format_idc == 3)
        is422 = sps.chroma_format_idc == 2
        eff_cb, eff_cr = node.cbf_cb, node.cbf_cr
        if chroma_here:
            second = is422 and (not node.split or log2 == 3)
            if not second:
                # single gate flag covers BOTH stacked TBs of the
                # subtree (spec: cbf_cb[xBase][yBase] gates children)
                eff_cb = (node.cbf_cb[0] | node.cbf_cb[1], 0)
                eff_cr = (node.cbf_cr[0] | node.cbf_cr[1], 0)
            if depth == 0 or cbf_cb_par[0]:
                e.encode_bin(cm.at("cbf_cbcr", depth), eff_cb[0])
                if second:
                    e.encode_bin(cm.at("cbf_cbcr", depth), eff_cb[1])
            if depth == 0 or cbf_cr_par[0]:
                e.encode_bin(cm.at("cbf_cbcr", depth), eff_cr[0])
                if second:
                    e.encode_bin(cm.at("cbf_cbcr", depth), eff_cr[1])
        if node.split:
            for ch in node.children:
                self._emit_tu(ch, intra_split, max_trafo_depth, chroma_mode,
                              eff_cb, eff_cr, cu_xy)
            return
        # leaf: cbf_luma is always signalled for intra CUs
        e.encode_bin(cm.at("cbf_luma", 1 if depth == 0 else 0),
                     node.cbf_luma)
        # cu_qp_delta at the first residual-carrying TU; the chroma cbfs
        # seen here are the inherited ones for 4x4 leaves (mirror of
        # decoder transform_unit / reference hevcdec.c:1346)
        tcb = node.cbf_cb if log2 > 2 else cbf_cb_par
        tcr = node.cbf_cr if log2 > 2 else cbf_cr_par
        any_cbf = (node.cbf_luma or tcb[0] or tcr[0]
                   or (is422 and (tcb[1] or tcr[1])))
        cbf_chroma = (tcb[0] or tcr[0]
                      or (is422 and (tcb[1] or tcr[1])))
        self._maybe_emit_cu_qp_delta(cu_xy[0], cu_xy[1], any_cbf)
        self._maybe_emit_cu_chroma_qp_offset(cbf_chroma)
        mode = int(self.pic.intra_mode_y[node.y0 >> 2, node.x0 >> 2])
        if node.cbf_luma:
            scan = scan_idx_for_intra(mode, log2, 0, sps.chroma_format_idc)
            ts_ok = (self.pps.transform_skip_enabled and log2
                     <= self.pps.log2_max_transform_skip_block_size)
            lv_emit = node.lv_y[::-1, ::-1] if node.rot else node.lv_y
            encode_residual(e, cm, lv_emit, log2, 0, scan,
                            transform_skip_allowed=bool(ts_ok),
                            ts_flag=1 if node.ts else 0,
                            rext=self.rext_enc, intra_mode=mode)
        if node.chroma_leaf:
            from ..coding.picture import CHROMA_422_MODE
            if sps.chroma_format_idc == 3:
                log2c = log2
            else:
                log2c = log2 - 1 if log2 > 2 else 2
            # inherited cbfs: for log2==2 leaves the parent's cbf applies
            ccb = node.cbf_cb if log2 > 2 else cbf_cb_par
            ccr = node.cbf_cr if log2 > 2 else cbf_cr_par
            mode_c = chroma_mode
            if sps.chroma_format_idc == 3:
                # DM per PB (4:4:4 NxN): residual scan follows the
                # leaf's own chroma mode
                mode_c = int(self.pic.intra_mode_y[node.y0 >> 2,
                                                   node.x0 >> 2])
            if is422:
                mode_c = CHROMA_422_MODE[chroma_mode]
            scan_c = scan_idx_for_intra(mode_c, log2c, 1,
                                        sps.chroma_format_idc)
            ts_ok_c = (self.pps.transform_skip_enabled and log2c
                       <= self.pps.log2_max_transform_skip_block_size)
            for c_idx, ccx, lvs in ((1, ccb, node.lv_cb),
                                    (2, ccr, node.lv_cr)):
                if node.ccp_ry is not None:
                    self._emit_ccp(c_idx - 1, node.ccp_alpha[c_idx - 1])
                for half, lv in enumerate(lvs):
                    if ccx[half]:
                        encode_residual(e, cm, lv, log2c, c_idx, scan_c,
                                        transform_skip_allowed=bool(ts_ok_c),
                                        rext=self.rext_enc,
                                        intra_mode=mode_c)

    # ---- inter coding (P frames) -----------------------------------------
    def _encode_eg1(self, v: int):
        """kth-order (k=1) Exp-Golomb bypass encode (mirror of decode)."""
        e = self.e
        count = 1
        while v >= (1 << count):
            e.encode_bypass(1)
            v -= 1 << count
            count += 1
        e.encode_bypass(0)
        # suffix length includes the terminating-zero iteration
        e.encode_bypass_bits(v, count)

    def _encode_mvd(self, mvd):
        e, cm = self.e, self.cm
        ax, ay = abs(mvd[0]), abs(mvd[1])
        e.encode_bin(cm.at("abs_mvd_greater0_flag", 0), 1 if ax else 0)
        e.encode_bin(cm.at("abs_mvd_greater0_flag", 0), 1 if ay else 0)
        if ax:
            e.encode_bin(cm.at("abs_mvd_greater1_flag", 1), 1 if ax > 1 else 0)
        if ay:
            e.encode_bin(cm.at("abs_mvd_greater1_flag", 1), 1 if ay > 1 else 0)
        for a, v in ((ax, mvd[0]), (ay, mvd[1])):
            if a:
                if a > 1:
                    self._encode_eg1(a - 2)
                e.encode_bypass(1 if v < 0 else 0)

    def _encode_ref_idx(self, idx, num_ref):
        """ref_idx_lX TR-coded bins (mirror of the decoder's
        _decode_ref_idx)."""
        e, cm = self.e, self.cm
        e.encode_bin(cm.at("ref_idx_l0", 0), 1 if idx else 0)
        if not idx:
            return
        if num_ref == 2:
            return
        e.encode_bin(cm.at("ref_idx_l0", 1), 1 if idx > 1 else 0)
        if idx == 1:
            return
        for i in range(2, num_ref - 1):
            if i < idx:
                e.encode_bypass(1)
            else:
                e.encode_bypass(0)
                break

    def _encode_merge_idx(self, idx, max_cand=5):
        e, cm = self.e, self.cm
        if max_cand <= 1:
            return
        e.encode_bin(cm.at("merge_idx", 0), 1 if idx else 0)
        if idx:
            for i in range(1, max_cand - 1):
                if i < idx:
                    e.encode_bypass(1)
                else:
                    e.encode_bypass(0)
                    break

    def _mc_pred(self, x0, y0, w, h, mi):
        """Full MC prediction (Y, Cb, Cr) for a MotionInfo (uni or bi)."""
        from ..ops import mc as MC
        sps = self.sps
        xc, yc = x0 // sps.sub_w, y0 // sps.sub_h
        wc, hc = w // sps.sub_w, h // sps.sub_h
        hs, vs = sps.sub_w - 1, sps.sub_h - 1
        out = []
        for c in range(3 if sps.chroma_format_idc else 1):
            if c == 0:
                fn = MC.mc_luma
            else:
                fn = lambda *a: MC.mc_chroma(*a, hshift=hs, vshift=vs)
            bd = sps.bit_depth_luma if c == 0 else sps.bit_depth_chroma
            px, py_ = (x0, y0) if c == 0 else (xc, yc)
            pw, ph = (w, h) if c == 0 else (wc, hc)
            preds = []
            if mi.uses_l0:
                preds.append(fn(self.ref_list[mi.ref0][1][c], px, py_,
                                pw, ph, mi.mv0[0], mi.mv0[1], bd))
            if mi.uses_l1:
                preds.append(fn(self.ref_list_l1[mi.ref1][1][c], px, py_,
                                pw, ph, mi.mv1[0], mi.mv1[1], bd))
            if self.cfg.weighted_pred and self.is_p:
                denom = 6
                log2wd = denom + 14 - bd
                if c == 0:
                    wgt, off = (1 << 6) + 8, -2
                else:
                    wgt = ((1 << 6) - 6, (1 << 6) + 4)[c - 1]
                    off = (3, -4)[c - 1]
                off <<= (bd - 8)
                if len(preds) == 2:
                    out.append(MC.weighted_bi_explicit(
                        preds[0], preds[1], wgt, off, wgt, off, log2wd, bd))
                else:
                    out.append(MC.weighted_uni_explicit(
                        preds[0], wgt, off, log2wd, bd))
            else:
                out.append(MC.weighted_bi(preds[0], preds[1], bd)
                           if len(preds) == 2 else
                           MC.weighted_uni(preds[0], bd))
        return tuple(out)

    def _motion_search(self, x0, y0, w, h, mvp, ref_idx=0):
        """Integer diamond around mvp, then one eighth/quarter-pel refine."""
        from ..ops import mc as MC
        sps = self.sps
        src = self.src[0][y0:y0 + h, x0:x0 + w]
        _, ref_planes = self.ref_list[ref_idx]
        ref = ref_planes[0]
        bd = sps.bit_depth_luma
        r = self.cfg.search_range

        def sad_int(ix, iy):
            rh, rw = ref.shape
            ys = np.clip(np.arange(h) + y0 + iy, 0, rh - 1)
            xs = np.clip(np.arange(w) + x0 + ix, 0, rw - 1)
            return int(np.abs(src - ref[ys[:, None], xs[None, :]]).sum())

        cx, cy = mvp[0] >> 2, mvp[1] >> 2
        best = (cx, cy)
        best_cost = sad_int(cx, cy)
        for iy in range(cy - r, cy + r + 1):
            for ix in range(cx - r, cx + r + 1):
                c = sad_int(ix, iy)
                if c < best_cost:
                    best, best_cost = (ix, iy), c
        mv = [best[0] * 4, best[1] * 4]
        # quarter-pel refinement
        for _ in range(2):
            improved = False
            for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1),
                           (1, 1), (-1, -1), (1, -1), (-1, 1)):
                cand = (mv[0] + dx, mv[1] + dy)
                pred = MC.weighted_uni(MC.mc_luma(
                    ref, x0, y0, w, h, cand[0], cand[1], bd), bd)
                c = int(np.abs(src - pred).sum())
                if c < best_cost:
                    best_cost = c
                    mv = list(cand)
                    improved = True
            if not improved:
                break
        return mv, best_cost

    def _inter_residual(self, x0, y0, log2_size, preds):
        """Quantize the inter residual for a single-TU CU.

        Returns (lv_y, lv_cb, lv_cr) (None when all-zero)."""
        sps, pps = self.sps, self.pps
        size = 1 << log2_size
        bd = sps.bit_depth_luma
        py = preds[0]
        pcb, pcr = (preds[1], preds[2]) if sps.chroma_format_idc \
            else (None, None)
        res_y = self.src[0][y0:y0 + size, x0:x0 + size] - py
        self._inter_ts = (0, 0)  # (ts_flag, rdpcm_dir) for this CU
        if self.cfg.rext_explicit_rdpcm:
            # CU-sized transform-skip TU with explicit DPCM, direction
            # alternating per CTB position
            rd_dir = ((x0 >> sps.log2_ctb_size)
                      + (y0 >> sps.log2_ctb_size)) & 1
            self._inter_ts = (1, rd_dir)
            diff = res_y.copy()
            if rd_dir:
                diff[1:, :] -= res_y[:-1, :]
            else:
                diff[:, 1:] -= res_y[:, :-1]
            coef = diff.astype(np.int64) << max(0, 15 - bd - log2_size)
        else:
            coef = forward_transform(res_y, bd)
        lv_y = quantize(coef, self.cur_qp + sps.qp_bd_offset, log2_size, bd,
                        intra=False)
        xc, yc = x0 // sps.sub_w, y0 // sps.sub_h
        if not sps.chroma_format_idc:
            return (lv_y if lv_y.any() else None), [None], [None]
        out_c = []
        for c_idx, pred in ((1, pcb), (2, pcr)):
            off = pps.cb_qp_offset if c_idx == 1 else pps.cr_qp_offset
            off += (self.qpst.cu_qp_offset_cb if c_idx == 1
                    else self.qpst.cu_qp_offset_cr)
            qp = R.chroma_qp(self.cur_qp, off, sps.chroma_format_idc,
                             sps.qp_bd_offset)
            lvs = []
            for (bx, by, log2c) in self._inter_chroma_blocks(x0, y0,
                                                             log2_size):
                csize = 1 << log2c
                res = self.src[c_idx][by:by + csize, bx:bx + csize] \
                    - pred[by - yc:by - yc + csize, bx - xc:bx - xc + csize]
                lv = quantize(forward_transform(res, sps.bit_depth_chroma),
                              qp, log2c, sps.bit_depth_chroma, intra=False)
                lvs.append(lv if lv.any() else None)
            out_c.append(lvs)
        return (lv_y if lv_y.any() else None), out_c[0], out_c[1]

    def _inter_chroma_blocks(self, x0, y0, log2_size):
        """Square chroma TBs of a single-TU inter CU (2 stacked for 422)."""
        sps = self.sps
        xc, yc = x0 // sps.sub_w, y0 // sps.sub_h
        if sps.chroma_format_idc == 2:
            lc = log2_size - 1
            return [(xc, yc, lc), (xc, yc + (1 << lc), lc)]
        lc = log2_size - (sps.sub_w - 1)
        return [(xc, yc, lc)]

    def _recon_inter_cu(self, x0, y0, log2_size, preds, levels):
        """Reconstruct pred+residual into the picture planes."""
        sps, pps, pic = self.sps, self.pps, self.pic
        size = 1 << log2_size
        bd = sps.bit_depth_luma
        lv_y, lv_cb, lv_cr = levels
        py = preds[0]
        pcb, pcr = (preds[1], preds[2]) if sps.chroma_format_idc \
            else (None, None)
        xc, yc = x0 // sps.sub_w, y0 // sps.sub_h
        if lv_y is not None:
            ts_y, rd_dir = getattr(self, "_inter_ts", (0, 0))
            d = self._deq(lv_y, self.cur_qp + sps.qp_bd_offset, log2_size,
                          bd, 0, True, ts=bool(ts_y))
            if ts_y:
                r = R.transform_skip_residual(d, bd)
                r = np.cumsum(r.astype(np.int16), axis=0 if rd_dir else 1,
                              dtype=np.int16).astype(np.int32)
            else:
                r = R.inverse_transform(d, bd)
            py = np.clip(py + r, 0, (1 << bd) - 1)
            pic.cbf_luma[y0 >> 2:(y0 + size) >> 2,
                         x0 >> 2:(x0 + size) >> 2] = True
        pic.planes[0][y0:y0 + size, x0:x0 + size] = \
            py.astype(pic.planes[0].dtype)
        if not sps.chroma_format_idc:
            return
        blocks = self._inter_chroma_blocks(x0, y0, log2_size)
        for c_idx, (pred, lvs) in ((1, (pcb, lv_cb)), (2, (pcr, lv_cr))):
            if not lvs:
                lvs = [None] * len(blocks)
            off = pps.cb_qp_offset if c_idx == 1 else pps.cr_qp_offset
            off += (self.qpst.cu_qp_offset_cb if c_idx == 1
                    else self.qpst.cu_qp_offset_cr)
            qp = R.chroma_qp(self.cur_qp, off, sps.chroma_format_idc,
                             sps.qp_bd_offset)
            out = pred.astype(np.int32).copy()
            for (bx, by, log2c), lv in zip(blocks, lvs):
                if lv is None:
                    continue
                csize = 1 << log2c
                d = self._deq(lv, qp, log2c, sps.bit_depth_chroma,
                              c_idx, True)
                out[by - yc:by - yc + csize, bx - xc:bx - xc + csize] = \
                    np.clip(out[by - yc:by - yc + csize,
                                bx - xc:bx - xc + csize]
                            + R.inverse_transform(d, sps.bit_depth_chroma),
                            0, (1 << sps.bit_depth_chroma) - 1)
            pic.planes[c_idx][yc:yc + out.shape[0],
                              xc:xc + out.shape[1]] = \
                out.astype(pic.planes[c_idx].dtype)

    def _set_motion(self, x0, y0, w, h, mi):
        pic = self.pic
        sl = np.s_[y0 >> 2:(y0 + h) >> 2, x0 >> 2:(x0 + w) >> 2]
        if mi.uses_l0:
            pic.mv_l0[sl] = mi.mv0
            pic.ref_l0[sl] = mi.ref0
            pic.ref_poc_l0[sl] = mi.poc0
        if mi.uses_l1:
            pic.mv_l1[sl] = mi.mv1
            pic.ref_l1[sl] = mi.ref1
            pic.ref_poc_l1[sl] = mi.poc1
        pic.mark_block_edges(x0, y0, w, h)

    def _encode_part_mode_inter(self, part, log2_size):
        """part_mode bins for inter CUs (mirror of the decoder's
        _decode_part_mode_inter; Table 9-34)."""
        from ..coding import mvs as MV
        e, cm, sps = self.e, self.cm, self.sps
        if part == MV.PART_2Nx2N:
            e.encode_bin(cm.at("part_mode", 0), 1)
            return
        e.encode_bin(cm.at("part_mode", 0), 0)
        if log2_size == sps.log2_min_cb_size:
            if part == MV.PART_2NxN:
                e.encode_bin(cm.at("part_mode", 1), 1)
                return
            e.encode_bin(cm.at("part_mode", 1), 0)
            if log2_size == 3:
                assert part == MV.PART_Nx2N
                return
            e.encode_bin(cm.at("part_mode", 2),
                         1 if part == MV.PART_Nx2N else 0)
            return
        if not sps.amp_enabled:
            e.encode_bin(cm.at("part_mode", 1),
                         1 if part == MV.PART_2NxN else 0)
            return
        horiz = part in (MV.PART_2NxN, MV.PART_2NxnU, MV.PART_2NxnD)
        e.encode_bin(cm.at("part_mode", 1), 1 if horiz else 0)
        if horiz:
            e.encode_bin(cm.at("part_mode", 3),
                         1 if part == MV.PART_2NxN else 0)
            if part != MV.PART_2NxN:
                e.encode_bypass(1 if part == MV.PART_2NxnD else 0)
        else:
            e.encode_bin(cm.at("part_mode", 3),
                         1 if part == MV.PART_Nx2N else 0)
            if part != MV.PART_Nx2N:
                e.encode_bypass(1 if part == MV.PART_nRx2N else 0)

    def _amp_cu(self, x0, y0, log2_size, depth):
        """Two-PU inter CU exercising 2NxN/Nx2N + the four AMP modes:
        per-PU AMVP (L0 ref 0) with a single CU-sized TU."""
        from ..coding import mvs as MV
        sps, pps, e, cm, pic = self.sps, self.pps, self.e, self.cm, self.pic
        size = 1 << log2_size
        gq = size >> 2
        pic.ct_depth[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = depth
        pic.qp_y[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = self.qp_y
        modes = (MV.PART_2NxN, MV.PART_Nx2N, MV.PART_2NxnU, MV.PART_2NxnD,
                 MV.PART_nLx2N, MV.PART_nRx2N)
        part = modes[int(self.rng.integers(0, 6))]
        pbs = MV.part_blocks(part, x0, y0, size)
        e.encode_bin(cm.at("cu_skip_flag", self._skip_ctx(x0, y0)), 0)
        e.encode_bin(cm.at("pred_mode_flag", 0), 0)
        self._encode_part_mode_inter(part, log2_size)
        ref_pocs0 = [p for p, _ in self.ref_list]
        nref0 = len(self.ref_list)
        bd = sps.bit_depth_luma
        pred_y = np.zeros((size, size), np.int32)
        wc, hc = size // sps.sub_w, size // sps.sub_h
        pred_cb = np.zeros((hc, wc), np.int32)
        pred_cr = np.zeros((hc, wc), np.int32)
        for i, (xp, yp, w, h) in enumerate(pbs):
            e.encode_bin(cm.at("merge_flag", 0), 0)
            if self.is_b:
                e.encode_bin(cm.at("inter_pred_idc", depth), 0)
                e.encode_bin(cm.at("inter_pred_idc", 4), 0)  # PRED_L0
            if nref0 > 1:
                self._encode_ref_idx(0, nref0)
            mvps = MV.amvp_candidates(pic, xp, yp, w, h, 0, 0, ref_pocs0,
                                      self.poc, tc=self.tmvp_ctx,
                                      lt0=self.ref_lt0, lt1=self.ref_lt1)
            mv, _ = self._motion_search(xp, yp, w, h, mvps[0], 0)
            self._encode_mvd((mv[0] - mvps[0][0], mv[1] - mvps[0][1]))
            e.encode_bin(cm.at("mvp_lx_flag", 0), 0)
            mi = MV.MotionInfo(mv0=tuple(mv), ref0=0, poc0=ref_pocs0[0])
            py, pcb, pcr = self._mc_pred(xp, yp, w, h, mi)
            pred_y[yp - y0:yp - y0 + h, xp - x0:xp - x0 + w] = py
            xcc, ycc = (xp - x0) // sps.sub_w, (yp - y0) // sps.sub_h
            pred_cb[ycc:ycc + h // sps.sub_h, xcc:xcc + w // sps.sub_w] = pcb
            pred_cr[ycc:ycc + h // sps.sub_h, xcc:xcc + w // sps.sub_w] = pcr
            self._set_motion(xp, yp, w, h, mi)
        preds = (pred_y, pred_cb, pred_cr)
        levels = self._inter_residual(x0, y0, log2_size, preds)
        lv_y, lv_cb, lv_cr = levels
        no_resid = (lv_y is None and all(v is None for v in lv_cb)
                    and all(v is None for v in lv_cr))
        e.encode_bin(cm.at("no_residual_data_flag", 0),
                     0 if no_resid else 1)
        if no_resid:
            self._recon_inter_cu(x0, y0, log2_size, preds, (None, [], []))
            pic.mark_intra_tu_edges(x0, y0, size)
            return
        self._emit_inter_tu(x0, y0, log2_size, levels)
        self._recon_inter_cu(x0, y0, log2_size, preds, levels)
        self.pic.mark_block_edges(x0, y0, size, size)

    def _coding_unit_p(self, x0, y0, log2_size, depth):
        """P/B-slice CU: choose skip / merge / AMVP(L0 or BI) / intra."""
        from ..coding import mvs as MV
        sps, e, cm, pic = self.sps, self.e, self.cm, self.pic
        size = 1 << log2_size
        if (self.cfg.amp and log2_size > sps.log2_min_cb_size
                and self.rng.random() < (1.0 if self.cfg.amp == "all"
                                         else float(self.cfg.amp))):
            self._amp_cu(x0, y0, log2_size, depth)
            return
        gq = size >> 2
        is_b = self.is_b
        pic.ct_depth[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = depth
        pic.qp_y[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = self.qp_y
        ref_pocs0 = [p for p, _ in self.ref_list]
        ref_pocs1 = [p for p, _ in self.ref_list_l1]
        nref0 = len(self.ref_list)
        nref1 = max(1, len(self.ref_list_l1))
        src = self.src[0][y0:y0 + size, x0:x0 + size]
        max_cand = 5

        cand = MV.merge_candidates(pic, x0, y0, size, size, 0,
                                   MV.PART_2Nx2N, max_cand, nref0,
                                   ref_pocs0, nref1, ref_pocs1, is_b,
                                   tc=self.tmvp_ctx, lt0=self.ref_lt0,
                                   lt1=self.ref_lt1)
        best_merge, merge_cost = 0, None
        merge_preds = {}
        for i, mi in enumerate(cand):
            preds = self._mc_pred(x0, y0, size, size, mi)
            merge_preds[i] = preds
            c = int(np.abs(src - preds[0]).sum())
            if merge_cost is None or c < merge_cost:
                best_merge, merge_cost = i, c

        # AMVP: search every L0 ref, keep the cheapest (ref bits penalty)
        best_ref, mvps0, mv_amvp, amvp_cost = 0, None, None, None
        for ridx in range(nref0):
            mvps_r = MV.amvp_candidates(pic, x0, y0, size, size, 0, ridx,
                                        ref_pocs0, self.poc,
                                        tc=self.tmvp_ctx, lt0=self.ref_lt0,
                                        lt1=self.ref_lt1)
            mv_r, cost_r = self._motion_search(x0, y0, size, size,
                                               mvp=mvps_r[0], ref_idx=ridx)
            cost_r += 2 * ridx
            if amvp_cost is None or cost_r < amvp_cost:
                best_ref, mvps0 = ridx, mvps_r
                mv_amvp, amvp_cost = mv_r, cost_r
        amvp_mi = MV.MotionInfo(mv0=tuple(mv_amvp), ref0=best_ref,
                                poc0=ref_pocs0[best_ref])
        # occasionally try explicit BI (same mv both lists) to exercise it
        bi_mi = None
        if is_b and ((x0 ^ y0) >> log2_size) % 3 == 0:
            bi_mi = MV.MotionInfo(mv0=tuple(mv_amvp), ref0=best_ref,
                                  poc0=ref_pocs0[best_ref],
                                  mv1=(mv_amvp[0] + 4, mv_amvp[1]),
                                  ref1=0, poc1=ref_pocs1[0])
            bi_preds = self._mc_pred(x0, y0, size, size, bi_mi)
            bi_cost = int(np.abs(src - bi_preds[0]).sum())
        use_bi = bi_mi is not None and bi_cost <= amvp_cost
        use_amvp = (bi_cost if use_bi else amvp_cost) + 4 * size < merge_cost
        mi_merge = cand[best_merge]

        intra_cost = None
        if self.cfg.p_intra_fallback:
            mode = self._choose_mode(x0, y0, size)
            ip = pic.predict_intra(0, x0, y0, min(size, 32), mode)
            intra_cost = int(np.abs(
                src[:min(size, 32), :min(size, 32)] - ip).sum()) \
                * (size * size) // (min(size, 32) ** 2)
        best_inter_cost = (bi_cost if use_bi else amvp_cost) \
            if use_amvp else merge_cost
        if intra_cost is not None and intra_cost * 2 < best_inter_cost:
            e.encode_bin(cm.at("cu_skip_flag",
                               self._skip_ctx(x0, y0)), 0)
            e.encode_bin(cm.at("pred_mode_flag", 0), 1)
            self._intra_cu_body(x0, y0, log2_size, depth)
            return

        if use_amvp:
            mi_used = bi_mi if use_bi else amvp_mi
            preds = self._mc_pred(x0, y0, size, size, mi_used)
        else:
            mi_used = mi_merge
            preds = merge_preds[best_merge]
        levels = self._inter_residual(x0, y0, log2_size, preds)
        lv_y_, lv_cb_, lv_cr_ = levels
        no_resid = (lv_y_ is None
                    and all(v is None for v in lv_cb_)
                    and all(v is None for v in lv_cr_))

        if not use_amvp and no_resid:
            # skip CU
            e.encode_bin(cm.at("cu_skip_flag", self._skip_ctx(x0, y0)), 1)
            self._encode_merge_idx(best_merge, max_cand)
            pic.skip_flag[y0 >> 2:(y0 >> 2) + gq,
                          x0 >> 2:(x0 >> 2) + gq] = True
            self._recon_inter_cu(x0, y0, log2_size, preds,
                                 (None, [], []))
            self._set_motion(x0, y0, size, size, mi_used)
            pic.mark_intra_tu_edges(x0, y0, size)  # CU edge = TU-grid edge
            return
        e.encode_bin(cm.at("cu_skip_flag", self._skip_ctx(x0, y0)), 0)
        e.encode_bin(cm.at("pred_mode_flag", 0), 0)
        e.encode_bin(cm.at("part_mode", 0), 1)  # PART_2Nx2N
        if not use_amvp:
            e.encode_bin(cm.at("merge_flag", 0), 1)
            self._encode_merge_idx(best_merge, max_cand)
        else:
            e.encode_bin(cm.at("merge_flag", 0), 0)
            if is_b:
                # inter_pred_idc: bin0 ctx=depth (BI?), then list bin ctx=4
                if use_bi:
                    e.encode_bin(cm.at("inter_pred_idc", depth), 1)
                else:
                    e.encode_bin(cm.at("inter_pred_idc", depth), 0)
                    e.encode_bin(cm.at("inter_pred_idc", 4), 0)  # L0
            if nref0 > 1:
                self._encode_ref_idx(mi_used.ref0, nref0)
            mvd0 = (mi_used.mv0[0] - mvps0[0][0],
                    mi_used.mv0[1] - mvps0[0][1])
            self._encode_mvd(mvd0)
            e.encode_bin(cm.at("mvp_lx_flag", 0), 0)
            if use_bi:
                mvps1 = MV.amvp_candidates(pic, x0, y0, size, size, 1, 0,
                                           ref_pocs1, self.poc,
                                           tc=self.tmvp_ctx,
                                           lt0=self.ref_lt0,
                                           lt1=self.ref_lt1)
                mvd1 = (mi_used.mv1[0] - mvps1[0][0],
                        mi_used.mv1[1] - mvps1[0][1])
                self._encode_mvd(mvd1)
                e.encode_bin(cm.at("mvp_lx_flag", 0), 0)
        self._set_motion(x0, y0, size, size, mi_used)
        # rqt_root_cbf (not coded for 2Nx2N merge)
        if use_amvp:
            e.encode_bin(cm.at("no_residual_data_flag", 0),
                         0 if no_resid else 1)
            if no_resid:
                self._recon_inter_cu(x0, y0, log2_size, preds,
                                     (None, [], []))
                pic.mark_intra_tu_edges(x0, y0, size)
                return
        self._emit_inter_tu(x0, y0, log2_size, levels)
        self._recon_inter_cu(x0, y0, log2_size, preds, levels)
        self.pic.mark_block_edges(x0, y0, size, size)

    def _emit_inter_tu(self, x0, y0, log2_size, levels):
        """Single-TU inter transform tree: optional split_transform_flag,
        chroma cbfs, cbf_luma, cu_qp_delta, residuals (mirror of decoder
        transform_tree/transform_unit for an unsplit inter CU)."""
        sps, e, cm = self.sps, self.e, self.cm
        lv_y, lv_cb, lv_cr = levels
        is422 = sps.chroma_format_idc == 2
        self.pic.mark_intra_tu_edges(x0, y0, 1 << log2_size)
        if (log2_size <= sps.log2_max_tb_size
                and log2_size > sps.log2_min_tb_size
                and 0 < sps.max_transform_hierarchy_depth_inter):
            e.encode_bin(cm.at("split_transform_flag", 5 - log2_size), 0)
        any_cb = any(lv is not None for lv in lv_cb)
        any_cr = any(lv is not None for lv in lv_cr)
        if sps.chroma_format_idc:
            e.encode_bin(cm.at("cbf_cbcr", 0),
                         0 if lv_cb[0] is None else 1)
            if is422:
                e.encode_bin(cm.at("cbf_cbcr", 0),
                             0 if lv_cb[1] is None else 1)
            e.encode_bin(cm.at("cbf_cbcr", 0),
                         0 if lv_cr[0] is None else 1)
            if is422:
                e.encode_bin(cm.at("cbf_cbcr", 0),
                             0 if lv_cr[1] is None else 1)
        if any_cb or any_cr:
            e.encode_bin(cm.at("cbf_luma", 1), 0 if lv_y is None else 1)
        else:
            assert lv_y is not None, "all-zero residual must use rootcbf=0"
        self._maybe_emit_cu_qp_delta(
            x0, y0, (lv_y is not None) or any_cb or any_cr)
        self._maybe_emit_cu_chroma_qp_offset(any_cb or any_cr)
        if lv_y is not None:
            ts_y, rd_dir = getattr(self, "_inter_ts", (0, 0))
            ts_ok = (self.pps.transform_skip_enabled and log2_size
                     <= self.pps.log2_max_transform_skip_block_size)
            encode_residual(e, cm, lv_y, log2_size, 0, 0,
                            transform_skip_allowed=bool(ts_ok),
                            ts_flag=ts_y,
                            rext=self.rext_enc, pred_inter=True,
                            rdpcm_flag=1 if ts_y else 0,
                            rdpcm_dir=rd_dir)
        blocks = self._inter_chroma_blocks(x0, y0, log2_size) \
            if sps.chroma_format_idc else []
        for c_idx, lvs in ((1, lv_cb), (2, lv_cr)):
            for (bx, by, log2c), lv in zip(blocks, lvs):
                if lv is not None:
                    ts_ok_c = (self.pps.transform_skip_enabled and log2c
                               <= self.pps
                               .log2_max_transform_skip_block_size)
                    encode_residual(e, cm, lv, log2c, c_idx, 0,
                                    transform_skip_allowed=bool(ts_ok_c),
                                    rext=self.rext_enc, pred_inter=True)

    def _skip_ctx(self, x0, y0):
        pic = self.pic
        ctx = 0
        if pic.available(x0, y0, x0 - 1, y0) \
                and pic.skip_flag[y0 >> 2, (x0 - 1) >> 2]:
            ctx += 1
        if pic.available(x0, y0, x0, y0 - 1) \
                and pic.skip_flag[(y0 - 1) >> 2, x0 >> 2]:
            ctx += 1
        return ctx

    def _slice_fp(self, si):
        """Effective filter params of slice si (defaults + overrides)."""
        base = dict(beta_offset=0, tc_offset=0,
                    disable=not self.cfg.deblocking,
                    sao=bool(self.cfg.sao), lf_across=True)
        fps = self.cfg.slice_filter_params
        if fps:
            base.update(fps[si % len(fps)])
        return base

    def _entry_offsets(self, sh, nal_type, seg_payloads):
        """Slice-header entry_point_offsets (7.4.7.1): byte distances
        between segment starts in the FINAL (emulation-prevented) NAL.

        The offsets live in the header, and the header bytes influence
        where emulation-prevention bytes land, so iterate to a fixed
        point (the offset values converge in a couple of rounds)."""
        sizes = [len(s) for s in seg_payloads]
        payload = b"".join(seg_payloads)
        offs = list(sizes[:-1])
        for _ in range(8):
            sh.entry_point_offsets = offs
            rbsp = sh.write_rbsp(self.sps, self.pps, nal_type, payload,
                                 nuh_layer_id=self.layer_id,
                                 vps=self.vps)
            hdr_len = len(rbsp) - len(payload)
            nalbytes = nalmod.write_nal_header(
                nal_type, self.layer_id, self._temporal_id) + rbsp
            ins = []
            zeros = 0
            for i, b in enumerate(nalbytes):
                if zeros >= 2 and b <= 3:
                    ins.append(i)
                    zeros = 0
                zeros = zeros + 1 if b == 0 else 0
            new_offs = []
            cum = 2 + hdr_len
            for s in sizes[:-1]:
                cnt = sum(1 for p in ins if cum < p <= cum + s)
                new_offs.append(s + cnt)
                cum += s
            if new_offs == offs:
                return offs
            offs = new_offs
        raise RuntimeError("entry_point_offsets did not converge")


class RaEncoder:
    """Random-access hierarchical-B GOP driver (mini-GOP of 4).

    Display-order frames in (`push`), decode-order access units out —
    POC order 0(I), 4(P), 2(B), 1(B), 3(B), 8(P), 6(B), ...  The
    decoder must reorder its output by POC via DPB bumping (reference:
    hevc_refs.c:224 ff_hevc_output_frame / :358 ff_hevc_bump_frame),
    which this GOP shape exists to exercise; the stream signals
    sps_max_num_reorder_pics=2.

    `recons` accumulates (poc, planes) reconstructions in decode order.
    """

    GOP = 4
    # (display offset in the group, type, rps_idx, L0 deltas, L1
    #  deltas, temporal_id, nal_type override).  Leaf Bs are never
    #  referenced: sub-layer non-reference TRAIL_N, droppable with -t.
    SCHED = [
        (4, "P", 0, (-4,), (), 0, None),
        (2, "B", 1, (-2,), (2,), 1, None),
        (1, "B", 2, (-1,), (1,), 2, nalmod.NAL_TRAIL_N),
        (3, "B", 3, (-1,), (1,), 2, nalmod.NAL_TRAIL_N),
    ]

    def __init__(self, cfg: EncoderConfig):
        assert cfg.gop == "ra"
        self.enc = IntraEncoder(cfg)
        self.buf: List[List[np.ndarray]] = []  # pending display frames
        self.base_poc = 0   # POC of the last encoded anchor
        self.n_pushed = 0
        self.recons: List[Tuple[int, list]] = []

    def _encode(self, planes, poc, ftype, rps_idx, l0, l1,
                tid=0, ntype=None) -> bytes:
        enc = self.enc
        enc._sched = (poc, ftype, rps_idx,
                      [poc + d for d in l0], [poc + d for d in l1],
                      tid, ntype)
        try:
            au = enc.encode_frame(planes)
        finally:
            enc._sched = None
        self.recons.append((poc, [p.copy() for p in enc.recon_planes]))
        return au

    def push(self, planes: List[np.ndarray]) -> bytes:
        """Feed the next display-order frame; returns 0+ encoded AUs."""
        out = b""
        if self.n_pushed == 0:
            out = self._encode(planes, 0, "I", 0, (), ())
        else:
            self.buf.append(planes)
            if len(self.buf) == self.GOP:
                sched = self.SCHED
                if self.enc.cfg.cra_anchors:
                    # anchor -> intra CRA; in-between Bs -> RASL leading
                    # pictures (reference semantics: hevcdec.c max_ra)
                    rasl = {2: nalmod.NAL_RASL_R, 1: nalmod.NAL_RASL_N,
                            3: nalmod.NAL_RASL_N}
                    sched = [(4, "CRA", 5, (), (), 0, nalmod.NAL_CRA_NUT)]
                    sched += [(off, ft, rp, l0, l1, tid, rasl[off])
                              for off, ft, rp, l0, l1, tid, _ in
                              self.SCHED[1:]]
                for off, ftype, rps_idx, l0, l1, tid, nt in sched:
                    out += self._encode(self.buf[off - 1],
                                        self.base_poc + off,
                                        ftype, rps_idx, l0, l1, tid, nt)
                self.base_poc += self.GOP
                self.buf = []
        self.n_pushed += 1
        return out

    def flush(self) -> bytes:
        """Encode a truncated tail group as a low-delay P chain."""
        out = b""
        for i, planes in enumerate(self.buf):
            out += self._encode(planes, self.base_poc + i + 1,
                                "P", 4, (-1,), ())
        self.buf = []
        return out

    def encode(self, frames) -> bytes:
        stream = b"".join(self.push(f) for f in frames)
        return stream + self.flush()
