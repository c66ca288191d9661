// Copied from hevc_tpu/native/stage_a_syntax.h at e99b487.
// Native stage-A: syntax layer + CTU loop + extern "C" entry points.
// Included only from stage_a.cpp (reopens its unnamed namespace).
// Mirrors hevc_tpu/decoder/core.py SliceDecoder exactly — see the
// stage_a.cpp header comment for the citation map.
#ifndef HEVC_TPU_STAGE_A_SYNTAX_H
#define HEVC_TPU_STAGE_A_SYNTAX_H

namespace hevc_native {
namespace {

// ---- residual (7.3.8.11) -------------------------------------------------
// scanIdx derivation (7.4.9.11)
static int scan_idx_for_intra(int mode, int log2_size, int c_idx, int fmt) {
    if (log2_size == 2 || (log2_size == 3 && (c_idx == 0 || fmt == 3))) {
        if (6 <= mode && mode <= 14)
            return 2;
        if (22 <= mode && mode <= 30)
            return 1;
    }
    return 0;
}

// decode one TB's levels into the pool; returns lvl offset, sets *ts
// plus the resolved rext modifiers (*rdpcm = 0/1/2 accumulate, *rot =
// 4x4 skip rotation) — mirror of SliceDecoder._decode_levels
static int64_t decode_levels(Dec& d, int c_idx, int log2_size, int mode,
                             const CuState& cu, int32_t* ts,
                             int32_t* rdpcm, int32_t* rot) {
    int scan = cu.pred_intra
                   ? scan_idx_for_intra(mode, log2_size, c_idx, d.P.chroma_fmt)
                   : 0;
    int ts_allowed = d.P.ts_enabled && !cu.tq_bypass
                     && log2_size <= d.P.log2_max_ts;
    int size = 1 << log2_size;
    int64_t loff;
    int16_t* lv = d.alloc_lvl(size * size, &loff);
    if (!lv)
        return -1;
    int si = (scan * 4 + (log2_size - 2)) * 3;
    RextP rx{d.P.persistent_rice, d.P.ts_context, d.P.implicit_rdpcm,
             d.P.explicit_rdpcm};
    int has_rx = rx.persistent_rice || rx.ts_context || rx.implicit_rdpcm
                 || rx.explicit_rdpcm;
    int32_t rd_out[2] = {0, 0};
    ProfSpan _ps(0);
    decode_residual_core_impl(&d.cb, d.ctx, d.off, log2_size, c_idx, scan,
                         d.P.sdh, ts_allowed, cu.tq_bypass,
                         d.scans + d.scan_off[si],
                         d.scans + d.scan_off[si + 1],
                         d.scans + d.scan_off[si + 2], lv, ts,
                         has_rx ? &rx : nullptr,
                         cu.pred_intra ? 0 : 1,
                         cu.pred_intra ? mode : -1, d.stat, rd_out);
    *rdpcm = 0;
    if (*ts || cu.tq_bypass) {
        if (rd_out[0]) {
            *rdpcm = rd_out[1] ? 2 : 1;
        } else if (d.P.implicit_rdpcm && cu.pred_intra
                   && (mode == 10 || mode == 26)) {
            *rdpcm = (mode == 26) ? 2 : 1;
        }
    }
    *rot = d.P.ts_rotation && *ts && log2_size == 2 && cu.pred_intra;
    return loff;
}

static int matrix_id(const Dec& d, int c_idx, int log2_size, int ts,
                     const CuState& cu) {
    if (!d.P.have_scaling || (ts && log2_size > 2))
        return -1;
    return 3 * (cu.pred_intra ? 0 : 1) + c_idx;
}

// mirror of SliceDecoder._recon_block (plan mode); returns the record
// index (-1 when none emitted) so chroma CCP rows can reference the
// TU's luma record
static int64_t recon_block(Dec& d, int c_idx, int x, int y, int size,
                           int mode, int64_t lvl_off, int ts,
                           const CuState& cu, int rdpcm = 0, int rot = 0,
                           int ccp = 0, int64_t ccp_ref = -1) {
    if (!cu.pred_intra && lvl_off < 0 && !ccp)
        return -1;  // inter TU, no residual: MC prediction is final
    int log2_size = 31 - __builtin_clz(size);
    int use_dst = cu.pred_intra && log2_size == 2 && c_idx == 0;
    int32_t* r = d.new_rec();
    if (!r)
        return -1;
    r[REC_KIND] = cu.pred_intra ? KIND_INTRA : KIND_RESID;
    r[REC_PLANE] = c_idx;
    r[REC_X] = x;
    r[REC_Y] = y;
    r[REC_W] = size;
    r[REC_H] = 0;  // square (BlockRecord default)
    r[REC_MODE] = mode;
    r[REC_QP] = d.component_qp(c_idx);
    r[REC_FLAGS] = (use_dst ? F_DST : 0) | (ts ? F_TS : 0)
                   | (cu.tq_bypass ? F_TQB : 0) | (rot ? F_ROT : 0)
                   | (rdpcm == 1 ? F_RDPCM_H : 0)
                   | (rdpcm == 2 ? F_RDPCM_V : 0);
    r[REC_MTX] = matrix_id(d, c_idx, log2_size, ts, cu);
    r[REC_LVL] = (int32_t)lvl_off;
    r[REC_CCP] = ccp;
    r[REC_CCPREF] = ccp ? (int32_t)ccp_ref : 0;
    return d.n_rec - 1;
}

// cu_qp_delta_abs/sign (7.3.8.10; 9.3.3.9 TR cMax 5 prefix + EG0)
static void decode_cu_qp_delta(Dec& d, const CuState& cu) {
    int prefix = 0, inc = 0;
    while (prefix < 5 && d.cb.decode_bin(d.cx(CU_QP_DELTA, inc))) {
        prefix++;
        inc = 1;
    }
    int val = prefix;
    if (prefix >= 5) {
        int k = 0, suffix = 0;
        while (d.cb.decode_bypass()) {
            suffix += 1 << k;
            k++;
        }
        while (k) {
            k--;
            suffix += d.cb.decode_bypass() << k;
        }
        val += suffix;
    }
    if (val && d.cb.decode_bypass())
        val = -val;
    d.qp_delta_val = val;
    d.qp_delta_coded = true;
    d.set_qpy(cu.x0, cu.y0);
}

// cu_chroma_qp_offset_flag/idx (7.3.8.10; mirror of
// SliceDecoder._decode_cu_chroma_qp_offset)
static void decode_cu_chroma_qp_offset(Dec& d) {
    if (d.cb.decode_bin(d.cx(CU_CHROMA_QP_OFFSET_FLAG, 0))) {
        int idx = 0;
        int n = d.P.n_chroma_offsets;
        if (n > 1) {
            int cmax = n - 1 > 5 ? n - 1 : 5;
            while (idx < cmax
                   && d.cb.decode_bin(d.cx(CU_CHROMA_QP_OFFSET_IDX, 0)))
                idx++;
        }
        d.cu_qp_offset_cb = d.cb_qp_offset_list[idx];
        d.cu_qp_offset_cr = d.cr_qp_offset_list[idx];
    } else {
        d.cu_qp_offset_cb = 0;
        d.cu_qp_offset_cr = 0;
    }
    d.chroma_qp_offset_coded = true;
}

// cross_comp_pred (7.3.8.12) -> res_scale_val
static int decode_ccp(Dec& d, int idx) {
    int i = 0;
    while (i < 4 && d.cb.decode_bin(d.cx(LOG2_RES_SCALE_ABS,
                                         4 * idx + i)))
        i++;
    if (i == 0)
        return 0;
    int sign = d.cb.decode_bin(d.cx(RES_SCALE_SIGN, idx));
    return (1 << (i - 1)) * (1 - 2 * sign);
}

// ---- transform tree / unit (7.3.8.8 / 7.3.8.10) ---------------------------
static void transform_unit(Dec& d, int x0, int y0, int xb, int yb,
                           int log2_size, int depth, int blk_idx,
                           int cbf_luma, const int cbf_cb[2],
                           const int cbf_cr[2], CuState& cu) {
    const Params& P = d.P;
    int size = 1 << log2_size;
    d.mark_intra_tu_edges(x0, y0, size);
    // cu_qp_delta: first TU of the QG with any coded residual
    int cbf_chroma = cbf_cb[0] || cbf_cr[0]
                     || (P.chroma_fmt == 2 && (cbf_cb[1] || cbf_cr[1]));
    if (P.cu_qp_delta_enabled && !d.qp_delta_coded
        && (cbf_luma || cbf_chroma))
        decode_cu_qp_delta(d, cu);
    if (P.chroma_qp_offset_enabled && cbf_chroma && !cu.tq_bypass
        && !d.chroma_qp_offset_coded)
        decode_cu_chroma_qp_offset(d);
    // ---- luma ----
    int mode_y = d.intra_mode_y[d.at4(y0 >> 2, x0 >> 2)];
    int64_t lv_y = -1;
    int32_t ts_y = 0, rd_y = 0, rot_y = 0;
    if (cbf_luma) {
        lv_y = decode_levels(d, 0, log2_size, mode_y, cu, &ts_y, &rd_y,
                             &rot_y);
        for (int j = y0 >> 2; j < (y0 + size) >> 2; j++)
            for (int i = x0 >> 2; i < (x0 + size) >> 2; i++)
                d.cbf_luma_map[d.at4(j, i)] = 1;
    }
    int64_t rec_y = recon_block(d, 0, x0, y0, size, mode_y, lv_y, ts_y,
                                cu, rd_y, rot_y);
    // ---- chroma ----
    bool chroma_here = P.chroma_fmt != 0
                       && (log2_size > 2 || P.chroma_fmt == 3
                           || blk_idx == 3);
    if (!chroma_here)
        return;
    int fmt = P.chroma_fmt;
    // cross-component prediction: 4:4:4, luma residual, inter or DM
    bool cross = P.ccp_enabled && cbf_luma && fmt == 3
                 && (!cu.pred_intra || cu.chroma_dm);
    int bx[2], by[2], bl[2];
    int n_blk = 1;
    if (fmt == 3) {
        bx[0] = x0;
        by[0] = y0;
        bl[0] = log2_size;
    } else if (fmt == 2) {
        int xc, yc, log2c;
        if (log2_size == 2) {
            xc = xb >> 1;
            yc = yb;
            log2c = 2;
        } else {
            xc = x0 >> 1;
            yc = y0;
            log2c = log2_size - 1;
        }
        bx[0] = xc;
        by[0] = yc;
        bl[0] = log2c;
        bx[1] = xc;
        by[1] = yc + (1 << log2c);
        bl[1] = log2c;
        n_blk = 2;
    } else if (log2_size == 2) {
        bx[0] = xb >> 1;
        by[0] = yb >> 1;
        bl[0] = 2;
    } else {
        bx[0] = x0 >> 1;
        by[0] = y0 >> 1;
        bl[0] = log2_size - 1;
    }
    for (int ci = 1; ci <= 2; ci++) {
        const int* pair = ci == 1 ? cbf_cb : cbf_cr;
        int mode_c = cu.chroma_mode;
        if (fmt == 3 && cu.n_chroma_modes > 1 && log2_size == 2)
            mode_c = cu.chroma_modes[blk_idx];  // 4:4:4 NxN: per PB
        if (fmt == 2)
            mode_c = CHROMA_422_MODE[mode_c];
        int ccp_val = cross ? decode_ccp(d, ci - 1) : 0;
        for (int half = 0; half < n_blk; half++) {
            int csize = 1 << bl[half];
            int cbf = pair[half];
            int64_t lv = -1;
            int32_t ts = 0, rd_c = 0, rot_c = 0;
            if (cbf)
                lv = decode_levels(d, ci, bl[half], mode_c, cu, &ts,
                                   &rd_c, &rot_c);
            recon_block(d, ci, bx[half], by[half], csize, mode_c, lv, ts,
                        cu, rd_c, rot_c, ccp_val,
                        ccp_val ? rec_y : -1);
        }
    }
}

static void transform_tree(Dec& d, int x0, int y0, int xb, int yb,
                           int log2_size, int depth, int blk_idx,
                           const int cbf_cb_par[2], const int cbf_cr_par[2],
                           CuState& cu) {
    const Params& P = d.P;
    bool intra_split_here = cu.intra_split && depth == 0;
    bool inter_split_here = cu.inter_split && depth == 0;
    int split;
    if (log2_size <= P.log2_max_tb && log2_size > P.log2_min_tb
        && depth < cu.max_trafo_depth && !intra_split_here) {
        split = d.cb.decode_bin(d.cx(SPLIT_TRANSFORM_FLAG, 5 - log2_size));
    } else {
        split = (log2_size > P.log2_max_tb || intra_split_here
                 || inter_split_here)
                    ? 1
                    : 0;
    }
    bool chroma_here = P.chroma_fmt != 0
                       && (log2_size > 2 || P.chroma_fmt == 3);
    bool is422 = P.chroma_fmt == 2;
    int cbf_cb[2] = {cbf_cb_par[0], cbf_cb_par[1]};
    int cbf_cr[2] = {cbf_cr_par[0], cbf_cr_par[1]};
    if (chroma_here) {
        bool second = is422 && (!split || log2_size == 3);
        if (depth == 0 || cbf_cb_par[0]) {
            cbf_cb[0] = d.cb.decode_bin(d.cx(CBF_CBCR, depth));
            cbf_cb[1] = second ? d.cb.decode_bin(d.cx(CBF_CBCR, depth))
                               : cbf_cb[0];
        } else {
            cbf_cb[0] = cbf_cb[1] = 0;
        }
        if (depth == 0 || cbf_cr_par[0]) {
            cbf_cr[0] = d.cb.decode_bin(d.cx(CBF_CBCR, depth));
            cbf_cr[1] = second ? d.cb.decode_bin(d.cx(CBF_CBCR, depth))
                               : cbf_cr[0];
        } else {
            cbf_cr[0] = cbf_cr[1] = 0;
        }
    } else if (depth == 0) {
        cbf_cb[0] = cbf_cb[1] = cbf_cr[0] = cbf_cr[1] = 0;
    }
    if (split) {
        int half = 1 << (log2_size - 1);
        const int dx[4] = {0, 1, 0, 1}, dy[4] = {0, 0, 1, 1};
        for (int i = 0; i < 4; i++)
            transform_tree(d, x0 + dx[i] * half, y0 + dy[i] * half, x0, y0,
                           log2_size - 1, depth + 1, i, cbf_cb, cbf_cr, cu);
    } else {
        int cbf_luma = 1;
        if (cu.pred_intra || depth != 0 || cbf_cb[0] || cbf_cb[1]
            || cbf_cr[0] || cbf_cr[1])
            cbf_luma = d.cb.decode_bin(d.cx(CBF_LUMA, depth == 0 ? 1 : 0));
        transform_unit(d, x0, y0, xb, yb, log2_size, depth, blk_idx,
                       cbf_luma, cbf_cb, cbf_cr, cu);
    }
}

// ---- inter syntax helpers -------------------------------------------------
static int decode_merge_idx(Dec& d) {
    int max_cand = d.P.max_merge;
    if (max_cand <= 1)
        return 0;
    if (!d.cb.decode_bin(d.cx(MERGE_IDX, 0)))
        return 0;
    int idx = 1;
    while (idx < max_cand - 1 && d.cb.decode_bypass())
        idx++;
    return idx;
}

static int decode_ref_idx(Dec& d, int num_ref) {
    if (num_ref <= 1)
        return 0;
    if (!d.cb.decode_bin(d.cx(REF_IDX_L0, 0)))
        return 0;
    if (num_ref == 2)
        return 1;
    if (!d.cb.decode_bin(d.cx(REF_IDX_L0, 1)))
        return 1;
    int idx = 2;
    while (idx < num_ref - 1 && d.cb.decode_bypass())
        idx++;
    return idx;
}

static int decode_eg1(Dec& d) {
    int sym = 0, count = 1;
    for (;;) {
        int b = d.cb.decode_bypass();
        sym += b << count;
        count++;
        if (!b)
            break;
    }
    count -= 1;
    if (count)
        sym += d.cb.decode_bypass_bits(count);
    return sym;
}

static void decode_mvd(Dec& d, int* mx, int* my) {
    int g0x = d.cb.decode_bin(d.cx(ABS_MVD_GREATER0_FLAG, 0));
    int g0y = d.cb.decode_bin(d.cx(ABS_MVD_GREATER0_FLAG, 0));
    int g1x = g0x ? d.cb.decode_bin(d.cx(ABS_MVD_GREATER1_FLAG, 1)) : 0;
    int g1y = g0y ? d.cb.decode_bin(d.cx(ABS_MVD_GREATER1_FLAG, 1)) : 0;
    int out[2];
    const int g0s[2] = {g0x, g0y}, g1s[2] = {g1x, g1y};
    for (int i = 0; i < 2; i++) {
        int a = 0;
        if (g0s[i]) {
            a = g1s[i] ? decode_eg1(d) + 2 : 1;
            if (d.cb.decode_bypass())
                a = -a;
        }
        out[i] = a;
    }
    *mx = out[0];
    *my = out[1];
}

static int decode_inter_pred_idc(Dec& d, int n_w, int n_h, int depth) {
    if (n_w + n_h != 12) {
        if (d.cb.decode_bin(d.cx(INTER_PRED_IDC, depth)))
            return 2;  // PRED_BI
    }
    if (d.cb.decode_bin(d.cx(INTER_PRED_IDC, 4)))
        return 1;  // PRED_L1
    return 0;      // PRED_L0
}

// weighted-prediction table lookup: [list][plane][ref]
static void wp_of(const Dec& d, int lst, int plane, int ridx, int32_t* w,
                  int32_t* o) {
    int i = (lst * 3 + plane) * 16 + ridx;
    *w = d.wp_w[i];
    *o = d.wp_o[i];
}

// mirror of SliceDecoder._inter_pb (plan mode): emit MC records + update
// the motion field maps
static void inter_pb_impl(Dec& d, int x_pb, int y_pb, int n_w, int n_h,
                     const MI& mi) {
    const Params& P = d.P;
    int xc = x_pb / P.sub_w, yc = y_pb / P.sub_h;
    int wc = n_w / P.sub_w, hc = n_h / P.sub_h;
    bool bi = mi.uses_l0() && mi.uses_l1();
    for (int c = 0; c < (P.chroma_fmt ? 3 : 1); c++) {
        int32_t* r = d.new_rec();
        if (!r)
            return;
        r[REC_KIND] = KIND_MC;
        r[REC_PLANE] = c;
        r[REC_X] = c ? xc : x_pb;
        r[REC_Y] = c ? yc : y_pb;
        r[REC_W] = c ? wc : n_w;
        r[REC_H] = c ? hc : n_h;
        r[REC_LOG2WD] = P.has_wp ? (c == 0 ? P.wp_log2wd_luma
                                           : P.wp_log2wd_chroma)
                                 : -1;
        if (bi) {
            r[REC_FLAGS] = F_BI;
            r[REC_MVX0] = mi.mvx0;
            r[REC_MVY0] = mi.mvy0;
            r[REC_REF0] = mi.ref0;
            r[REC_MVX1] = mi.mvx1;
            r[REC_MVY1] = mi.mvy1;
            r[REC_REF1] = mi.ref1;
            if (P.has_wp) {
                wp_of(d, 0, c, mi.ref0, &r[REC_WPW0], &r[REC_WPO0]);
                wp_of(d, 1, c, mi.ref1, &r[REC_WPW1], &r[REC_WPO1]);
            }
        } else {
            int lx = mi.uses_l0() ? 0 : 1;
            r[REC_FLAGS] = lx ? F_LX : 0;
            r[REC_MVX0] = lx == 0 ? mi.mvx0 : mi.mvx1;
            r[REC_MVY0] = lx == 0 ? mi.mvy0 : mi.mvy1;
            r[REC_REF0] = lx == 0 ? mi.ref0 : mi.ref1;
            if (P.has_wp)
                wp_of(d, lx, c, r[REC_REF0], &r[REC_WPW0], &r[REC_WPO0]);
        }
    }
    int y4 = y_pb >> 2, x4 = x_pb >> 2;
    for (int j = 0; j < (n_h >> 2); j++)
        for (int i = 0; i < (n_w >> 2); i++) {
            int k = d.at4(y4 + j, x4 + i);
            if (mi.uses_l0()) {
                d.mv_l0[2 * k] = mi.mvx0;
                d.mv_l0[2 * k + 1] = mi.mvy0;
                d.ref_l0[k] = (int8_t)mi.ref0;
                d.ref_poc_l0[k] = mi.poc0;
            }
            if (mi.uses_l1()) {
                d.mv_l1[2 * k] = mi.mvx1;
                d.mv_l1[2 * k + 1] = mi.mvy1;
                d.ref_l1[k] = (int8_t)mi.ref1;
                d.ref_poc_l1[k] = mi.poc1;
            }
        }
    d.mark_block_edges(x_pb, y_pb, n_w, n_h);
}

// prediction_unit (7.3.8.6): merge or AMVP; returns true if merge
static void inter_pb(Dec& d, int x_pb, int y_pb, int n_w, int n_h,
                     const MI& mi) {
    ProfSpan _p(2);
    inter_pb_impl(d, x_pb, y_pb, n_w, n_h, mi);
}

static bool prediction_unit(Dec& d, int x_pb, int y_pb, int n_w, int n_h,
                            int part_idx, int part_mode, int depth) {
    const Params& P = d.P;
    bool is_b = P.slice_type == SLICE_B;
    if (d.cb.decode_bin(d.cx(MERGE_FLAG, 0))) {
        int idx = decode_merge_idx(d);
        MI cand[5];
        d.merge_candidates(x_pb, y_pb, n_w, n_h, part_idx, part_mode, cand);
        inter_pb(d, x_pb, y_pb, n_w, n_h, cand[idx]);
        return true;
    }
    int idc = is_b ? decode_inter_pred_idc(d, n_w, n_h, depth) : 0;
    MI mi;
    if (idc != 1) {  // uses L0
        int ref_idx = decode_ref_idx(d, P.nref0);
        int mvdx, mvdy;
        decode_mvd(d, &mvdx, &mvdy);
        int mvp_flag = d.cb.decode_bin(d.cx(MVP_LX_FLAG, 0));
        int cands[2][2];
        d.amvp_candidates(x_pb, y_pb, n_w, n_h, 0, ref_idx, cands);
        mi.mvx0 = cands[mvp_flag][0] + mvdx;
        mi.mvy0 = cands[mvp_flag][1] + mvdy;
        mi.ref0 = ref_idx;
        mi.poc0 = d.list_poc0[ref_idx];
    }
    if (idc != 0) {  // uses L1
        int ref_idx = decode_ref_idx(d, P.nref1);
        int mvdx = 0, mvdy = 0;
        if (!(P.mvd_l1_zero && idc == 2))
            decode_mvd(d, &mvdx, &mvdy);
        int mvp_flag = d.cb.decode_bin(d.cx(MVP_LX_FLAG, 0));
        int cands[2][2];
        d.amvp_candidates(x_pb, y_pb, n_w, n_h, 1, ref_idx, cands);
        mi.mvx1 = cands[mvp_flag][0] + mvdx;
        mi.mvy1 = cands[mvp_flag][1] + mvdy;
        mi.ref1 = ref_idx;
        mi.poc1 = d.list_poc1[ref_idx];
    }
    inter_pb(d, x_pb, y_pb, n_w, n_h, mi);
    return false;
}

// part_mode for inter CUs (9.3.3.7 Table 9-34)
static int decode_part_mode_inter(Dec& d, int log2_size) {
    const Params& P = d.P;
    if (d.cb.decode_bin(d.cx(PART_MODE, 0)))
        return PART_2Nx2N;
    if (log2_size == P.log2_min_cb) {
        if (d.cb.decode_bin(d.cx(PART_MODE, 1)))
            return PART_2NxN;
        if (log2_size == 3)
            return PART_Nx2N;
        if (d.cb.decode_bin(d.cx(PART_MODE, 2)))
            return PART_Nx2N;
        return PART_NxN;
    }
    if (!P.amp_enabled) {
        if (d.cb.decode_bin(d.cx(PART_MODE, 1)))
            return PART_2NxN;
        return PART_Nx2N;
    }
    if (d.cb.decode_bin(d.cx(PART_MODE, 1))) {
        if (d.cb.decode_bin(d.cx(PART_MODE, 3)))
            return PART_2NxN;
        return d.cb.decode_bypass() ? PART_2NxnD : PART_2NxnU;
    }
    if (d.cb.decode_bin(d.cx(PART_MODE, 3)))
        return PART_Nx2N;
    return d.cb.decode_bypass() ? PART_nRx2N : PART_nLx2N;
}

// PU rectangles of one CU (mirror of mvs.py part_blocks)
static int part_blocks(int part, int x0, int y0, int size, int out[4][4]) {
    int half = size >> 1, q = size >> 2;
    switch (part) {
    case PART_2Nx2N: {
        int b[1][4] = {{x0, y0, size, size}};
        memcpy(out, b, sizeof(b));
        return 1;
    }
    case PART_2NxN: {
        int b[2][4] = {{x0, y0, size, half}, {x0, y0 + half, size, half}};
        memcpy(out, b, sizeof(b));
        return 2;
    }
    case PART_Nx2N: {
        int b[2][4] = {{x0, y0, half, size}, {x0 + half, y0, half, size}};
        memcpy(out, b, sizeof(b));
        return 2;
    }
    case PART_2NxnU: {
        int b[2][4] = {{x0, y0, size, q}, {x0, y0 + q, size, size - q}};
        memcpy(out, b, sizeof(b));
        return 2;
    }
    case PART_2NxnD: {
        int b[2][4] = {{x0, y0, size, size - q},
                       {x0, y0 + size - q, size, q}};
        memcpy(out, b, sizeof(b));
        return 2;
    }
    case PART_nLx2N: {
        int b[2][4] = {{x0, y0, q, size}, {x0 + q, y0, size - q, size}};
        memcpy(out, b, sizeof(b));
        return 2;
    }
    case PART_nRx2N: {
        int b[2][4] = {{x0, y0, size - q, size},
                       {x0 + size - q, y0, q, size}};
        memcpy(out, b, sizeof(b));
        return 2;
    }
    default: {  // PART_NxN
        int b[4][4] = {{x0, y0, half, half},
                       {x0 + half, y0, half, half},
                       {x0, y0 + half, half, half},
                       {x0 + half, y0 + half, half, half}};
        memcpy(out, b, sizeof(b));
        return 4;
    }
    }
}

static void inter_cu(Dec& d, int x0, int y0, int log2_size, int depth,
                     CuState& cu) {
    const Params& P = d.P;
    int size = 1 << log2_size;
    cu.pred_intra = false;
    cu.intra_split = false;
    cu.chroma_mode = 0;
    int part = decode_part_mode_inter(d, log2_size);
    int pbs[4][4];
    int n_pb = part_blocks(part, x0, y0, size, pbs);
    bool first_merge = false;
    for (int i = 0; i < n_pb; i++) {
        bool merged = prediction_unit(d, pbs[i][0], pbs[i][1], pbs[i][2],
                                      pbs[i][3], i, part, depth);
        if (i == 0)
            first_merge = merged;
    }
    int rqt_root_cbf = 1;
    if (!(part == PART_2Nx2N && first_merge))
        rqt_root_cbf = d.cb.decode_bin(d.cx(NO_RESIDUAL_DATA_FLAG, 0));
    if (rqt_root_cbf) {
        cu.inter_split = P.max_tr_depth_inter == 0 && part != PART_2Nx2N;
        cu.max_trafo_depth = P.max_tr_depth_inter;
        const int one[2] = {1, 1};
        transform_tree(d, x0, y0, x0, y0, log2_size, 0, 0, one, one, cu);
    } else {
        d.mark_intra_tu_edges(x0, y0, size);
    }
}

// PCM coding unit (7.3.8.7 pcm_sample)
static void pcm_cu(Dec& d, int x0, int y0, int log2_size, int depth,
                   CuState& cu) {
    const Params& P = d.P;
    int size = 1 << log2_size;
    int64_t pos = d.cb.begin_pcm();
    int64_t bitpos = pos * 8;
    const uint8_t* data = d.rbsp;
    auto read = [&](int nbits) -> int {
        int v = 0;
        for (int k = 0; k < nbits; k++) {
            v = (v << 1)
                | ((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
            bitpos++;
        }
        return v;
    };
    // blocks: (plane, xs, ys, w, h, lvl_off) in plane order
    int n_planes = P.chroma_fmt ? 3 : 1;
    int bxs[3], bys[3], bws[3], bhs[3];
    int64_t boffs[3];
    for (int c = 0; c < n_planes; c++) {
        int w, h, pbd, bd, xs, ys;
        if (c == 0) {
            w = h = size;
            pbd = P.pcm_bd_luma;
            bd = P.bd_luma;
            xs = x0;
            ys = y0;
        } else {
            w = size / P.sub_w;
            h = size / P.sub_h;
            pbd = P.pcm_bd_chroma;
            bd = P.bd_chroma;
            xs = x0 / P.sub_w;
            ys = y0 / P.sub_h;
        }
        int shift = bd - pbd;
        int64_t loff;
        int16_t* blk = d.alloc_lvl(w * h, &loff);
        if (!blk)
            return;
        for (int yy = 0; yy < h; yy++)
            for (int xx = 0; xx < w; xx++)
                blk[yy * w + xx] = (int16_t)(read(pbd) << shift);
        bxs[c] = xs;
        bys[c] = ys;
        bws[c] = w;
        bhs[c] = h;
        boffs[c] = loff;
    }
    d.cb.init_at((bitpos + 7) >> 3);

    // bookkeeping: PCM CU is MODE_INTRA; neighbours' MPM sees INTRA_DC
    int gq = size >> 2;
    d.fill4<int8_t>(d.intra_mode_y, x0, y0, gq, 1);  // INTRA_DC
    d.fill4<uint8_t>(d.is_intra, x0, y0, gq, 1);
    d.fill4<int8_t>(d.ct_depth, x0, y0, gq, (int8_t)depth);
    d.fill4<int8_t>(d.qp_map, x0, y0, gq, (int8_t)P.slice_qp);
    if (P.pcm_filter_disabled)
        d.fill4<uint8_t>(d.no_filter, x0, y0, gq, 1);
    d.mark_intra_tu_edges(x0, y0, size);

    for (int c = 0; c < n_planes; c++) {
        int32_t* r = d.new_rec();
        if (!r)
            return;
        r[REC_KIND] = KIND_PCM;
        r[REC_PLANE] = c;
        r[REC_X] = bxs[c];
        r[REC_Y] = bys[c];
        r[REC_W] = bws[c];
        r[REC_H] = bhs[c];
        r[REC_LVL] = (int32_t)boffs[c];
    }
    (void)cu;
}

// coding_unit (7.3.8.5; mirror of SliceDecoder.coding_unit)
static void coding_unit(Dec& d, int x0, int y0, int log2_size, int depth) {
    const Params& P = d.P;
    int size = 1 << log2_size;
    CuState cu;
    cu.x0 = x0;
    cu.y0 = y0;
    cu.log2_size = log2_size;
    cu.tq_bypass = 0;
    int gq = size >> 2;
    if (P.tq_bypass_enabled) {
        cu.tq_bypass = d.cb.decode_bin(d.cx(CU_TRANSQUANT_BYPASS_FLAG, 0));
        if (cu.tq_bypass) {
            d.fill4<uint8_t>(d.tq_bypass, x0, y0, gq, 1);
            d.fill4<uint8_t>(d.no_filter, x0, y0, gq, 1);
        }
    }
    if (P.slice_type != SLICE_I) {
        int ctx = 0;
        if (d.available(x0, y0, x0 - 1, y0)
            && d.skip_flag[d.at4(y0 >> 2, (x0 - 1) >> 2)])
            ctx++;
        if (d.available(x0, y0, x0, y0 - 1)
            && d.skip_flag[d.at4((y0 - 1) >> 2, x0 >> 2)])
            ctx++;
        d.fill4<int8_t>(d.ct_depth, x0, y0, gq, (int8_t)depth);
        d.fill4<int8_t>(d.qp_map, x0, y0, gq, (int8_t)P.slice_qp);
        if (d.cb.decode_bin(d.cx(CU_SKIP_FLAG, ctx))) {
            int idx = decode_merge_idx(d);
            MI cand[5];
            d.merge_candidates(x0, y0, size, size, 0, PART_2Nx2N, cand);
            inter_pb(d, x0, y0, size, size, cand[idx]);
            d.fill4<uint8_t>(d.skip_flag, x0, y0, gq, 1);
            d.mark_intra_tu_edges(x0, y0, size);
            return;
        }
        if (!d.cb.decode_bin(d.cx(PRED_MODE_FLAG, 0))) {
            CuState icu = cu;
            inter_cu(d, x0, y0, log2_size, depth, icu);
            return;
        }
    }
    cu.pred_intra = true;
    cu.intra_split = false;
    if (log2_size == P.log2_min_cb) {
        int part2n = d.cb.decode_bin(d.cx(PART_MODE, 0));
        cu.intra_split = !part2n;
    }
    if (P.pcm_enabled && !cu.intra_split && P.log2_min_pcm <= log2_size
        && log2_size <= P.log2_max_pcm && d.cb.decode_terminate()) {
        pcm_cu(d, x0, y0, log2_size, depth, cu);
        return;
    }

    // intra mode syntax: all prev flags, then all mpm/rem payloads
    int n_pb = cu.intra_split ? 4 : 1;
    int pb_size = cu.intra_split ? size >> 1 : size;
    int prev_flags[4], payload[4];
    for (int i = 0; i < n_pb; i++)
        prev_flags[i] = d.cb.decode_bin(d.cx(PREV_INTRA_LUMA_PRED_FLAG, 0));
    for (int i = 0; i < n_pb; i++) {
        if (prev_flags[i]) {
            int idx = 0;
            if (d.cb.decode_bypass())
                idx = 1 + d.cb.decode_bypass();
            payload[i] = idx;
        } else {
            payload[i] = d.cb.decode_bypass_bits(5);
        }
    }
    // derive modes per PB in z-order, updating the map as we go
    int g4 = pb_size >> 2;
    for (int i = 0; i < n_pb; i++) {
        int xp = x0 + (i & 1) * pb_size;
        int yp = y0 + (i >> 1) * pb_size;
        int ca, cb_;
        d.luma_mode_cand(xp, yp, &ca, &cb_);
        // mpm_list (8.4.2)
        int cands[3];
        if (ca == cb_) {
            if (ca < 2) {
                cands[0] = INTRA_PLANAR;
                cands[1] = INTRA_DC;
                cands[2] = INTRA_ANGULAR_VER;
            } else {
                cands[0] = ca;
                cands[1] = 2 + ((ca + 29) % 32);
                cands[2] = 2 + ((ca - 2 + 1) % 32);
            }
        } else {
            cands[0] = ca;
            cands[1] = cb_;
            if (ca != INTRA_PLANAR && cb_ != INTRA_PLANAR)
                cands[2] = INTRA_PLANAR;
            else if (ca != INTRA_DC && cb_ != INTRA_DC)
                cands[2] = INTRA_DC;
            else
                cands[2] = INTRA_ANGULAR_VER;
        }
        int mode;
        if (prev_flags[i]) {
            mode = cands[payload[i]];
        } else {
            mode = payload[i];
            int sorted[3] = {cands[0], cands[1], cands[2]};
            // tiny sort
            for (int a = 0; a < 2; a++)
                for (int b = a + 1; b < 3; b++)
                    if (sorted[b] < sorted[a]) {
                        int t = sorted[a];
                        sorted[a] = sorted[b];
                        sorted[b] = t;
                    }
            for (int k = 0; k < 3; k++)
                if (mode >= sorted[k])
                    mode++;
        }
        d.fill4<int8_t>(d.intra_mode_y, xp, yp, g4, (int8_t)mode);
        d.fill4<uint8_t>(d.is_intra, xp, yp, g4, 1);
    }
    // chroma mode: one per CU for 4:2:0/4:2:2, per PB for 4:4:4,
    // absent for monochrome (7.3.8.5)
    int n_cpb = (P.chroma_fmt == 1 || P.chroma_fmt == 2) ? 1
                : (P.chroma_fmt == 0 ? 0 : n_pb);
    int chroma_modes[4];
    cu.chroma_dm = false;
    for (int i = 0; i < n_cpb; i++) {
        int idx;
        if (d.cb.decode_bin(d.cx(INTRA_CHROMA_PRED_MODE, 0)))
            idx = d.cb.decode_bypass_bits(2);
        else
            idx = 4;
        if (i == 0)
            cu.chroma_dm = idx == 4;  // DM: CCP intra gate
        int luma_ref = d.intra_mode_y[d.at4(
            (y0 + (i >> 1) * pb_size) >> 2, (x0 + (i & 1) * pb_size) >> 2)];
        int m;
        if (idx == 4) {
            m = luma_ref;
        } else {
            m = CHROMA_CAND[idx];
            if (m == luma_ref)
                m = 34;
        }
        chroma_modes[i] = m;
    }
    cu.chroma_mode = n_cpb ? chroma_modes[0] : 0;
    cu.n_chroma_modes = n_cpb;
    for (int i = 0; i < n_cpb; i++)
        cu.chroma_modes[i] = chroma_modes[i];

    // bookkeeping for neighbour contexts
    d.fill4<int8_t>(d.ct_depth, x0, y0, gq, (int8_t)depth);
    d.fill4<int8_t>(d.qp_map, x0, y0, gq, (int8_t)P.slice_qp);
    if (cu.tq_bypass) {
        d.fill4<uint8_t>(d.tq_bypass, x0, y0, gq, 1);
        d.fill4<uint8_t>(d.no_filter, x0, y0, gq, 1);
    }

    cu.inter_split = false;
    cu.max_trafo_depth = P.max_tr_depth_intra + (cu.intra_split ? 1 : 0);
    const int one[2] = {1, 1};
    transform_tree(d, x0, y0, x0, y0, log2_size, 0, 0, one, one, cu);
}

// coding_quadtree (7.3.8.4)
static void coding_quadtree(Dec& d, int x0, int y0, int log2_size,
                            int depth) {
    const Params& P = d.P;
    if (d.err)
        return;
    int size = 1 << log2_size;
    int w = P.width, h = P.height;
    int split;
    if (x0 + size <= w && y0 + size <= h && log2_size > P.log2_min_cb) {
        int ctx = d.ctdepth_gt(x0, y0, depth);
        split = d.cb.decode_bin(d.cx(SPLIT_CU_FLAG, ctx));
    } else {
        split = log2_size > P.log2_min_cb ? 1 : 0;
    }
    // quantization-group start: re-arm cu_qp_delta
    if (P.cu_qp_delta_enabled
        && log2_size >= P.log2_ctb - P.diff_cu_qp_delta_depth) {
        d.qp_delta_coded = false;
        d.qp_delta_val = 0;
    }
    // chroma-QG start: re-arm cu_chroma_qp_offset (values persist)
    if (P.chroma_qp_offset_enabled
        && log2_size >= P.log2_ctb - P.diff_cu_chroma_qp_offset_depth)
        d.chroma_qp_offset_coded = false;
    if (split) {
        int half = size >> 1;
        const int dx[4] = {0, 1, 0, 1}, dy[4] = {0, 0, 1, 1};
        for (int i = 0; i < 4; i++) {
            int x1 = x0 + dx[i] * half, y1 = y0 + dy[i] * half;
            if (x1 < w && y1 < h)
                coding_quadtree(d, x1, y1, log2_size - 1, depth + 1);
        }
        if (P.cu_qp_delta_enabled) {
            int m = d.qg_mask();
            if (((x0 + size) & m) == 0 && ((y0 + size) & m) == 0)
                d.qp_pred_state = d.cur_qp;
        }
    } else {
        coding_unit(d, x0, y0, log2_size, depth);
        if (P.cu_qp_delta_enabled)
            d.end_of_cu(x0, y0, log2_size);
    }
}

// ---- SAO (7.3.8.3) ---------------------------------------------------------
static bool sao_mergeable(const Dec& d, int xn, int yn, int xc, int yc) {
    return d.tile_of_ctb[yn * d.P.ctb_w + xn]
               == d.tile_of_ctb[yc * d.P.ctb_w + xc]
           && d.slice_idx[yn * d.P.ctb_w + xn]
                  == d.slice_idx[yc * d.P.ctb_w + xc];
}

static void sao_copy(Dec& d, int xs, int ys, int xd, int yd) {
    const Params& P = d.P;
    for (int c = 0; c < 3; c++) {
        int s = (c * P.ctb_h + ys) * P.ctb_w + xs;
        int t = (c * P.ctb_h + yd) * P.ctb_w + xd;
        d.sao_type[t] = d.sao_type[s];
        d.sao_band[t] = d.sao_band[s];
        d.sao_eo[t] = d.sao_eo[s];
        for (int k = 0; k < 4; k++)
            d.sao_offs[t * 4 + k] = d.sao_offs[s * 4 + k];
    }
}

static void decode_sao(Dec& d, int xc, int yc) {
    const Params& P = d.P;
    int merge_left = 0, merge_up = 0;
    if (xc > 0 && sao_mergeable(d, xc - 1, yc, xc, yc))
        merge_left = d.cb.decode_bin(d.cx(SAO_MERGE_FLAG, 0));
    if (!merge_left && yc > 0 && sao_mergeable(d, xc, yc - 1, xc, yc))
        merge_up = d.cb.decode_bin(d.cx(SAO_MERGE_FLAG, 0));
    if (merge_left) {
        sao_copy(d, xc - 1, yc, xc, yc);
        return;
    }
    if (merge_up) {
        sao_copy(d, xc, yc - 1, xc, yc);
        return;
    }
    int type[3] = {0, 0, 0};
    int band[3] = {0, 0, 0};
    int eo[3] = {0, 0, 0};
    int offs[3][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}};
    int bdl = P.bd_luma < 10 ? P.bd_luma : 10;
    int cmax = (1 << (bdl - 5)) - 1;
    for (int c = 0; c < 3; c++) {
        if (c == 0 && !P.sao_luma)
            continue;
        if (c > 0 && !P.sao_chroma)
            continue;
        if (c == 0 || c == 1) {
            int t = 0;
            if (d.cb.decode_bin(d.cx(SAO_TYPE_IDX, 0)))
                t = d.cb.decode_bypass() ? 2 : 1;  // EDGE : BAND
            type[c] = t;
            if (c == 1)
                type[2] = t;
        }
        int t = type[c];
        if (t == 0)
            continue;
        int abs_offs[4];
        for (int k = 0; k < 4; k++) {
            int a = 0;
            while (a < cmax && d.cb.decode_bypass())
                a++;
            abs_offs[k] = a;
        }
        if (t == 1) {  // BAND
            for (int k = 0; k < 4; k++) {
                int a = abs_offs[k];
                offs[c][k] = (a && d.cb.decode_bypass()) ? -a : a;
            }
            band[c] = d.cb.decode_bypass_bits(5);
        } else {
            if (c == 0) {
                eo[0] = d.cb.decode_bypass_bits(2);
            } else if (c == 1) {
                int ec = d.cb.decode_bypass_bits(2);
                eo[1] = eo[2] = ec;
            }
            offs[c][0] = abs_offs[0];
            offs[c][1] = abs_offs[1];
            offs[c][2] = -abs_offs[2];
            offs[c][3] = -abs_offs[3];
        }
    }
    for (int c = 0; c < 3; c++) {
        int t = (c * P.ctb_h + yc) * P.ctb_w + xc;
        d.sao_type[t] = type[c];
        d.sao_band[t] = band[c];
        d.sao_eo[t] = eo[c];
        for (int k = 0; k < 4; k++)
            d.sao_offs[t * 4 + k] = offs[c][k];
    }
}

// ---- CTU loop (mirror of SliceDecoder.decode_ctus) -------------------------
// first CTB column of its tile row (WPP-in-tiles rows are tile-relative)
static inline bool tile_col_start(const Dec& d, int xc, int yc) {
    if (xc == 0)
        return true;
    return d.P.tiles
        && d.tile_of_ctb[yc * d.P.ctb_w + xc - 1]
               != d.tile_of_ctb[yc * d.P.ctb_w + xc];
}

static int64_t decode_ctus(Dec& d) {
    ProfSpan _p(3);
    const Params& P = d.P;
    bool wpp = P.wpp != 0;
    bool tiles = P.tiles != 0;
    int ts = d.rs_to_ts[P.seg_addr];
    int n_ctbs = P.ctb_w * P.ctb_h;
    int seg_idx = 0;
    d.wpp_saved = false;
    for (;;) {
        int rs = d.ts_to_rs[ts];
        int xc = rs % P.ctb_w, yc = rs / P.ctb_w;
        // QP prediction restarts at WPP-row / tile starts
        if (wpp && tile_col_start(d, xc, yc))
            d.first_qp_group = true;
        if (tiles && ts > 0
            && d.tile_id_of_ts[ts] != d.tile_id_of_ts[ts - 1]) {
            d.first_qp_group = true;
        }
        d.slice_idx[yc * P.ctb_w + xc] = P.slice_idx_val;
        if (P.sao_enabled && (P.sao_luma || P.sao_chroma)) {
            ProfSpan _p(1);
            decode_sao(d, xc, yc);
        }
        int x0 = xc << P.log2_ctb, y0 = yc << P.log2_ctb;
        coding_quadtree(d, x0, y0, P.log2_ctb, 0);
        if (d.err)
            return d.err;
        if (wpp && xc > 0 && tile_col_start(d, xc - 1, yc)
            && (!tiles
                || d.tile_of_ctb[yc * P.ctb_w + xc - 1]
                       == d.tile_of_ctb[yc * P.ctb_w + xc])) {
            memcpy(d.wpp_ctx, d.ctx, P.n_ctx);
            memcpy(d.wpp_stat, d.stat, sizeof(d.wpp_stat));
            d.wpp_saved = true;
        }
        int end = d.cb.decode_terminate();
        ts++;
        if (end || ts >= n_ctbs)
            return rs;
        // segment boundary? (end_of_subset_one_bit + new CABAC)
        int nrs = d.ts_to_rs[ts];
        bool tile_boundary = tiles
            && d.tile_id_of_ts[ts] != d.tile_id_of_ts[ts - 1];
        bool row_boundary = wpp && !tile_boundary
            && tile_col_start(d, nrs % P.ctb_w, nrs / P.ctb_w);
        if (tile_boundary || row_boundary) {
            d.cb.decode_terminate();  // end_of_subset_one_bit
            seg_idx++;
            if (seg_idx >= P.n_segs)
                return -3;
            d.cb.init_at(d.seg_starts[seg_idx]);
            if (tile_boundary) {
                memcpy(d.ctx, d.fresh_ctx, P.n_ctx);
                memset(d.stat, 0, sizeof(int32_t) * 4);
                d.wpp_saved = false;  // rows never cross a tile edge
            } else if (d.wpp_saved && P.ctb_w > 1) {
                memcpy(d.ctx, d.wpp_ctx, P.n_ctx);
                memcpy(d.stat, d.wpp_stat, sizeof(d.wpp_stat));
            } else {
                memcpy(d.ctx, d.fresh_ctx, P.n_ctx);
                memset(d.stat, 0, sizeof(int32_t) * 4);
            }
        }
    }
}

}  // namespace
}  // namespace hevc_native

#include "stage_a_mt.h"

// ---- extern "C" entry points -----------------------------------------------
using namespace hevc_native;

extern "C" int64_t hevc_native_decode_slice(
    const uint8_t* rbsp, int64_t nbytes, const int64_t* seg_starts,
    const Params* params, const uint8_t* fresh_ctx, uint8_t* ctx,
    int32_t* stat, const int32_t* ctx_off, const int32_t* scans,
    const int32_t* scan_off,
    // pps tables
    const int32_t* rs_to_ts, const int32_t* ts_to_rs,
    const int32_t* tile_id_of_ts, const int32_t* tile_of_ctb,
    // picture maps
    int8_t* intra_mode_y, uint8_t* is_intra, int8_t* ct_depth,
    uint8_t* skip_flag, int8_t* qp_map, int32_t* slice_idx,
    uint8_t* tq_bypass, uint8_t* no_filter, uint8_t* edge_v,
    uint8_t* edge_h, uint8_t* tu_edge_v, uint8_t* tu_edge_h,
    uint8_t* cbf_luma_map, int32_t* mv_l0, int8_t* ref_l0,
    int64_t* ref_poc_l0, int32_t* mv_l1, int8_t* ref_l1,
    int64_t* ref_poc_l1, const int64_t* z_order,
    // reference lists (poc + long-term flags)
    const int64_t* list_poc0, const uint8_t* list_lt0,
    const int64_t* list_poc1, const uint8_t* list_lt1,
    // TMVP collocated motion + pocs
    const int32_t* col_mv0, const int64_t* col_poc0, const int32_t* col_mv1,
    const int64_t* col_poc1, int64_t col_poc, int64_t cur_poc,
    // weighted prediction tables [list][plane][ref<=16]
    const int32_t* wp_w, const int32_t* wp_o,
    // SAO parameter maps (out)
    int32_t* sao_type, int32_t* sao_band, int32_t* sao_offs,
    int32_t* sao_eo,
    // rext chroma offset lists ([n_chroma_offsets] each, may be null)
    const int32_t* cb_qp_offset_list, const int32_t* cr_qp_offset_list,
    // record outputs
    int32_t* rec, int64_t cap_rec, int16_t* lvl, int64_t cap_lvl,
    int32_t n_threads, int64_t* out_counts) {
    Dec d;
    d.P = *params;
    if (d.P.n_ctx > (int32_t)sizeof(d.wpp_ctx))
        return -4;
    d.rbsp = rbsp;
    d.nbytes = nbytes;
    d.seg_starts = seg_starts;
    d.fresh_ctx = fresh_ctx;
    d.ctx = ctx;
    d.stat = stat;
    d.off = ctx_off;
    d.scans = scans;
    d.scan_off = scan_off;
    d.rs_to_ts = rs_to_ts;
    d.ts_to_rs = ts_to_rs;
    d.tile_id_of_ts = tile_id_of_ts;
    d.tile_of_ctb = tile_of_ctb;
    d.intra_mode_y = intra_mode_y;
    d.is_intra = is_intra;
    d.ct_depth = ct_depth;
    d.skip_flag = skip_flag;
    d.qp_map = qp_map;
    d.slice_idx = slice_idx;
    d.tq_bypass = tq_bypass;
    d.no_filter = no_filter;
    d.edge_v = edge_v;
    d.edge_h = edge_h;
    d.tu_edge_v = tu_edge_v;
    d.tu_edge_h = tu_edge_h;
    d.cbf_luma_map = cbf_luma_map;
    d.mv_l0 = mv_l0;
    d.ref_l0 = ref_l0;
    d.ref_poc_l0 = ref_poc_l0;
    d.mv_l1 = mv_l1;
    d.ref_l1 = ref_l1;
    d.ref_poc_l1 = ref_poc_l1;
    d.z_order = z_order;
    d.list_poc0 = list_poc0;
    d.list_lt0 = list_lt0;
    d.list_poc1 = list_poc1;
    d.list_lt1 = list_lt1;
    d.col_mv0 = col_mv0;
    d.col_poc0 = col_poc0;
    d.col_mv1 = col_mv1;
    d.col_poc1 = col_poc1;
    d.col_poc = col_poc;
    d.cur_poc = cur_poc;
    d.wp_w = wp_w;
    d.wp_o = wp_o;
    d.sao_type = sao_type;
    d.sao_band = sao_band;
    d.sao_offs = sao_offs;
    d.sao_eo = sao_eo;
    d.rec = rec;
    d.cap_rec = cap_rec;
    d.lvl = lvl;
    d.cap_lvl = cap_lvl;
    // QP state (QpState(slice_qp))
    d.cur_qp = d.P.slice_qp;
    d.qp_pred_state = d.P.slice_qp;
    d.first_qp_group = true;
    d.qp_delta_coded = false;
    d.qp_delta_val = 0;
    d.cb_qp_offset_list = cb_qp_offset_list;
    d.cr_qp_offset_list = cr_qp_offset_list;
    d.cu_qp_offset_cb = 0;
    d.cu_qp_offset_cr = 0;
    d.chroma_qp_offset_coded = false;
    // CABAC init at first segment
    d.cb.data = rbsp;
    d.cb.nbytes = nbytes;
    d.cb.init_at(seg_starts[0]);

    int64_t rs = run_slice(d, n_threads > 0 ? n_threads : 1);
    if (d.err)
        return d.err;
    if (rs < 0)
        return rs;  // MT row/tile error or capacity overflow
    out_counts[0] = d.n_rec;
    out_counts[1] = d.lvl_used;
    out_counts[2] = rs;
    return 0;
}

// Legacy residual-only entry (same contract as the original
// hevc_tpu/native/residual.cpp; kept for the inline decode path and
// tests/test_native.py).  `off7` layout: (transform_skip, last_x,
// last_y, csbf, sig, gt1, gt2).
extern "C" int hevc_native_decode_residual(
    const uint8_t* data, int64_t nbytes, int64_t* io_bytepos,
    int32_t* io_range, int32_t* io_offset, int32_t* io_bitbuf,
    int32_t* io_nbits, uint8_t* ctx, const int32_t* off7,
    int32_t log2_size, int32_t c_idx, int32_t scan_idx,
    int32_t sign_data_hiding, int32_t ts_allowed, int32_t tq_bypass,
    const int32_t* sub_scan, const int32_t* coef_scan,
    const int32_t* pos_of_xy, int16_t* levels, int32_t* ts_flag_out) {
    Cabac cb = {data, *io_bytepos, nbytes, *io_range, *io_offset,
                *io_bitbuf, *io_nbits};
    int32_t off[N_CTX_IDS] = {0};
    off[TRANSFORM_SKIP_FLAG] = off7[0];
    off[LAST_SIG_X] = off7[1];
    off[LAST_SIG_Y] = off7[2];
    off[CODED_SUB_BLOCK_FLAG] = off7[3];
    off[SIG_COEFF_FLAG] = off7[4];
    off[GREATER1] = off7[5];
    off[GREATER2] = off7[6];
    decode_residual_core_impl(&cb, ctx, off, log2_size, c_idx, scan_idx,
                         sign_data_hiding, ts_allowed, tq_bypass, sub_scan,
                         coef_scan, pos_of_xy, levels, ts_flag_out);
    *io_bytepos = cb.bytepos;
    *io_range = cb.range;
    *io_offset = cb.offset;
    *io_bitbuf = cb.bitbuf;
    *io_nbits = cb.nbits;
    return 0;
}

#include "stage_a_pack.h"

#endif  // HEVC_TPU_STAGE_A_SYNTAX_H
