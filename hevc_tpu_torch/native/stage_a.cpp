// Copied from hevc_tpu/native/stage_a.cpp at e99b487.
// Native stage-A slice decoder: the full CTU syntax loop in C++.
//
// This is the TPU framework's native-runtime equivalent of the
// reference's entropy front-end (reference: libavcodec/hevcdec.c:2845
// hls_decode_entry, :2711 hls_coding_quadtree, :2550 hls_coding_unit,
// :1549 hls_transform_tree, :1322 hls_transform_unit; hevc_mvs.c:523
// ff_hevc_luma_mv_merge_mode, :635 ff_hevc_luma_mv_mvp_mode;
// hevc_filter.c:94-147 QP derivation).  It is a direct re-expression of
// this repo's own spec-derived Python implementation
// (hevc_tpu/decoder/core.py SliceDecoder, hevc_tpu/coding/{mvs,qp}.py) —
// NOT a port of the ffmpeg C.  The Python path remains the correctness
// oracle; bit-exact plan equivalence is asserted by
// tests/test_native_stagea.py.
//
// Output: a flat, decode-ordered record stream (intra/resid/mc/pcm
// BlockRecord rows) + residual-level pool + per-CTB SAO parameter maps,
// with all per-4x4 picture bookkeeping maps (modes, motion, edges, QP)
// updated in place through pointers shared with the Python numpy arrays.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 stage_a.cpp -o _stagea.so

#include "stage_a_engine.h"

namespace hevc_native {
int64_t g_prof[16];
bool g_prof_on = false;
}  // namespace hevc_native

#include <cstdint>
#include <cstring>

namespace hevc_native {
namespace {

const int SLICE_B = 0, SLICE_P = 1, SLICE_I = 2;

const int PART_2Nx2N = 0, PART_2NxN = 1, PART_Nx2N = 2, PART_NxN = 3,
          PART_2NxnU = 4, PART_2NxnD = 5, PART_nLx2N = 6, PART_nRx2N = 7;

const int64_t NO_POC = -((int64_t)1 << 30);

const int INTRA_PLANAR = 0, INTRA_DC = 1, INTRA_ANGULAR_VER = 26;

// Table 8-3: intra mode conversion for 4:2:2 chroma
const uint8_t CHROMA_422_MODE[35] = {
    0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18, 19, 20, 21,
    22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28, 28, 29, 29, 30, 31};

const int CHROMA_CAND[4] = {0, 26, 10, 1};  // planar, ver, hor, dc

// Table 8-10 chroma QP mapping (4:2:0)
const int QPC_TAB[14] = {29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36,
                         37, 37};

// merge combined-bi index tables (8.5.3.2.4)
const int COMB_L0[12] = {0, 1, 0, 2, 1, 2, 0, 3, 1, 3, 2, 3};
const int COMB_L1[12] = {1, 0, 2, 0, 2, 1, 3, 0, 3, 1, 3, 2};

// record stream layout (int32 rows, REC_NCOLS wide) — mirrored by
// hevc_tpu/native/__init__.py REC_* constants
enum {
    REC_KIND = 0, REC_PLANE, REC_X, REC_Y, REC_W, REC_H, REC_MODE,
    REC_QP, REC_FLAGS, REC_MTX, REC_LVL, REC_MVX0, REC_MVY0, REC_REF0,
    REC_MVX1, REC_MVY1, REC_REF1, REC_WPW0, REC_WPO0, REC_WPW1,
    REC_WPO1, REC_LOG2WD, REC_CCP, REC_CCPREF, REC_NCOLS = 24
};
enum { KIND_INTRA = 0, KIND_RESID = 1, KIND_MC = 2, KIND_PCM = 3 };
// REC_FLAGS bits (rext: rotation + RDPCM accumulate direction)
enum { F_DST = 1, F_TS = 2, F_TQB = 4, F_BI = 8, F_LX = 16,
       F_ROT = 32, F_RDPCM_H = 64, F_RDPCM_V = 128 };

// Scalar parameters, mirrored by ctypes.Structure NativeParams in
// hevc_tpu/native/__init__.py (field order must match exactly).
struct Params {
    int32_t width, height, ctb_w, ctb_h, h4, w4;
    int32_t log2_ctb, log2_min_cb, log2_min_tb, log2_max_tb;
    int32_t max_tr_depth_intra, max_tr_depth_inter;
    int32_t chroma_fmt, sub_w, sub_h, bd_luma, bd_chroma, qp_bd_offset;
    int32_t amp_enabled, pcm_enabled, log2_min_pcm, log2_max_pcm;
    int32_t pcm_bd_luma, pcm_bd_chroma, pcm_filter_disabled;
    int32_t sao_enabled, have_scaling;
    int32_t slice_qp;
    int32_t cu_qp_delta_enabled, diff_cu_qp_delta_depth;
    int32_t tq_bypass_enabled, ts_enabled, log2_max_ts, sdh;
    int32_t pps_cb_qp_offset, pps_cr_qp_offset;
    int32_t wpp, tiles;
    int32_t slice_type, sao_luma, sao_chroma;
    int32_t max_merge, nref0, nref1, mvd_l1_zero;
    int32_t slice_idx_val, seg_addr;
    int32_t sh_cb_qp_offset, sh_cr_qp_offset;
    int32_t has_tmvp, no_backward, col_from_l0;
    int32_t has_wp, wp_log2wd_luma, wp_log2wd_chroma;
    int32_t n_segs, n_ctx;
    // range-extension tools (SPS/PPS rext flags + slice chroma offsets)
    int32_t persistent_rice, ts_context, implicit_rdpcm, explicit_rdpcm;
    int32_t ts_rotation, ccp_enabled;
    int32_t chroma_qp_offset_enabled, diff_cu_chroma_qp_offset_depth;
    int32_t n_chroma_offsets;
};

struct MI {  // MotionInfo: ref < 0 = list unused
    int32_t mvx0 = 0, mvy0 = 0, mvx1 = 0, mvy1 = 0;
    int32_t ref0 = -1, ref1 = -1;
    int64_t poc0 = NO_POC, poc1 = NO_POC;
    bool uses_l0() const { return ref0 >= 0; }
    bool uses_l1() const { return ref1 >= 0; }
};

static inline bool same_motion(const MI& a, const MI& b) {
    return a.mvx0 == b.mvx0 && a.mvy0 == b.mvy0 && a.ref0 == b.ref0
        && a.mvx1 == b.mvx1 && a.mvy1 == b.mvy1 && a.ref1 == b.ref1;
}

static inline int clip3(int lo, int hi, int v) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static inline int floor_div(int a, int b) {  // Python // semantics
    int q = a / b, r = a % b;
    return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}

struct CuState {
    bool pred_intra = false, intra_split = false, inter_split = false;
    int chroma_mode = 0, tq_bypass = 0, max_trafo_depth = 0;
    int x0 = 0, y0 = 0, log2_size = 0;
    bool chroma_dm = false;  // DM chroma mode (CCP intra gate)
    int chroma_modes[4] = {0, 0, 0, 0};  // per-PB (4:4:4 NxN, 7.3.8.5)
    int n_chroma_modes = 0;
};

struct Dec {
    Params P;
    Cabac cb;
    uint8_t* ctx;             // live context states (N_CTX bytes)
    int32_t* stat;            // live rext rice stats [4]
    const uint8_t* fresh_ctx; // slice-initial states, for tile reinit
    const int32_t* off;       // CtxId -> ctx base offset
    // scan bank: per (scan_idx 0..2, log2 2..5) triple of offsets into
    // `scans` — (sub_scan flat, coef_scan flat, pos_of_xy flat)
    const int32_t* scans;
    const int32_t* scan_off;
    // rbsp + entry-point segments
    const uint8_t* rbsp;
    int64_t nbytes;
    const int64_t* seg_starts;
    // pps tables
    const int32_t* rs_to_ts;
    const int32_t* ts_to_rs;
    const int32_t* tile_id_of_ts;
    const int32_t* tile_of_ctb;  // [ctb_h, ctb_w]
    // picture maps (shared with numpy, dtypes as in coding/picture.py)
    int8_t* intra_mode_y;
    uint8_t* is_intra;
    int8_t* ct_depth;
    uint8_t* skip_flag;
    int8_t* qp_map;
    int32_t* slice_idx;  // [ctb_h, ctb_w]
    uint8_t* tq_bypass;
    uint8_t* no_filter;
    uint8_t* edge_v;
    uint8_t* edge_h;
    uint8_t* tu_edge_v;
    uint8_t* tu_edge_h;
    uint8_t* cbf_luma_map;
    int32_t* mv_l0;       // [h4, w4, 2]
    int8_t* ref_l0;
    int64_t* ref_poc_l0;
    int32_t* mv_l1;
    int8_t* ref_l1;
    int64_t* ref_poc_l1;
    const int64_t* z_order;
    // reference lists
    const int64_t* list_poc0;
    const uint8_t* list_lt0;
    const int64_t* list_poc1;
    const uint8_t* list_lt1;
    // TMVP collocated motion (16x16-compressed reads of 4x4 maps)
    const int32_t* col_mv0;
    const int64_t* col_poc0;
    const int32_t* col_mv1;
    const int64_t* col_poc1;
    int64_t col_poc = 0;
    int64_t cur_poc = 0;
    // weighted prediction: [list 0/1][plane 0..2][ref 0..15]
    const int32_t* wp_w;
    const int32_t* wp_o;
    // SAO parameter maps (int32 [3, ctb_h, ctb_w] and [..., 4])
    int32_t* sao_type;
    int32_t* sao_band;
    int32_t* sao_offs;
    int32_t* sao_eo;
    // outputs
    int32_t* rec;
    int64_t cap_rec, n_rec = 0;
    int16_t* lvl;
    int64_t cap_lvl, lvl_used = 0;
    int err = 0;
    // QP state machine (coding/qp.py QpState)
    int cur_qp, qp_pred_state;
    bool first_qp_group = true, qp_delta_coded = false;
    int qp_delta_val = 0;
    // rext cu_chroma_qp_offset state (persists until re-coded)
    int cu_qp_offset_cb = 0, cu_qp_offset_cr = 0;
    bool chroma_qp_offset_coded = false;
    const int32_t* cb_qp_offset_list = nullptr;
    const int32_t* cr_qp_offset_list = nullptr;
    // WPP context snapshot
    uint8_t wpp_ctx[512];
    int32_t wpp_stat[4];
    bool wpp_saved = false;

    // ---- small helpers --------------------------------------------------
    int w4() const { return P.w4; }
    int at4(int y4, int x4) const { return y4 * P.w4 + x4; }

    uint8_t* cx(int id, int inc) { return ctx + off[id] + inc; }

    int32_t* new_rec() {
        if (n_rec >= cap_rec) { err = -2; return nullptr; }
        int32_t* r = rec + n_rec * REC_NCOLS;
        memset(r, 0, sizeof(int32_t) * REC_NCOLS);
        r[REC_LVL] = -1;
        n_rec++;
        return r;
    }

    int16_t* alloc_lvl(int n, int64_t* off_out) {
        if (lvl_used + n > cap_lvl) { err = -2; return nullptr; }
        *off_out = lvl_used;
        int16_t* p = lvl + lvl_used;
        lvl_used += n;
        return p;
    }

    // ---- availability (6.4.1 z-scan; picture.py PictureState) ----------
    bool available(int xc, int yc, int xn, int yn) const {
        if (xn < 0 || yn < 0 || xn >= P.width || yn >= P.height)
            return false;
        int64_t zn = z_order[at4(yn >> 2, xn >> 2)];
        int64_t zc = z_order[at4(yc >> 2, xc >> 2)];
        if (zn >= zc)
            return false;
        int lc = P.log2_ctb;
        int cw = P.ctb_w;
        // tile map first: it is static, while slice_idx is written as
        // CTBs decode — a cross-tile probe must not read it (MT path)
        if (tile_of_ctb[(yn >> lc) * cw + (xn >> lc)]
            != tile_of_ctb[(yc >> lc) * cw + (xc >> lc)])
            return false;
        if (slice_idx[(yn >> lc) * cw + (xn >> lc)]
            != slice_idx[(yc >> lc) * cw + (xc >> lc)])
            return false;
        return true;
    }

    int ctdepth_gt(int x0, int y0, int depth) const {
        int inc = 0;
        if (available(x0, y0, x0 - 1, y0)
            && ct_depth[at4(y0 >> 2, (x0 - 1) >> 2)] > depth)
            inc++;
        if (available(x0, y0, x0, y0 - 1)
            && ct_depth[at4((y0 - 1) >> 2, x0 >> 2)] > depth)
            inc++;
        return inc;
    }

    // 8.4.2 (candA, candB) for MPM derivation
    void luma_mode_cand(int x_pb, int y_pb, int* ca, int* cb_out) const {
        int cand[2] = {INTRA_DC, INTRA_DC};
        const int nx[2] = {x_pb - 1, x_pb};
        const int ny[2] = {y_pb, y_pb - 1};
        for (int k = 0; k < 2; k++) {
            if (!available(x_pb, y_pb, nx[k], ny[k]))
                continue;
            if (!is_intra[at4(ny[k] >> 2, nx[k] >> 2)])
                continue;
            if (k == 1 && ((y_pb - 1) >> P.log2_ctb) != (y_pb >> P.log2_ctb))
                continue;  // above CTB row: forced DC
            cand[k] = intra_mode_y[at4(ny[k] >> 2, nx[k] >> 2)];
        }
        *ca = cand[0];
        *cb_out = cand[1];
    }

    // ---- edge / map bookkeeping ----------------------------------------
    void mark_block_edges(int x0, int y0, int w, int h) {
        int x4 = x0 >> 2, y4 = y0 >> 2;
        if (x0 > 0)
            for (int i = 0; i < (h >> 2); i++)
                edge_v[at4(y4 + i, x4)] = 1;
        if (y0 > 0)
            for (int i = 0; i < (w >> 2); i++)
                edge_h[at4(y4, x4 + i)] = 1;
    }

    void mark_intra_tu_edges(int x0, int y0, int size) {
        mark_block_edges(x0, y0, size, size);
        int x4 = x0 >> 2, y4 = y0 >> 2;
        if (x0 > 0)
            for (int i = 0; i < (size >> 2); i++)
                tu_edge_v[at4(y4 + i, x4)] = 1;
        if (y0 > 0)
            for (int i = 0; i < (size >> 2); i++)
                tu_edge_h[at4(y4, x4 + i)] = 1;
    }

    template <typename T>
    void fill4(T* map, int x0, int y0, int size4, T v) {
        int x4 = x0 >> 2, y4 = y0 >> 2;
        for (int j = 0; j < size4; j++)
            for (int i = 0; i < size4; i++)
                map[at4(y4 + j, x4 + i)] = v;
    }

    // ---- QP state machine (coding/qp.py) --------------------------------
    int qg_mask() const {
        return (1 << (P.log2_ctb - P.diff_cu_qp_delta_depth)) - 1;
    }

    int qp_pred(int x_base, int y_base) {
        int ctb_mask = (1 << P.log2_ctb) - 1;
        int m = qg_mask();
        int xqg = x_base - (x_base & m);
        int yqg = y_base - (y_base & m);
        int pred;
        if (first_qp_group || (xqg == 0 && yqg == 0)) {
            first_qp_group = !qp_delta_coded;
            pred = P.slice_qp;
        } else {
            pred = qp_pred_state;
        }
        bool avail_a = (x_base & ctb_mask) && (xqg & ctb_mask);
        bool avail_b = (y_base & ctb_mask) && (yqg & ctb_mask);
        int qpa = avail_a ? qp_map[at4(yqg >> 2, (xqg - 1) >> 2)] : pred;
        int qpb = avail_b ? qp_map[at4((yqg - 1) >> 2, xqg >> 2)] : pred;
        return (qpa + qpb + 1) >> 1;
    }

    void set_qpy(int x_base, int y_base) {
        int pred = qp_pred(x_base, y_base);
        if (qp_delta_val != 0) {
            int o = P.qp_bd_offset;
            int m = 52 + o;
            int x = pred + qp_delta_val + 52 + 2 * o;
            cur_qp = ((x % m) + m) % m - o;
        } else {
            cur_qp = pred;
        }
    }

    void end_of_cu(int x0, int y0, int log2_size) {
        int size = 1 << log2_size;
        if (!qp_delta_coded)
            set_qpy(x0, y0);
        fill4<int8_t>(qp_map, x0, y0, size >> 2, (int8_t)cur_qp);
        int m = qg_mask();
        if (((x0 + size) & m) == 0 && ((y0 + size) & m) == 0)
            qp_pred_state = cur_qp;
    }

    int component_qp(int c_idx) const {
        int qp = cur_qp;
        if (c_idx == 0)
            return qp + P.qp_bd_offset;
        int o = (c_idx == 1)
                    ? P.pps_cb_qp_offset + P.sh_cb_qp_offset
                          + cu_qp_offset_cb
                    : P.pps_cr_qp_offset + P.sh_cr_qp_offset
                          + cu_qp_offset_cr;
        int qpi = clip3(-P.qp_bd_offset, 57, qp + o);
        int qpc;
        if (P.chroma_fmt == 1) {
            if (qpi < 30)
                qpc = qpi;
            else if (qpi > 43)
                qpc = qpi - 6;
            else
                qpc = QPC_TAB[qpi - 30];
        } else {
            qpc = qpi < 51 ? qpi : 51;
        }
        return qpc + P.qp_bd_offset;
    }

    // ---- motion helpers (coding/mvs.py) ----------------------------------
    bool motion_at(int xn, int yn, MI* out) const {
        int y4 = yn >> 2, x4 = xn >> 2;
        if (is_intra[at4(y4, x4)])
            return false;
        int r0 = ref_l0[at4(y4, x4)];
        int r1 = ref_l1[at4(y4, x4)];
        if (r0 < 0 && r1 < 0)
            return false;
        out->mvx0 = mv_l0[2 * at4(y4, x4)];
        out->mvy0 = mv_l0[2 * at4(y4, x4) + 1];
        out->ref0 = r0;
        out->poc0 = ref_poc_l0[at4(y4, x4)];
        out->mvx1 = mv_l1[2 * at4(y4, x4)];
        out->mvy1 = mv_l1[2 * at4(y4, x4) + 1];
        out->ref1 = r1;
        out->poc1 = ref_poc_l1[at4(y4, x4)];
        return true;
    }

    bool ctb_ok(int nx, int ny, int cx_, int cy_) const {
        if (nx < 0 || ny < 0 || nx >= P.ctb_w || ny >= P.ctb_h)
            return false;
        return tile_of_ctb[ny * P.ctb_w + nx]
                   == tile_of_ctb[cy_ * P.ctb_w + cx_]
               && slice_idx[ny * P.ctb_w + nx]
                   == slice_idx[cy_ * P.ctb_w + cx_];
    }

    // mirror of mvs.py _pu_flags (reference: hevc_mvs.c:43)
    void pu_flags(int x0, int y0, int n_w, int n_h, bool* left, bool* up,
                  bool* up_left, bool* up_right, bool* bottom_left) const {
        int lcb = P.log2_ctb;
        int ctb = 1 << lcb;
        int x0b = x0 & (ctb - 1), y0b = y0 & (ctb - 1);
        int cx_ = x0 >> lcb, cy_ = y0 >> lcb;
        *left = x0b != 0 || ctb_ok(cx_ - 1, cy_, cx_, cy_);
        *up = y0b != 0 || ctb_ok(cx_, cy_ - 1, cx_, cy_);
        if (!x0b && !y0b)
            *up_left = ctb_ok(cx_ - 1, cy_ - 1, cx_, cy_);
        else
            *up_left = *left && *up;
        if (x0b + n_w == ctb)
            *up_right = ctb_ok(cx_ + 1, cy_ - 1, cx_, cy_) && !y0b;
        else
            *up_right = *up;
        int eoty = (cy_ << lcb) + ctb;
        if (eoty > P.height)
            eoty = P.height;
        *bottom_left = (y0 + n_h) >= eoty ? false : *left;
    }

    bool z_avail(int xc, int yc, int xn, int yn) const {
        int lcb = P.log2_ctb;
        if ((yn >> lcb) < (yc >> lcb) || (xn >> lcb) < (xc >> lcb))
            return true;
        return z_order[at4(yn >> 2, xn >> 2)]
            <= z_order[at4(yc >> 2, xc >> 2)];
    }

    // 8.5.3.2.8 MV scaling core
    static void scale_tb_td(int mvx, int mvy, int tb, int td, int* ox,
                            int* oy) {
        td = clip3(-128, 127, td);
        tb = clip3(-128, 127, tb);
        if (td == 0) {
            *ox = mvx;
            *oy = mvy;
            return;
        }
        int tx = floor_div(16384 + (abs32(td) >> 1), td);
        int dsf = clip3(-4096, 4095, (tb * tx + 32) >> 6);
        const int in[2] = {mvx, mvy};
        int* out[2] = {ox, oy};
        for (int i = 0; i < 2; i++) {
            int64_t v = (int64_t)dsf * in[i];
            int64_t av = v >= 0 ? v : -v;
            int64_t s = ((av + 127) >> 8) * (v >= 0 ? 1 : -1);
            *out[i] = (int)(s < -32768 ? -32768 : (s > 32767 ? 32767 : s));
        }
    }

    static int abs32(int v) { return v < 0 ? -v : v; }

    void scale_mv(int mvx, int mvy, int64_t cur_ref_poc, int64_t nb_ref_poc,
                  int* ox, int* oy) const {
        if (nb_ref_poc == cur_ref_poc) {
            *ox = mvx;
            *oy = mvy;
            return;
        }
        int td = (int)(cur_poc - nb_ref_poc);
        if (td == 0)
            td = 1;
        scale_tb_td(mvx, mvy, (int)(cur_poc - cur_ref_poc), td, ox, oy);
    }

    // 16x16-compressed collocated motion read
    bool col_motion_at(int x, int y, int32_t mv0[2], int64_t* p0,
                       int32_t mv1[2], int64_t* p1) const {
        if (x >= P.width || y >= P.height || x < 0 || y < 0)
            return false;
        x = (x >> 4) << 4;
        y = (y >> 4) << 4;
        int i = at4(y >> 2, x >> 2);
        *p0 = col_poc0[i];
        *p1 = col_poc1[i];
        if (*p0 == NO_POC && *p1 == NO_POC)
            return false;
        mv0[0] = col_mv0[2 * i];
        mv0[1] = col_mv0[2 * i + 1];
        mv1[0] = col_mv1[2 * i];
        mv1[1] = col_mv1[2 * i + 1];
        return true;
    }

    // 8.5.3.2.7-9 temporal candidate; returns false if unavailable
    bool temporal_mv(int x_pb, int y_pb, int n_w, int n_h, int lx,
                     int64_t target_poc, bool target_lt, int* ox,
                     int* oy) const {
        int cand_x[2], cand_y[2];
        int n_cand = 0;
        int x_br = x_pb + n_w, y_br = y_pb + n_h;
        if ((y_pb >> P.log2_ctb) == (y_br >> P.log2_ctb)) {
            cand_x[n_cand] = x_br;
            cand_y[n_cand++] = y_br;
        }
        cand_x[n_cand] = x_pb + (n_w >> 1);
        cand_y[n_cand++] = y_pb + (n_h >> 1);
        for (int k = 0; k < n_cand; k++) {
            int32_t mv0[2], mv1[2];
            int64_t p0, p1;
            if (!col_motion_at(cand_x[k], cand_y[k], mv0, &p0, mv1, &p1))
                continue;
            const int32_t* mv_col;
            int64_t ref_col;
            if (p0 == NO_POC) {
                mv_col = mv1;
                ref_col = p1;
            } else if (p1 == NO_POC) {
                mv_col = mv0;
                ref_col = p0;
            } else if (P.no_backward) {
                mv_col = lx == 0 ? mv0 : mv1;
                ref_col = lx == 0 ? p0 : p1;
            } else if (P.col_from_l0) {
                mv_col = mv1;
                ref_col = p1;
            } else {
                mv_col = mv0;
                ref_col = p0;
            }
            bool col_lt = ref_col == col_poc;
            if (col_lt != target_lt)
                continue;
            int tb = (int)(cur_poc - target_poc);
            int td = (int)(col_poc - ref_col);
            if (target_lt || tb == td || td == 0) {
                *ox = mv_col[0];
                *oy = mv_col[1];
            } else {
                scale_tb_td(mv_col[0], mv_col[1], tb, td, ox, oy);
            }
            return true;
        }
        return false;
    }

    // 8.5.3.2.3-5 merge candidate list (mirror of mvs.py merge_candidates)
    int merge_candidates(int x_pb, int y_pb, int n_w, int n_h, int part_idx,
                         int part_mode, MI* cand) const {
        bool is_b = P.slice_type == SLICE_B;
        int max_cand = P.max_merge;
        int a1x = x_pb - 1, a1y = y_pb + n_h - 1;
        int b1x = x_pb + n_w - 1, b1y = y_pb - 1;
        int b0x = x_pb + n_w, b0y = y_pb - 1;
        int a0x = x_pb - 1, a0y = y_pb + n_h;
        int b2x = x_pb - 1, b2y = y_pb - 1;
        bool f_left, f_up, f_up_left, f_up_right, f_bottom_left;
        pu_flags(x_pb, y_pb, n_w, n_h, &f_left, &f_up, &f_up_left,
                 &f_up_right, &f_bottom_left);
        int n = 0;
        MI m_a1, m_b1, m_b0, m_a0, m_b2;
        bool h_a1 = false, h_b1 = false, h_b0 = false, h_a0 = false,
             h_b2 = false;
        if (f_left && !(part_idx == 1
                        && (part_mode == PART_Nx2N || part_mode == PART_nLx2N
                            || part_mode == PART_nRx2N))) {
            h_a1 = motion_at(a1x, a1y, &m_a1);
            if (h_a1)
                cand[n++] = m_a1;
        }
        if (f_up && !(part_idx == 1
                      && (part_mode == PART_2NxN || part_mode == PART_2NxnU
                          || part_mode == PART_2NxnD))) {
            h_b1 = motion_at(b1x, b1y, &m_b1);
            if (h_b1 && !(h_a1 && same_motion(m_b1, m_a1)))
                cand[n++] = m_b1;
        }
        if (f_up_right && b0x < P.width && z_avail(x_pb, y_pb, b0x, b0y))
            h_b0 = motion_at(b0x, b0y, &m_b0);
        if (h_b0 && !(h_b1 && same_motion(m_b0, m_b1)))
            cand[n++] = m_b0;
        if (f_bottom_left && a0y < P.height
            && z_avail(x_pb, y_pb, a0x, a0y))
            h_a0 = motion_at(a0x, a0y, &m_a0);
        if (h_a0 && !(h_a1 && same_motion(m_a0, m_a1)))
            cand[n++] = m_a0;
        if (n < 4) {
            if (f_up_left)
                h_b2 = motion_at(b2x, b2y, &m_b2);
            if (h_b2 && !(h_a1 && same_motion(m_b2, m_a1))
                && !(h_b1 && same_motion(m_b2, m_b1)))
                cand[n++] = m_b2;
        }
        // temporal candidate: refIdx 0, after spatial
        if (P.has_tmvp && n < max_cand) {
            MI mi;
            bool any = false;
            int tx, ty;
            if (temporal_mv(x_pb, y_pb, n_w, n_h, 0, list_poc0[0],
                            P.nref0 > 0 && list_lt0[0], &tx, &ty)) {
                mi.mvx0 = tx;
                mi.mvy0 = ty;
                mi.ref0 = 0;
                mi.poc0 = list_poc0[0];
                any = true;
            }
            if (is_b && temporal_mv(x_pb, y_pb, n_w, n_h, 1, list_poc1[0],
                                    P.nref1 > 0 && list_lt1[0], &tx, &ty)) {
                mi.mvx1 = tx;
                mi.mvy1 = ty;
                mi.ref1 = 0;
                mi.poc1 = list_poc1[0];
                any = true;
            }
            if (any)
                cand[n++] = mi;
        }
        if (is_b && n > 1 && n < max_cand) {
            int n_orig = n;
            int kmax = n_orig * (n_orig - 1);
            if (kmax > 12)
                kmax = 12;
            for (int k = 0; k < kmax; k++) {
                int i0 = COMB_L0[k], i1 = COMB_L1[k];
                if (i0 >= n_orig || i1 >= n_orig)
                    continue;
                const MI& c0 = cand[i0];
                const MI& c1 = cand[i1];
                if (!(c0.uses_l0() && c1.uses_l1()))
                    continue;
                if (c0.poc0 == c1.poc1 && c0.mvx0 == c1.mvx1
                    && c0.mvy0 == c1.mvy1)
                    continue;
                MI mi;
                mi.mvx0 = c0.mvx0;
                mi.mvy0 = c0.mvy0;
                mi.ref0 = c0.ref0;
                mi.poc0 = c0.poc0;
                mi.mvx1 = c1.mvx1;
                mi.mvy1 = c1.mvy1;
                mi.ref1 = c1.ref1;
                mi.poc1 = c1.poc1;
                cand[n++] = mi;
                if (n >= max_cand)
                    break;
            }
        }
        int zero_idx = 0;
        int num_ref = is_b ? (P.nref0 < P.nref1 ? P.nref0 : P.nref1)
                           : P.nref0;
        while (n < max_cand) {
            int ridx = zero_idx < num_ref ? zero_idx : 0;
            MI mi;
            mi.ref0 = ridx;
            mi.poc0 = list_poc0[ridx];
            if (is_b) {
                mi.ref1 = ridx;
                mi.poc1 = list_poc1[ridx];
            }
            cand[n++] = mi;
            zero_idx++;
        }
        return max_cand;
    }

    // per-list accessor of a neighbour MI: returns false if unused
    static bool lx_of(const MI& m, int lx, int* mvx, int* mvy, int64_t* poc,
                      int* ridx) {
        if (lx == 0) {
            if (!m.uses_l0())
                return false;
            *mvx = m.mvx0;
            *mvy = m.mvy0;
            *poc = m.poc0;
            *ridx = m.ref0;
        } else {
            if (!m.uses_l1())
                return false;
            *mvx = m.mvx1;
            *mvy = m.mvy1;
            *poc = m.poc1;
            *ridx = m.ref1;
        }
        return true;
    }

    bool nb_lt(int l, int ridx) const {
        if (l == 0)
            return ridx < P.nref0 && list_lt0[ridx];
        return ridx < P.nref1 && list_lt1[ridx];
    }

    // 8.5.3.2.6-7 AMVP (mirror of mvs.py amvp_candidates)
    void amvp_candidates(int x_pb, int y_pb, int n_w, int n_h, int lx,
                         int ref_idx, int out[2][2]) const {
        const int64_t* ref_poc_list = lx == 0 ? list_poc0 : list_poc1;
        int64_t target_poc = ref_poc_list[ref_idx];
        bool cur_lt = nb_lt(lx, ref_idx);
        int a0x = x_pb - 1, a0y = y_pb + n_h;
        int a1x = x_pb - 1, a1y = y_pb + n_h - 1;
        int b0x = x_pb + n_w, b0y = y_pb - 1;
        int b1x = x_pb + n_w - 1, b1y = y_pb - 1;
        int b2x = x_pb - 1, b2y = y_pb - 1;
        bool f_left, f_up, f_up_left, f_up_right, f_bottom_left;
        pu_flags(x_pb, y_pb, n_w, n_h, &f_left, &f_up, &f_up_left,
                 &f_up_right, &f_bottom_left);
        bool av_a0 = f_bottom_left && a0y < P.height
                     && z_avail(x_pb, y_pb, a0x, a0y);
        bool av_b0 = f_up_right && b0x < P.width
                     && z_avail(x_pb, y_pb, b0x, b0y);

        MI a_n[2], b_n[3];
        bool a_h[2] = {false, false}, b_h[3] = {false, false, false};
        if (av_a0)
            a_h[0] = motion_at(a0x, a0y, &a_n[0]);
        if (f_left)
            a_h[1] = motion_at(a1x, a1y, &a_n[1]);
        if (av_b0)
            b_h[0] = motion_at(b0x, b0y, &b_n[0]);
        if (f_up)
            b_h[1] = motion_at(b1x, b1y, &b_n[1]);
        if (f_up_left)
            b_h[2] = motion_at(b2x, b2y, &b_n[2]);

        auto same_ref = [&](const MI& m, int* ox, int* oy) -> bool {
            const int ls[2] = {lx, 1 - lx};
            for (int li = 0; li < 2; li++) {
                int mvx, mvy, ridx;
                int64_t poc;
                if (lx_of(m, ls[li], &mvx, &mvy, &poc, &ridx)
                    && poc == target_poc) {
                    *ox = mvx;
                    *oy = mvy;
                    return true;
                }
            }
            return false;
        };
        auto any_ref_scaled = [&](const MI& m, int* ox, int* oy) -> bool {
            const int ls[2] = {lx, 1 - lx};
            for (int li = 0; li < 2; li++) {
                int mvx, mvy, ridx;
                int64_t poc;
                if (!lx_of(m, ls[li], &mvx, &mvy, &poc, &ridx))
                    continue;
                if (nb_lt(ls[li], ridx) != cur_lt)
                    continue;  // long-term status must match
                if (cur_lt) {
                    *ox = mvx;
                    *oy = mvy;
                    return true;  // both long-term: no scaling
                }
                scale_mv(mvx, mvy, target_poc, poc, ox, oy);
                return true;
            }
            return false;
        };

        bool have_a = false, have_b = false;
        int mva[2] = {0, 0}, mvb[2] = {0, 0};
        bool a_block_avail = a_h[0] || a_h[1];
        for (int i = 0; i < 2 && !have_a; i++)
            if (a_h[i] && same_ref(a_n[i], &mva[0], &mva[1]))
                have_a = true;
        if (!have_a)
            for (int i = 0; i < 2 && !have_a; i++)
                if (a_h[i] && any_ref_scaled(a_n[i], &mva[0], &mva[1]))
                    have_a = true;
        for (int i = 0; i < 3 && !have_b; i++)
            if (b_h[i] && same_ref(b_n[i], &mvb[0], &mvb[1]))
                have_b = true;
        if (!a_block_avail) {
            if (!have_a) {
                have_a = have_b;
                mva[0] = mvb[0];
                mva[1] = mvb[1];
                have_b = false;
            }
            if (!have_b)
                for (int i = 0; i < 3 && !have_b; i++)
                    if (b_h[i] && any_ref_scaled(b_n[i], &mvb[0], &mvb[1]))
                        have_b = true;
        }
        int n = 0;
        if (have_a) {
            out[n][0] = mva[0];
            out[n][1] = mva[1];
            n++;
        }
        if (have_b && (n == 0 || mvb[0] != out[0][0] || mvb[1] != out[0][1])) {
            out[n][0] = mvb[0];
            out[n][1] = mvb[1];
            n++;
        }
        if (P.has_tmvp && n < 2) {
            int tx, ty;
            if (temporal_mv(x_pb, y_pb, n_w, n_h, lx, target_poc, cur_lt,
                            &tx, &ty)) {
                out[n][0] = tx;
                out[n][1] = ty;
                n++;
            }
        }
        while (n < 2) {
            out[n][0] = 0;
            out[n][1] = 0;
            n++;
        }
    }
};

}  // namespace
}  // namespace hevc_native
#include "stage_a_syntax.h"

extern "C" const int64_t* hevc_native_prof(int enable, int reset) {
    if (reset)
        memset(hevc_native::g_prof, 0, sizeof(hevc_native::g_prof));
    hevc_native::g_prof_on = enable != 0;
    return hevc_native::g_prof;
}
