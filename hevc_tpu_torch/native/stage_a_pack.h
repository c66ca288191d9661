// Copied from hevc_tpu/native/stage_a_pack.h at e99b487.
// Native stage-A → stage-B packer: record stream → PackedFrame arrays.
//
// Mirrors hevc_tpu/tpu/pack.py (pack_frame + _schedule_levels) exactly:
// wavefront dependency levels for intra records, per-class residual slot
// assignment, MC field rows, availability bitmaps.  The Python packer
// remains the oracle; equality is asserted by tests/test_native_pack.py.
// Included only from stage_a.cpp (reopens its unnamed namespace).
#ifndef HEVC_TPU_STAGE_A_PACK_H
#define HEVC_TPU_STAGE_A_PACK_H

#include <vector>

namespace hevc_native {
namespace {

// scalar parameters of the packer, mirrored by PackParams in
// hevc_tpu/native/__init__.py (field order must match)
struct PackP {
    int32_t width, height, sub_w, sub_h, h4, w4;
    int32_t log2_ctb, ctb_w, ctb_h;
    int32_t chroma444, smoothing_disabled, strong_smoothing;
    int32_t nrefs, r0, pad_ref;
    // 1 = canonicalize MC into fixed 4x4 luma / 2x2 chroma tiles so the
    // device MC groups have frame-independent static shapes (the TPU
    // analogue of the reference's fixed [10][2][2] kernel grid,
    // hevcdsp.h:98) — every tile of a PU shares its MV/refs/weights
    int32_t tile_mc;
    // region offsets (pack.py region_offsets): per plane (oy, ox, rh, rw)
    int32_t reg[3][4];
};

struct PackCtx {
    const PackP* P;
    const int64_t* z_order;
    const int32_t* slice_idx;
    const int32_t* tile_of_ctb;

    bool available(int xc, int yc, int xn, int yn) const {
        const PackP& p = *P;
        if (xn < 0 || yn < 0 || xn >= p.width || yn >= p.height)
            return false;
        if (z_order[(yn >> 2) * p.w4 + (xn >> 2)]
            >= z_order[(yc >> 2) * p.w4 + (xc >> 2)])
            return false;
        int lc = p.log2_ctb, cw = p.ctb_w;
        if (slice_idx[(yn >> lc) * cw + (xn >> lc)]
            != slice_idx[(yc >> lc) * cw + (xc >> lc)])
            return false;
        if (tile_of_ctb[(yn >> lc) * cw + (xn >> lc)]
            != tile_of_ctb[(yc >> lc) * cw + (xc >> lc)])
            return false;
        return true;
    }
};

// ops/reference.py _filter_flag
static inline bool pack_filter_flag(int mode, int n, int cidx,
                                    bool chroma444) {
    if (cidx != 0 && !chroma444)
        return false;
    if (mode == 1 || n == 4)  // INTRA_DC or 4x4
        return false;
    int d26 = mode - 26 < 0 ? 26 - mode : mode - 26;
    int d10 = mode - 10 < 0 ? 10 - mode : mode - 10;
    int min_dist = d26 < d10 ? d26 : d10;
    int thres = n == 8 ? 7 : (n == 16 ? 1 : 0);
    return min_dist > thres;
}

// ops/mc.py chroma_mv_parts
static inline void pack_chroma_mv(int mv, int shift, int* off, int* frac) {
    *off = mv >> (2 + shift);
    *frac = (mv & ((1 << (2 + shift)) - 1)) << (1 - shift);
}

}  // namespace
}  // namespace hevc_native

// output row layouts (mirrored in hevc_tpu/native/__init__.py):
//   imeta  [Ni, 11]: cls, chunk, j, scal0..7
//   lmeta  [Nl, 11]: cls, lvl_off, qp, dst, ts, raw, mtx+1, rot,
//                    rdpcm, ccp_alpha, ccp_slot
//   mcrow  [Nm, 21]: is_ch, bi, w, h,
//                    sel, by, bx, fx, fy, sel1, by1, bx1, fx1, fy1,
//                    oy, ox, w0, o0, w1, o1, log2wd
//   residr [Nr, 4]:  cls, cy, cx, slot
//   pcmrow [Np, 6]:  plane, cy, cx, w, h, lvl_off
extern "C" int64_t hevc_native_pack_records(
    const int32_t* rec, int64_t n_rec, const PackP* params,
    const int64_t* z_order, const int32_t* slice_idx,
    const int32_t* tile_of_ctb,
    int32_t* imeta, uint8_t* iavail, int32_t* lmeta, int32_t* mcrow,
    int32_t* residr, int32_t* pcmrow, int64_t* out_counts) {
    const PackP& P = *params;
    PackCtx ctx{params, z_order, slice_idx, tile_of_ctb};

    // wavefront level maps per plane, one cell per cell of the plane's
    // minimum block grid (4x4 luma samples, (4 / SubWidthC) x
    // (4 / SubHeightC) chroma samples: h4 x w4 cells in every plane), on
    // which every record's edges lie.  -1 = unset, 0 = decoded without
    // intra, else the level.  Only intra records read the maps, so a
    // picture without one keeps none; a plane without records gets none.
    bool any_intra = false, has_plane[3] = {false, false, false};
    for (int64_t t = 0; t < n_rec; t++) {
        const int32_t* r = rec + t * REC_NCOLS;
        any_intra |= r[REC_KIND] == KIND_INTRA;
        has_plane[r[REC_PLANE]] = true;
    }
    const int mh = (P.height + 3) >> 2, mw = (P.width + 3) >> 2;
    int gx[3], gy[3];  // log2 of a grid cell's width and height in samples
    int32_t* lmap[3] = {nullptr, nullptr, nullptr};
    int64_t cells = 0;
    for (int p = 0; p < 3; p++) {
        gx[p] = p ? 3 - P.sub_w : 2;
        gy[p] = p ? 3 - P.sub_h : 2;
        if (any_intra && has_plane[p])
            cells += (int64_t)mh * mw;
    }
    // the maps' storage outlives the picture: one buffer per thread
    static thread_local std::vector<int32_t> lmap_buf;
    if (cells) {
        if (lmap_buf.size() < (size_t)cells)
            lmap_buf.resize(cells);
        std::fill(lmap_buf.begin(), lmap_buf.begin() + cells, -1);
        int32_t* next = lmap_buf.data();
        for (int p = 0; p < 3; p++)
            if (has_plane[p]) {
                lmap[p] = next;
                next += (size_t)mh * mw;
            }
    }
    // marks a block's cells decoded (0) where no intra level is set
    auto mark = [&](int32_t* m, int plane, int x, int y, int w, int h) {
        if (!m)
            return;
        int i0 = x >> gx[plane], i1 = (x + w) >> gx[plane];
        for (int j = y >> gy[plane]; j < (y + h) >> gy[plane]; j++)
            for (int i = i0; i < i1; i++)
                if (m[j * mw + i] < 0)
                    m[j * mw + i] = 0;
    };

    int32_t slot_count[4] = {0, 0, 0, 0};
    std::vector<int32_t> fill[4];  // per-class per-chunk fill counters
    // record index -> residual pool slot (CCP chroma rows reference
    // their TU's luma slot through REC_CCPREF)
    std::vector<int32_t> slot_of_rec((size_t)n_rec, 0);
    int64_t ni = 0, nl = 0, nm = 0, nr = 0, np_ = 0;
    int32_t max_chunk = -1;
    int64_t err = 0;

    for (int64_t t = 0; t < n_rec; t++) {
        const int32_t* r = rec + t * REC_NCOLS;
        int kind = r[REC_KIND];
        int plane = r[REC_PLANE];
        int x = r[REC_X], y = r[REC_Y];
        // intra and residual blocks are square (REC_H 0)
        int w = r[REC_W];
        int h = kind == KIND_MC || kind == KIND_PCM ? r[REC_H] : w;
        int32_t* m = lmap[plane];
        const int32_t* rg = P.reg[plane];
        // every edge on the plane's grid (a conforming stream's blocks)
        if (((x | w) & ((1 << gx[plane]) - 1))
            || ((y | h) & ((1 << gy[plane]) - 1))) {
            err = -6;
            break;
        }

        if (kind == KIND_MC) {
            mark(m, plane, x, y, w, h);
            int is_ch = plane > 0 ? 1 : 0;
            int bi = (r[REC_FLAGS] & F_BI) ? 1 : 0;
            int lx = (r[REC_FLAGS] & F_LX) ? 1 : 0;
            int tw = P.tile_mc ? (is_ch ? 2 : 4) : w;
            int th = P.tile_mc ? (is_ch ? 2 : 4) : h;
            for (int ty = 0; ty < h; ty += th)
                for (int tx_ = 0; tx_ < w; tx_ += tw) {
                    int bx_ = x + tx_, by_ = y + ty;
                    int32_t* o = mcrow + nm * 21;
                    nm++;
                    o[0] = is_ch;
                    o[1] = bi;
                    o[2] = tw;
                    o[3] = th;
                    auto entry = [&](int mvx, int mvy, int ridx, int l,
                                     int32_t* e) {
                        if (is_ch) {
                            int hs = P.sub_w - 1, vs = P.sub_h - 1;
                            int ox, fx, oy, fy;
                            pack_chroma_mv(mvx, hs, &ox, &fx);
                            pack_chroma_mv(mvy, vs, &oy, &fy);
                            e[1] = P.pad_ref + by_ + oy - 1;
                            e[2] = P.pad_ref + bx_ + ox - 1;
                            e[3] = fx;
                            e[4] = fy;
                            e[0] = (plane - 1) * P.nrefs + ridx
                                   + (l ? P.r0 : 0);
                        } else {
                            e[3] = mvx & 3;
                            e[4] = mvy & 3;
                            e[2] = P.pad_ref + bx_ + (mvx >> 2) - 3;
                            e[1] = P.pad_ref + by_ + (mvy >> 2) - 3;
                            e[0] = ridx + (l ? P.r0 : 0);
                        }
                        if (e[1] < 0 || e[2] < 0)
                            err = -5;  // MV exceeds PAD_REF
                    };
                    if (bi) {
                        entry(r[REC_MVX0], r[REC_MVY0], r[REC_REF0], 0,
                              o + 4);
                        entry(r[REC_MVX1], r[REC_MVY1], r[REC_REF1], 1,
                              o + 9);
                    } else {
                        entry(r[REC_MVX0], r[REC_MVY0], r[REC_REF0], lx,
                              o + 4);
                        for (int k = 9; k < 14; k++)
                            o[k] = 0;
                    }
                    o[14] = rg[0] + by_;
                    o[15] = rg[1] + bx_;
                    o[16] = r[REC_WPW0];
                    o[17] = r[REC_WPO0];
                    o[18] = r[REC_WPW1];
                    o[19] = r[REC_WPO1];
                    o[20] = r[REC_LOG2WD];
                }
            continue;
        }
        if (kind == KIND_PCM) {
            mark(m, plane, x, y, w, h);
            int32_t* o = pcmrow + np_ * 6;
            np_++;
            o[0] = plane;
            o[1] = rg[0] + y;
            o[2] = rg[1] + x;
            o[3] = w;
            o[4] = h;
            o[5] = r[REC_LVL];
            continue;
        }

        // intra / resid: residual slot assignment (plan order per class)
        int n = r[REC_W];
        int cls = n == 4 ? 0 : (n == 8 ? 1 : (n == 16 ? 2 : 3));
        int slot = 0;
        if (r[REC_LVL] >= 0 || r[REC_CCP] != 0) {
            slot = ++slot_count[cls];
            int32_t* o = lmeta + nl * 11;
            nl++;
            int f = r[REC_FLAGS];
            o[0] = cls;
            o[1] = r[REC_LVL];  // -1 = CCP-only: zero-level slot
            o[2] = r[REC_QP];
            o[3] = (f & F_DST) ? 1 : 0;
            o[4] = (f & F_TS) ? 1 : 0;
            o[5] = (f & F_TQB) ? 1 : 0;
            o[6] = r[REC_MTX] + 1;
            o[7] = (f & F_ROT) ? 1 : 0;
            o[8] = (f & F_RDPCM_V) ? 2 : ((f & F_RDPCM_H) ? 1 : 0);
            o[9] = r[REC_CCP];
            // REC_CCPREF = record index of the TU's luma record
            o[10] = r[REC_CCP] ? slot_of_rec[r[REC_CCPREF]] : 0;
            slot_of_rec[t] = slot;
        }
        if (kind == KIND_RESID) {
            mark(m, plane, x, y, n, n);
            int32_t* o = residr + nr * 4;
            nr++;
            o[0] = cls;
            o[1] = rg[0] + y;
            o[2] = rg[1] + x;
            o[3] = slot;
            continue;
        }

        // intra: wavefront level = 1 + max level over the L-shaped band
        // (the column left of the block and the row above it, each 2n
        // samples long from the corner, clipped to the plane), in cells
        int cx = x >> gx[plane], cy = y >> gy[plane];
        int cw = n >> gx[plane], ch = n >> gy[plane];
        int lvl = 0;
        if (cx > 0) {
            int jend = cy + 2 * ch < mh ? cy + 2 * ch : mh;
            for (int j = cy > 0 ? cy - 1 : 0; j < jend; j++)
                if (m[j * mw + cx - 1] + 1 > lvl)
                    lvl = m[j * mw + cx - 1] + 1;
        }
        if (cy > 0) {
            int iend = cx + 2 * cw < mw ? cx + 2 * cw : mw;
            for (int i = cx > 0 ? cx - 1 : 0; i < iend; i++)
                if (m[(cy - 1) * mw + i] + 1 > lvl)
                    lvl = m[(cy - 1) * mw + i] + 1;
        }
        for (int j = cy; j < cy + ch; j++)
            for (int i = cx; i < cx + cw; i++)
                m[j * mw + i] = lvl;
        if (lvl > max_chunk)
            max_chunk = lvl;
        if ((size_t)lvl >= fill[cls].size())
            fill[cls].resize(lvl + 1, 0);
        int jfill = fill[cls][lvl]++;

        // availability bitmap + prediction metadata (pack.py rec_meta)
        int sx = plane ? P.sub_w : 1;
        int sy = plane ? P.sub_h : 1;
        int rh = rg[2], rw = rg[3];
        int xl = x * sx, yl = y * sy;
        uint8_t* bits = iavail + ni * 128;
        memset(bits, 0, 128);
        for (int i = 0; i < 2 * n; i++) {
            if (y + i < rh
                && ctx.available(xl, yl, xl - sx, (y + i) * sy))
                bits[i] = 1;
            if (x + i < rw
                && ctx.available(xl, yl, (x + i) * sx, yl - sy))
                bits[64 + i] = 1;
        }
        int ac = ctx.available(xl, yl, xl - sx, yl - sy) ? 1 : 0;
        int mode = r[REC_MODE];
        bool filt = !P.smoothing_disabled
                    && pack_filter_flag(mode, n, plane, P.chroma444 != 0);
        bool strong = P.strong_smoothing && n == 32 && filt;
        int32_t* o = imeta + ni * 11;
        ni++;
        o[0] = cls;
        o[1] = lvl;
        o[2] = jfill;
        o[3] = rg[0] + y;
        o[4] = rg[1] + x;
        o[5] = mode;
        o[6] = slot;
        o[7] = filt ? 1 : 0;
        o[8] = strong ? 1 : 0;
        o[9] = (plane == 0 && n < 32) ? 1 : 0;
        o[10] = ac;
    }

    out_counts[0] = ni;
    out_counts[1] = nl;
    out_counts[2] = nm;
    out_counts[3] = nr;
    out_counts[4] = np_;
    out_counts[5] = max_chunk + 1;  // number of chunks (raw)
    out_counts[6] = cells;          // level-map cells used (0: none)
    return err;
}

// Residual-level gather: lmeta rows -> per-class (rmeta, int16 levels)
// device buffers in one pass (replaces the numpy fancy-index gather that
// dominated host pack time at 1080p).  Outputs must be zero-initialized
// by the caller (padding rows and the class counts are sized by Python
// from a bincount over lmeta[:, 0]).
extern "C" void hevc_native_gather_levels(
    const int16_t* lvl, const int32_t* lmeta, int64_t nl,
    int32_t* rm0, int32_t* rm1, int32_t* rm2, int32_t* rm3,
    int16_t* lv0, int16_t* lv1, int16_t* lv2, int16_t* lv3) {
    int32_t* rms[4] = {rm0, rm1, rm2, rm3};
    int16_t* lvs[4] = {lv0, lv1, lv2, lv3};
    int64_t fill[4] = {0, 0, 0, 0};
    for (int64_t t = 0; t < nl; t++) {
        const int32_t* o = lmeta + t * 11;
        int c = o[0];
        int s = 4 << c;
        int n = s * s;
        int64_t j = fill[c]++;
        int32_t* rm = rms[c] + j * 9;
        for (int k = 0; k < 9; k++)
            rm[k] = o[2 + k];
        int16_t* dst = lvs[c] + j * n;
        int32_t off = o[1];
        if (off >= 0)
            memcpy(dst, lvl + off, sizeof(int16_t) * n);
        // off < 0: CCP-only row keeps the zeroed slot
    }
}

// Deblocking boundary strengths (8.7.2.4) from the per-4x4 maps —
// scalar mirror of coding/picture.py compute_bs (the numpy version
// stays as the oracle; equality in tests/test_native_pack.py).
extern "C" void hevc_native_compute_bs(
    int32_t h4, int32_t w4, const uint8_t* is_intra,
    const uint8_t* cbf_luma, const uint8_t* edge_v, const uint8_t* edge_h,
    const uint8_t* tu_edge_v, const uint8_t* tu_edge_h,
    const int32_t* mv_l0, const int64_t* ref_poc_l0, const int32_t* mv_l1,
    const int64_t* ref_poc_l1, int8_t* bs_v, int8_t* bs_h) {
    const int64_t BIG = -((int64_t)1 << 30);
    auto ge4 = [&](const int32_t* a, const int32_t* b) {
        int dx = a[0] - b[0], dy = a[1] - b[1];
        if (dx < 0) dx = -dx;
        if (dy < 0) dy = -dy;
        return (dx >= 4 || dy >= 4);
    };
    auto motion_differs = [&](int p, int q) {
        bool p0 = ref_poc_l0[p] != BIG, p1 = ref_poc_l1[p] != BIG;
        bool q0 = ref_poc_l0[q] != BIG, q1 = ref_poc_l1[q] != BIG;
        int np_ = (int)p0 + (int)p1, nq = (int)q0 + (int)q1;
        if (np_ != nq)
            return true;
        if (np_ == 2 && nq == 2) {
            int64_t pl0 = ref_poc_l0[p], pl1 = ref_poc_l1[p];
            int64_t ql0 = ref_poc_l0[q], ql1 = ref_poc_l1[q];
            bool same_pair = (pl0 == ql0 && pl1 == ql1)
                             || (pl0 == ql1 && pl1 == ql0);
            if (!same_pair)
                return true;
            bool straight = ge4(mv_l0 + 2 * p, mv_l0 + 2 * q)
                            || ge4(mv_l1 + 2 * p, mv_l1 + 2 * q);
            bool crossed = ge4(mv_l0 + 2 * p, mv_l1 + 2 * q)
                           || ge4(mv_l1 + 2 * p, mv_l0 + 2 * q);
            if (pl0 == pl1)
                return straight && crossed;
            return (pl0 == ql0) ? straight : crossed;
        }
        const int32_t* pm = p0 ? mv_l0 + 2 * p : mv_l1 + 2 * p;
        const int32_t* qm = q0 ? mv_l0 + 2 * q : mv_l1 + 2 * q;
        int64_t pp = p0 ? ref_poc_l0[p] : ref_poc_l1[p];
        int64_t qp_ = q0 ? ref_poc_l0[q] : ref_poc_l1[q];
        return (pp != qp_) || ge4(pm, qm);
    };
    memset(bs_v, 0, (size_t)h4 * w4);
    memset(bs_h, 0, (size_t)h4 * w4);
    for (int y = 0; y < h4; y++)
        for (int x = 1; x < w4; x++) {
            int t = y * w4 + x;
            if (!edge_v[t])
                continue;
            int p = t - 1, q = t;
            int v;
            if (is_intra[p] || is_intra[q])
                v = 2;
            else if (((cbf_luma[p] || cbf_luma[q]) && tu_edge_v[t])
                     || motion_differs(p, q))
                v = 1;
            else
                v = 0;
            bs_v[t] = (int8_t)v;
        }
    for (int y = 1; y < h4; y++)
        for (int x = 0; x < w4; x++) {
            int t = y * w4 + x;
            if (!edge_h[t])
                continue;
            int p = t - w4, q = t;
            int v;
            if (is_intra[p] || is_intra[q])
                v = 2;
            else if (((cbf_luma[p] || cbf_luma[q]) && tu_edge_h[t])
                     || motion_differs(p, q))
                v = 1;
            else
                v = 0;
            bs_h[t] = (int8_t)v;
        }
}

#endif  // HEVC_TPU_STAGE_A_PACK_H
