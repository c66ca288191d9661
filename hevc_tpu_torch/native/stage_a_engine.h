// Copied from hevc_tpu/native/stage_a_engine.h at e99b487.
// Native stage-A engine: CABAC arithmetic decoder + residual coding core.
//
// This is the TPU framework's analogue of the reference's C entropy
// engine (reference: libavcodec/cabac.c:177, cabac_functions.h:107,
// hevc_cabac.c:2408 ff_hevc_hls_coefficients_coding).  It is a direct
// re-expression of this repo's own spec-derived Python implementation
// (hevc_tpu/cabac/engine.py, hevc_tpu/coding/residual.py) — H.265
// clauses 9.3.4.3 (arithmetic decoding), 7.3.8.11 (residual_coding),
// 9.3.4.2.3-9.3.4.2.6 (context derivations) — NOT a port of ffmpeg.
//
// Contract: bit-exact with the Python path (tests/test_native.py,
// tests/test_native_stagea.py).
#ifndef HEVC_TPU_STAGE_A_ENGINE_H
#define HEVC_TPU_STAGE_A_ENGINE_H

#include <cstdint>
#include <cstring>

namespace hevc_native {

// ---- coarse phase profiling (tools/probe_stagea.py) -----------------------
// rdtsc accumulators, enabled via hevc_native_prof(); single-threaded
// measurement only (plain stores).  slots: 0 residual_core, 1 sao,
// 2 inter_pb, 3 decode_ctus, 4 level memset; +8 = call counts.
extern int64_t g_prof[16];
extern bool g_prof_on;

static inline uint64_t prof_tick() {
#if defined(__x86_64__)
    unsigned lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return ((uint64_t)hi << 32) | lo;
#else
    return 0;
#endif
}

struct ProfSpan {
    int slot;
    uint64_t t0;
    explicit ProfSpan(int s) : slot(s), t0(g_prof_on ? prof_tick() : 0) {}
    ~ProfSpan() {
        if (g_prof_on) {
            g_prof[slot] += (int64_t)(prof_tick() - t0);
            g_prof[slot + 8]++;
        }
    }
};

// Table 9-46: rangeTabLps[pStateIdx][qRangeIdx] (spec constant)
static const uint8_t RANGE_TAB_LPS[64][4] = {
    {128, 176, 208, 240}, {128, 167, 197, 227}, {128, 158, 187, 216},
    {123, 150, 178, 205}, {116, 142, 169, 195}, {111, 135, 160, 185},
    {105, 128, 152, 175}, {100, 122, 144, 166}, {95, 116, 137, 158},
    {90, 110, 130, 150},  {85, 104, 123, 142},  {81, 99, 117, 135},
    {77, 94, 111, 128},   {73, 89, 105, 122},   {69, 85, 100, 116},
    {66, 80, 95, 110},    {62, 76, 90, 104},    {59, 72, 86, 99},
    {56, 69, 81, 94},     {53, 65, 77, 89},     {51, 62, 73, 85},
    {48, 59, 69, 80},     {46, 56, 66, 76},     {43, 53, 63, 72},
    {41, 50, 59, 69},     {39, 48, 56, 65},     {37, 45, 54, 62},
    {35, 43, 51, 59},     {33, 41, 48, 56},     {32, 39, 46, 53},
    {30, 37, 43, 50},     {29, 35, 41, 48},     {27, 33, 39, 45},
    {26, 31, 37, 43},     {24, 30, 35, 41},     {23, 28, 33, 39},
    {22, 27, 32, 37},     {21, 26, 30, 35},     {20, 24, 29, 33},
    {19, 23, 27, 31},     {18, 22, 26, 30},     {17, 21, 25, 28},
    {16, 20, 23, 27},     {15, 19, 22, 25},     {14, 18, 21, 24},
    {14, 17, 20, 23},     {13, 16, 19, 22},     {12, 15, 18, 21},
    {12, 14, 17, 20},     {11, 14, 16, 19},     {11, 13, 15, 18},
    {10, 12, 15, 17},     {10, 12, 14, 16},     {9, 11, 13, 15},
    {9, 11, 12, 14},      {8, 10, 12, 14},      {8, 9, 11, 13},
    {7, 9, 11, 12},       {7, 9, 10, 12},       {7, 8, 10, 11},
    {6, 8, 9, 11},        {6, 7, 9, 10},        {6, 7, 8, 9},
    {2, 2, 2, 2},
};

// Table 9-47 (spec constant)
static const uint8_t TRANS_IDX_LPS[64] = {
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12, 13, 13, 15, 15,
    16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24, 24, 25, 26, 26, 27,
    27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33, 33, 33, 34, 34, 35, 35,
    35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
};

// 9.3.4.2.5: ctxIdxMap for 4x4 blocks
static const uint8_t CTX_IDX_MAP_4x4[16] = {0, 1, 4, 5, 2, 3, 4, 5,
                                            6, 6, 8, 8, 7, 7, 8, 8};

// Live arithmetic-decoder state, mirroring hevc_tpu.cabac.engine
// CabacDecoder (data/bytepos/range/offset/_bitbuf/_nbits).
struct Cabac {
    const uint8_t* data;
    int64_t bytepos;
    int64_t nbytes;
    int32_t range;
    int32_t offset;
    int32_t bitbuf;
    int32_t nbits;

    inline int next_byte() {
        int b = (bytepos < nbytes) ? data[bytepos] : 0;
        bytepos++;
        return b;
    }

    // 9.3.2.2 initialization (mirror of CabacDecoder.init)
    inline void init_at(int64_t byte_offset) {
        bytepos = byte_offset;
        range = 510;
        int b0 = next_byte();
        int b1 = next_byte();
        bitbuf = (b0 << 8) | b1;
        offset = bitbuf >> 7;
        bitbuf &= 0x7F;
        nbits = 7;
    }

    inline int read_bit() {
        if (nbits == 0) {
            bitbuf = next_byte();
            nbits = 8;
        }
        nbits--;
        return (bitbuf >> nbits) & 1;
    }

    // Read n <= 56 bits at once, keeping (bytepos, nbits, bitbuf)
    // CANONICAL — i.e. bit-for-bit the state n read_bit() calls would
    // leave (the Python engine mirror contract, tests/test_native.py).
    // When the read stays inside the current byte, bitbuf is untouched
    // (preserving the init-time 0x7F mask); when it crosses a byte
    // boundary, bitbuf becomes the full last byte, exactly as the
    // per-byte refill would produce.
    inline uint32_t read_bits_fast(int n) {  // n <= 31
        if (n == 0)
            return 0;
        if (n <= nbits) {  // stays within the buffered byte (bitbuf
            nbits -= n;    //  untouched, incl. the stale nbits==0 case)
            return (bitbuf >> nbits) & ((1u << n) - 1);
        }
        uint64_t acc = (uint64_t)(bitbuf & ((1 << nbits) - 1));
        int have = nbits;
        while (have < n) {
            acc = (acc << 8) | (uint32_t)next_byte();
            have += 8;
        }
        nbits = have - n;
        // bitbuf is the full last byte consumed (init mask only ever
        // applies before the first byte boundary is crossed)
        bitbuf = (bytepos >= 1 && bytepos - 1 < nbytes)
                     ? data[bytepos - 1] : 0;
        return (uint32_t)(acc >> nbits) & ((1u << n) - 1);
    }

    // Peek n <= 48 bits ahead without consuming.
    inline uint64_t peek_bits(int n) const {
        uint64_t acc = (uint64_t)(bitbuf & ((1 << nbits) - 1));
        int have = nbits;
        int64_t bp = bytepos;
        while (have < n) {
            acc = (acc << 8) | (uint32_t)(bp < nbytes ? data[bp] : 0);
            bp++;
            have += 8;
        }
        return acc >> (have - n);
    }

    inline int decode_bin(uint8_t* ctx) {
        int s = *ctx;
        int p = s >> 1;
        int mps = s & 1;
        int rlps = RANGE_TAB_LPS[p][(range >> 6) & 3];
        range -= rlps;
        int bit;
        if (offset >= range) {
            bit = 1 - mps;
            offset -= range;
            range = rlps;
            if (p == 0)
                mps = 1 - mps;
            *ctx = (uint8_t)((TRANS_IDX_LPS[p] << 1) | mps);
        } else {
            bit = mps;
            int nxt = p < 62 ? p + 1 : p;  // transIdxMps: min(p+1, 62)
            if (p == 63)
                nxt = 63;
            *ctx = (uint8_t)((nxt << 1) | mps);
        }
        if (range < 256) {  // renormalize in one multi-bit step
            int k = 9 - (32 - __builtin_clz((uint32_t)range));
            offset = (offset << k) | (int32_t)read_bits_fast(k);
            range <<= k;
        }
        return bit;
    }

    inline int decode_bypass() {
        offset = (offset << 1) | read_bit();
        if (offset >= range) {
            offset -= range;
            return 1;
        }
        return 0;
    }

    // n bypass bins in one step (9.3.4.3.4 applied n times is binary
    // long division): (offset << n | bits) = q * range + offset', with
    // q's binary digits being exactly the n decoded bins.  n <= 22
    // keeps offset<<n within uint64 comfortably (offset < 512).
    inline uint32_t decode_bypass_n(int n) {
        if (n == 0)
            return 0;
        uint64_t ext = ((uint64_t)(uint32_t)offset << n)
                       | read_bits_fast(n);
        uint32_t q = (uint32_t)(ext / (uint32_t)range);
        offset = (int32_t)(ext % (uint32_t)range);
        return q;
    }

    inline int decode_bypass_bits(int n) {
        if (n <= 22)
            return (int)decode_bypass_n(n);
        int v = (int)decode_bypass_n(22);
        return (v << (n - 22)) | (int)decode_bypass_n(n - 22);
    }

    inline int decode_terminate() {
        range -= 2;
        if (offset >= range)
            return 1;
        if (range < 256) {
            int k = 9 - (32 - __builtin_clz((uint32_t)range));
            offset = (offset << k) | (int32_t)read_bits_fast(k);
            range <<= k;
        }
        return 0;
    }

    // after pcm_flag's terminate: flush + byte-align; returns payload
    // start (mirror of CabacDecoder.begin_pcm)
    inline int64_t begin_pcm() {
        int64_t pos = (8 * bytepos - nbits + 7) >> 3;
        bitbuf = 0;
        nbits = 0;
        bytepos = pos;
        return pos;
    }
};

// coeff_abs_level_remaining (9.3.3.13): TR prefix + EGk escape.
// The unary prefix is found by PEEKING 25 bypass bins via the long-
// division identity and counting leading ones, then consuming exactly
// the bins the bit-at-a-time loop would have (prefix+1, capped at 24).
static inline int decode_remaining(Cabac* c, int rice) {
    uint64_t ext = ((uint64_t)(uint32_t)c->offset << 25)
                   | c->peek_bits(25);
    uint32_t q = (uint32_t)(ext / (uint32_t)c->range);
    uint32_t inv = (~q) & ((1u << 25) - 1);
    int prefix = inv ? 25 - (32 - __builtin_clz(inv)) : 25;
    if (prefix > 24)
        prefix = 24;
    c->decode_bypass_n(prefix < 24 ? prefix + 1 : 24);
    if (prefix < 3)
        return (prefix << rice) + c->decode_bypass_bits(rice);
    int nbits = prefix - 3 + rice;
    return (((1 << (prefix - 3)) + 2) << rice) + c->decode_bypass_bits(nbits);
}

// 9.3.4.2.5 sig_coeff_flag context (mirror of residual.py _sig_ctx)
static inline int sig_ctx(int log2_size, int c_idx, int xc, int yc,
                          int scan_idx, const uint8_t* csbf, int nsb) {
    int s;
    if (log2_size == 2) {
        s = CTX_IDX_MAP_4x4[(yc << 2) + xc];
    } else if (xc + yc == 0) {
        s = 0;
    } else {
        int xs = xc >> 2, ys = yc >> 2;
        int prev = 0;
        if (xs < nsb - 1 && csbf[ys * nsb + xs + 1])
            prev += 1;
        if (ys < nsb - 1 && csbf[(ys + 1) * nsb + xs])
            prev += 2;
        int xp = xc & 3, yp = yc & 3;
        if (prev == 0)
            s = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
        else if (prev == 1)
            s = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
        else if (prev == 2)
            s = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
        else
            s = 2;
        if (c_idx == 0) {
            if (xs + ys > 0)
                s += 3;
            if (log2_size == 3)
                s += (scan_idx == 0) ? 9 : 15;  // SCAN_DIAG == 0
            else
                s += 21;
        } else {
            s += (log2_size == 3) ? 9 : 12;
        }
    }
    return s + (c_idx ? 27 : 0);
}

// Context-offset layout indices, matching the fixed order the Python
// wrapper emits (hevc_tpu.cabac.ctx _LAYOUT order — single source of
// truth stays in Python).
enum CtxId {
    SAO_MERGE_FLAG = 0, SAO_TYPE_IDX, SPLIT_CU_FLAG,
    CU_TRANSQUANT_BYPASS_FLAG, CU_SKIP_FLAG, CU_QP_DELTA, PRED_MODE_FLAG,
    PART_MODE, PREV_INTRA_LUMA_PRED_FLAG, INTRA_CHROMA_PRED_MODE,
    MERGE_FLAG, MERGE_IDX, INTER_PRED_IDC, REF_IDX_L0, REF_IDX_L1,
    ABS_MVD_GREATER0_FLAG, ABS_MVD_GREATER1_FLAG, MVP_LX_FLAG,
    NO_RESIDUAL_DATA_FLAG, SPLIT_TRANSFORM_FLAG, CBF_LUMA, CBF_CBCR,
    TRANSFORM_SKIP_FLAG, EXPLICIT_RDPCM_FLAG, EXPLICIT_RDPCM_DIR_FLAG,
    LAST_SIG_X, LAST_SIG_Y, CODED_SUB_BLOCK_FLAG, SIG_COEFF_FLAG,
    GREATER1, GREATER2, LOG2_RES_SCALE_ABS, RES_SCALE_SIGN,
    CU_CHROMA_QP_OFFSET_FLAG, CU_CHROMA_QP_OFFSET_IDX, N_CTX_IDS
};

// active rext residual tools (mirror of coding/residual.py RextCtx);
// null rx = all tools off
struct RextP {
    int32_t persistent_rice, ts_context, implicit_rdpcm, explicit_rdpcm;
};

// residual_coding (7.3.8.11) — decodes one TB's levels into `levels`
// (size*size int32, zeroed here).  `off` maps CtxId -> ctx array base.
// Scan tables are passed in (single source of truth: coding/scans.py).
// Mirrors coding/residual.py decode_residual exactly, including the
// rext tools (persistent rice via `stat`, skip sig contexts, explicit
// RDPCM flags returned through rdpcm_out = {flag, dir}).
static inline void decode_residual_core_impl(
    Cabac* c, uint8_t* ctx, const int32_t* off,
    int32_t log2_size, int32_t c_idx, int32_t scan_idx,
    int32_t sign_data_hiding, int32_t ts_allowed, int32_t tq_bypass,
    const int32_t* sub_scan, const int32_t* coef_scan,
    const int32_t* pos_of_xy, int16_t* levels, int32_t* ts_flag_out,
    const RextP* rx = nullptr, int pred_inter = 0, int intra_mode = -1,
    int32_t* stat = nullptr, int32_t* rdpcm_out = nullptr) {
    const int size = 1 << log2_size;
    {
        ProfSpan _pm(4);
        memset(levels, 0, sizeof(int16_t) * size * size);
    }

    int ts_flag = 0;
    if (ts_allowed && !tq_bypass)
        ts_flag = c->decode_bin(
            ctx + off[TRANSFORM_SKIP_FLAG] + (c_idx ? 1 : 0));
    *ts_flag_out = ts_flag;
    const int skip_like = ts_flag || tq_bypass;
    int rdpcm_flag = 0, rdpcm_dir = 0;
    if (rx && rx->explicit_rdpcm && pred_inter && skip_like) {
        rdpcm_flag = c->decode_bin(
            ctx + off[EXPLICIT_RDPCM_FLAG] + (c_idx ? 1 : 0));
        if (rdpcm_flag)
            rdpcm_dir = c->decode_bin(
                ctx + off[EXPLICIT_RDPCM_DIR_FLAG] + (c_idx ? 1 : 0));
    }
    if (rdpcm_out) {
        rdpcm_out[0] = rdpcm_flag;
        rdpcm_out[1] = rdpcm_dir;
    }
    const int ts_ctx = rx && rx->ts_context && skip_like;
    // SDH is off for bypass / rdpcm blocks (sign_always_hidden)
    const int sdh_off = tq_bypass || rdpcm_flag
        || (rx && rx->implicit_rdpcm && !pred_inter && ts_flag
            && (intra_mode == 10 || intra_mode == 26));
    const int use_price = rx && rx->persistent_rice;
    const int sb_type = (c_idx == 0 ? 2 : 0) + (skip_like ? 1 : 0);

    // ---- last significant coefficient position ----
    int coff, cshift;
    if (c_idx == 0) {
        coff = 3 * (log2_size - 2) + ((log2_size - 1) >> 2);
        cshift = (log2_size + 1) >> 2;
    } else {
        coff = 15;
        cshift = log2_size - 2;
    }
    int cmax = (log2_size << 1) - 1;
    int px = 0;
    while (px < cmax
           && c->decode_bin(ctx + off[LAST_SIG_X] + coff + (px >> cshift)))
        px++;
    int py = 0;
    while (py < cmax
           && c->decode_bin(ctx + off[LAST_SIG_Y] + coff + (py >> cshift)))
        py++;
    int last_x, last_y;
    if (px > 3) {
        int nb = (px >> 1) - 1;
        last_x = ((2 + (px & 1)) << nb) + c->decode_bypass_bits(nb);
    } else {
        last_x = px;
    }
    if (py > 3) {
        int nb = (py >> 1) - 1;
        last_y = ((2 + (py & 1)) << nb) + c->decode_bypass_bits(nb);
    } else {
        last_y = py;
    }
    if (scan_idx == 2) {  // SCAN_VERT
        int t = last_x;
        last_x = last_y;
        last_y = t;
    }

    const int nsb = (size >> 2) > 0 ? (size >> 2) : 1;
    int last_pos = pos_of_xy[last_y * size + last_x];
    int last_sb = last_pos >> 4, last_n = last_pos & 15;
    uint8_t csbf[64];  // up to 8x8 sub-blocks (32x32 TB)
    memset(csbf, 0, nsb * nsb);

    int c1 = 1;  // greater1 state, persists across sub-blocks
    int sig_pos[16];
    for (int i = last_sb; i >= 0; i--) {
        int xs = sub_scan[2 * i], ys = sub_scan[2 * i + 1];
        int infer_dc = 0;
        int sbf;
        if (i > 0 && i < last_sb) {
            int right = (xs + 1 < nsb) ? csbf[ys * nsb + xs + 1] : 0;
            int below = (ys + 1 < nsb) ? csbf[(ys + 1) * nsb + xs] : 0;
            int cx = (right + below > 0 ? 1 : 0) + (c_idx ? 2 : 0);
            sbf = c->decode_bin(ctx + off[CODED_SUB_BLOCK_FLAG] + cx);
            infer_dc = 1;
        } else {
            sbf = 1;
        }
        csbf[ys * nsb + xs] = (uint8_t)sbf;
        if (!sbf)
            continue;

        // significant_coeff_flag, descending scan position
        int nsig = 0;
        int n_start;
        if (i == last_sb) {
            sig_pos[nsig++] = last_n;
            n_start = last_n - 1;
        } else {
            n_start = 15;
        }
        for (int n = n_start; n > 0; n--) {
            int xp = coef_scan[2 * n], yp = coef_scan[2 * n + 1];
            int cx = ts_ctx ? (c_idx == 0 ? 42 : 43)
                            : sig_ctx(log2_size, c_idx, (xs << 2) + xp,
                                      (ys << 2) + yp, scan_idx, csbf,
                                      nsb);
            if (c->decode_bin(ctx + off[SIG_COEFF_FLAG] + cx)) {
                sig_pos[nsig++] = n;
                infer_dc = 0;
            }
        }
        if (n_start >= 0) {
            if (infer_dc) {
                sig_pos[nsig++] = 0;  // inferred significant DC
            } else {
                int cx = ts_ctx ? (c_idx == 0 ? 42 : 43)
                                : sig_ctx(log2_size, c_idx, xs << 2,
                                          ys << 2, scan_idx, csbf, nsb);
                if (c->decode_bin(ctx + off[SIG_COEFF_FLAG] + cx))
                    sig_pos[nsig++] = 0;
            }
        }
        if (nsig == 0)
            continue;

        // greater1 flags (first 8 significant coeffs)
        int ctx_set = ((i > 0 && c_idx == 0) ? 2 : 0) + (c1 == 0 ? 1 : 0);
        c1 = 1;
        int gt1[16];
        int gt2_target = -1;
        int n_gt1 = nsig < 8 ? nsig : 8;
        for (int m = 0; m < n_gt1; m++) {
            int base = (c_idx ? 16 : 0) + 4 * ctx_set + c1;
            int f = c->decode_bin(ctx + off[GREATER1] + base);
            gt1[m] = f;
            if (f) {
                if (gt2_target < 0)
                    gt2_target = sig_pos[m];
                c1 = 0;
            } else if (c1 > 0 && c1 < 3) {
                c1++;
            }
        }
        int gt2 = 0;
        if (gt2_target >= 0)
            gt2 = c->decode_bin(ctx + off[GREATER2] + (c_idx ? 4 : 0)
                                + ctx_set);

        // signs (bypass; possibly one hidden)
        int first_nz = sig_pos[nsig - 1], last_nz = sig_pos[0];
        int hidden = (sign_data_hiding && !sdh_off
                      && (last_nz - first_nz) >= 4);
        int nsigns = hidden ? nsig - 1 : nsig;
        int signs[16];
        uint32_t sv = c->decode_bypass_n(nsigns);
        for (int m = 0; m < nsigns; m++)
            signs[m] = (sv >> (nsigns - 1 - m)) & 1;

        // remaining levels (persistent rice: StatCoeff-seeded parameter
        // with unclamped in-CG growth, one stat update per sub-block)
        int rice = use_price ? (stat[sb_type] >> 2) : 0;
        int stat_pending = use_price;
        int sum_abs = 0;
        int lvls[16];
        for (int m = 0; m < nsig; m++) {
            int lvl = 1;
            int threshold;
            if (m < 8) {
                lvl += gt1[m];
                if (sig_pos[m] == gt2_target)
                    lvl += gt2;
                threshold = (sig_pos[m] == gt2_target) ? 3 : 2;
            } else {
                threshold = 1;
            }
            if (lvl == threshold) {
                int rem = decode_remaining(c, rice);
                lvl += rem;
                if (use_price) {
                    if (lvl > (3 << rice))
                        rice++;
                    if (stat_pending) {
                        int init = stat[sb_type] >> 2;
                        if (rem >= (3 << init))
                            stat[sb_type]++;
                        else if (2 * rem < (1 << init)
                                 && stat[sb_type] > 0)
                            stat[sb_type]--;
                        stat_pending = 0;
                    }
                } else if (lvl > (3 << rice)) {
                    rice = rice < 4 ? rice + 1 : 4;
                }
            }
            lvls[m] = lvl;
            sum_abs += lvl;
        }
        for (int m = 0; m < nsig; m++) {
            int n = sig_pos[m];
            int xp = coef_scan[2 * n], yp = coef_scan[2 * n + 1];
            int sgn;
            if (hidden && m == nsig - 1)
                sgn = (sum_abs & 1) ? -1 : 1;
            else
                sgn = signs[m] ? -1 : 1;
            levels[((ys << 2) + yp) * size + (xs << 2) + xp]
                = sgn * lvls[m];
        }
    }
}

}  // namespace hevc_native

#endif  // HEVC_TPU_STAGE_A_ENGINE_H
