// Copied from hevc_tpu/native/stage_a_mt.h at e99b487.
// Native stage-A parallel execution: WPP rows + tiles over std::thread.
//
// This is the native-runtime analogue of the reference's slice-thread
// job pool (reference: libavcodec/pthread_slice.c:239-299 per-row entry
// counters, hevcdec.c:2961 hls_decode_entry_wpp, :3144
// hls_decode_entry_tiles) re-designed for this engine's record-stream
// architecture: every row/tile decodes into its OWN record/level
// buffers which are concatenated in tile-scan order afterwards, so the
// output stream is bit-identical to the sequential decode_ctus walk.
//
// WPP synchronisation reproduces the spec's 2-CTU lag law exactly:
// row r may decode CTB x only once row r-1 has completed CTB x+1
// (progress >= x+2), and row r's CABAC contexts start from the
// snapshot row r-1 published after its second CTB.  Progress counters
// are release/acquire atomics — the release store after each CTB makes
// every picture-map write of that CTB visible to waiting rows.
// Tiles are fully independent (CABAC reinit, availability never
// crosses a tile edge) and just fan out.
//
// Included only from stage_a_syntax.h (reopens the unnamed namespace).
#ifndef HEVC_TPU_STAGE_A_MT_H
#define HEVC_TPU_STAGE_A_MT_H

#include <atomic>
#include <memory>
#include <thread>
#include <vector>

namespace hevc_native {
namespace {

struct RowBuf {
    // uninitialized on purpose: resize()'s zero-fill would cost more
    // than the decode itself at 1080p+ capacities
    std::unique_ptr<int32_t[]> rec;
    std::unique_ptr<int16_t[]> lvl;
    int64_t cap_rec = 0, cap_lvl = 0;
    int64_t n_rec = 0, lvl_used = 0;
    int err = 0;
    void alloc(int64_t cr, int64_t cl) {
        rec.reset(new int32_t[cr * REC_NCOLS]);
        lvl.reset(new int16_t[cl]);
        cap_rec = cr;
        cap_lvl = cl;
    }
};

// point a row/tile-local Dec at its own buffers + CABAC segment
static void dec_local_init(Dec& d, const Dec& proto, RowBuf& b,
                           uint8_t* ctx, int32_t* stat, int64_t seg_start) {
    d = proto;  // shallow copy: picture maps + tables stay shared
    d.ctx = ctx;
    d.stat = stat;
    d.rec = b.rec.get();
    d.cap_rec = b.cap_rec;
    d.n_rec = 0;
    d.lvl = b.lvl.get();
    d.cap_lvl = b.cap_lvl;
    d.lvl_used = 0;
    d.cur_qp = d.P.slice_qp;
    d.qp_pred_state = d.P.slice_qp;
    d.first_qp_group = true;
    d.qp_delta_coded = false;
    d.qp_delta_val = 0;
    d.cb.data = proto.rbsp;
    d.cb.nbytes = proto.nbytes;
    d.cb.init_at(seg_start);
}

// merge per-row/tile buffers (in order) into the shared output arrays,
// rebasing level offsets — the concatenation IS tile-scan decode order
static int merge_bufs(Dec& d, std::vector<RowBuf>& bufs) {
    for (RowBuf& b : bufs) {
        if (b.err)
            return b.err;
        if (d.n_rec + b.n_rec > d.cap_rec
            || d.lvl_used + b.lvl_used > d.cap_lvl)
            return -2;
        int32_t* dst = d.rec + d.n_rec * REC_NCOLS;
        memcpy(dst, b.rec.get(),
               sizeof(int32_t) * b.n_rec * REC_NCOLS);
        if (d.lvl_used)
            for (int64_t i = 0; i < b.n_rec; i++) {
                int32_t* r = dst + i * REC_NCOLS;
                if (r[REC_LVL] >= 0)
                    r[REC_LVL] += (int32_t)d.lvl_used;
            }
        memcpy(d.lvl + d.lvl_used, b.lvl.get(),
               sizeof(int16_t) * b.lvl_used);
        d.n_rec += b.n_rec;
        d.lvl_used += b.lvl_used;
    }
    return 0;
}

// worst-case record/level capacity for a region of n44 4x4 luma blocks
// (mirror of hevc_tpu/native/__init__.py _buffers)
static void region_caps(int64_t n44, int64_t* cap_rec, int64_t* cap_lvl) {
    *cap_rec = 4 * n44 + 1024;
    *cap_lvl = 48 * n44 + 4096;
}

// one WPP row of a rectangular region (a tile, or the whole picture):
// columns [cx0, cx0+tw), absolute CTB row yc = cy0 + r (r = region-
// local row index); progress/snaps are REGION-local arrays.  The
// 2-CTU lag and the after-2nd-CTB snapshot are tile-relative, exactly
// like the sequential rule (decode_ctus tile_col_start semantics;
// reference: hevc_cabac.c:560 ctb_tile_rs).
static void decode_wpp_row(Dec proto, int r, int cx0, int tw, int cy0,
                           int region_rows, int seg, RowBuf* buf,
                           uint8_t* ctx, int32_t* stat, uint8_t* snaps,
                           int32_t* snap_stat,
                           std::atomic<int32_t>* progress,
                           std::atomic<int32_t>* g_err) {
    const Params& P = proto.P;
    Dec d;
    dec_local_init(d, proto, *buf, ctx, stat, proto.seg_starts[seg]);
    int n_ctx = P.n_ctx;
    int yc = cy0 + r;
    if (r == 0) {
        memcpy(d.ctx, proto.fresh_ctx, n_ctx);
        memset(d.stat, 0, sizeof(int32_t) * 4);
    } else {
        // wait for the 2-CTU snapshot of the row above, then adopt it
        int spins = 0;
        while (progress[r - 1].load(std::memory_order_acquire) < 2) {
            if (g_err->load(std::memory_order_relaxed)) {
                progress[r].store(tw, std::memory_order_release);
                return;
            }
            if (++spins > 256)
                std::this_thread::yield();
        }
        memcpy(d.ctx, snaps + (int64_t)(r - 1) * n_ctx, n_ctx);
        memcpy(d.stat, snap_stat + (r - 1) * 4, sizeof(int32_t) * 4);
    }
    for (int i = 0; i < tw; i++) {
        int xc = cx0 + i;
        if (r > 0) {
            int need = i + 2 < tw ? i + 2 : tw;
            int spins = 0;
            while (progress[r - 1].load(std::memory_order_acquire)
                   < need) {
                if (g_err->load(std::memory_order_relaxed)) {
                    progress[r].store(tw, std::memory_order_release);
                    return;
                }
                if (++spins > 256)
                    std::this_thread::yield();
            }
        }
        d.slice_idx[yc * P.ctb_w + xc] = P.slice_idx_val;
        if (P.sao_enabled && (P.sao_luma || P.sao_chroma))
            decode_sao(d, xc, yc);
        coding_quadtree(d, xc << P.log2_ctb, yc << P.log2_ctb,
                        P.log2_ctb, 0);
        if (d.err) {
            buf->err = d.err;
            g_err->store(d.err, std::memory_order_relaxed);
            progress[r].store(tw, std::memory_order_release);
            return;
        }
        if (i == 1 && r + 1 < region_rows) {
            memcpy(snaps + (int64_t)r * n_ctx, d.ctx, n_ctx);
            memcpy(snap_stat + r * 4, d.stat, sizeof(int32_t) * 4);
        }
        d.cb.decode_terminate();  // end_of_slice_segment_flag
        progress[r].store(i + 1, std::memory_order_release);
    }
    buf->n_rec = d.n_rec;
    buf->lvl_used = d.lvl_used;
}

// WPP: one CABAC segment per CTB row, rows pipelined at 2-CTU lag.
// Caller guarantees: single slice covering the picture from CTB 0,
// n_segs == ctb_h, ctb_w >= 3.
static int64_t decode_wpp_mt(Dec& d, int n_threads) {
    const Params& P = d.P;
    int rows = P.ctb_h;
    int64_t cap_rec, cap_lvl;
    int64_t n44_row = (int64_t)P.w4 * (1 << (P.log2_ctb - 2));
    region_caps(n44_row, &cap_rec, &cap_lvl);
    std::vector<RowBuf> bufs(rows);
    for (RowBuf& b : bufs)
        b.alloc(cap_rec, cap_lvl);
    std::vector<uint8_t> ctxs((int64_t)rows * P.n_ctx);
    std::vector<int32_t> stats(rows * 4);
    std::vector<uint8_t> snaps((int64_t)rows * P.n_ctx);
    std::vector<int32_t> snap_stat(rows * 4);
    std::vector<std::atomic<int32_t>> progress(rows);
    for (auto& p : progress)
        p.store(0, std::memory_order_relaxed);
    std::atomic<int32_t> g_err{0};

    int T = n_threads < rows ? n_threads : rows;
    std::vector<std::thread> pool;
    auto run_row = [&](int r) {
        decode_wpp_row(d, r, 0, P.ctb_w, 0, rows, r, &bufs[r],
                       ctxs.data() + (int64_t)r * P.n_ctx,
                       stats.data() + r * 4, snaps.data(),
                       snap_stat.data(), progress.data(), &g_err);
    };
    for (int t = 1; t < T; t++)
        pool.emplace_back([&, t]() {
            for (int r = t; r < rows; r += T)
                run_row(r);
        });
    for (int r = 0; r < rows; r += T)
        run_row(r);
    for (auto& th : pool)
        th.join();
    if (g_err.load(std::memory_order_relaxed))
        return g_err.load(std::memory_order_relaxed);
    int err = merge_bufs(d, bufs);
    if (err)
        return err;
    return (int64_t)(P.ctb_w * P.ctb_h - 1);
}

// Tiles: one CABAC segment per tile, no cross-tile dependency at all.
// tile_starts = first ts of each tile (ascending), length n_tiles.
static int64_t decode_tiles_mt(Dec& d, int n_threads,
                               const std::vector<int>& tile_starts) {
    const Params& P = d.P;
    int n_tiles = (int)tile_starts.size();
    int n_ctbs = P.ctb_w * P.ctb_h;
    std::vector<RowBuf> bufs(n_tiles);
    std::vector<uint8_t> ctxs((int64_t)n_tiles * P.n_ctx);
    std::vector<int32_t> stats(n_tiles * 4);
    std::atomic<int32_t> g_err{0};

    auto run_tile = [&](int k) {
        int ts0 = tile_starts[k];
        int ts1 = k + 1 < n_tiles ? tile_starts[k + 1] : n_ctbs;
        int64_t n44 = (int64_t)(ts1 - ts0)
                      << (2 * (d.P.log2_ctb - 2));
        int64_t cap_rec, cap_lvl;
        region_caps(n44, &cap_rec, &cap_lvl);
        bufs[k].alloc(cap_rec, cap_lvl);
        Dec t;
        dec_local_init(t, d, bufs[k], ctxs.data() + (int64_t)k * P.n_ctx,
                       stats.data() + k * 4, d.seg_starts[k]);
        memcpy(t.ctx, d.fresh_ctx, P.n_ctx);
        memset(t.stat, 0, sizeof(int32_t) * 4);
        for (int ts = ts0; ts < ts1; ts++) {
            int rs = d.ts_to_rs[ts];
            int xc = rs % P.ctb_w, yc = rs / P.ctb_w;
            t.slice_idx[yc * P.ctb_w + xc] = P.slice_idx_val;
            if (P.sao_enabled && (P.sao_luma || P.sao_chroma))
                decode_sao(t, xc, yc);
            coding_quadtree(t, xc << P.log2_ctb, yc << P.log2_ctb,
                            P.log2_ctb, 0);
            if (t.err) {
                bufs[k].err = t.err;
                g_err.store(t.err, std::memory_order_relaxed);
                return;
            }
            t.cb.decode_terminate();
        }
        bufs[k].n_rec = t.n_rec;
        bufs[k].lvl_used = t.lvl_used;
    };

    int T = n_threads < n_tiles ? n_threads : n_tiles;
    std::vector<std::thread> pool;
    for (int t = 1; t < T; t++)
        pool.emplace_back([&, t]() {
            for (int k = t; k < n_tiles; k += T)
                run_tile(k);
        });
    for (int k = 0; k < n_tiles; k += T)
        run_tile(k);
    for (auto& th : pool)
        th.join();
    if (g_err.load(std::memory_order_relaxed))
        return g_err.load(std::memory_order_relaxed);
    int err = merge_bufs(d, bufs);
    if (err)
        return err;
    return (int64_t)d.ts_to_rs[n_ctbs - 1];
}

// WPP inside tiles: one CABAC segment per (tile x tile-row), rows
// pipelined at the tile-relative 2-CTU lag, tiles fully independent
// (reference: hevcdec.c:3196 hls_decode_entry_wpp_in_tiles keyed by
// wpp_pos_ts, hevc_ps.h:925).  Unit u = (tile k, local row j) in
// tile-scan order — which IS the segment order.
static int64_t decode_wpp_tiles_mt(Dec& d, int n_threads,
                                   const std::vector<int>& tile_starts) {
    const Params& P = d.P;
    int n_tiles = (int)tile_starts.size();
    int n_ctbs = P.ctb_w * P.ctb_h;
    struct Unit { int k, j, cx0, tw, cy0, rows, seg; };
    std::vector<Unit> units;
    std::vector<int> row_base(n_tiles);
    for (int k = 0; k < n_tiles; k++) {
        int ts0 = tile_starts[k];
        int ts1 = k + 1 < n_tiles ? tile_starts[k + 1] : n_ctbs;
        int rs0 = d.ts_to_rs[ts0];
        int cx0 = rs0 % P.ctb_w, cy0 = rs0 / P.ctb_w;
        // tile width = consecutive ts on the first row
        int tw = 0;
        while (ts0 + tw < ts1
               && d.ts_to_rs[ts0 + tw] / P.ctb_w == cy0)
            tw++;
        int rows = (ts1 - ts0) / tw;
        if (rows * tw != ts1 - ts0)
            return -30;  // non-rectangular tile (cannot happen)
        row_base[k] = (int)units.size();
        for (int j = 0; j < rows; j++)
            units.push_back({k, j, cx0, tw, cy0, rows,
                             (int)units.size()});
    }
    if ((int)units.size() != P.n_segs)
        return -31;  // segment layout mismatch: caller checks first
    int n_units = (int)units.size();
    std::vector<RowBuf> bufs(n_units);
    std::vector<uint8_t> ctxs((int64_t)n_units * P.n_ctx);
    std::vector<int32_t> stats(n_units * 4);
    std::vector<uint8_t> snaps((int64_t)n_units * P.n_ctx);
    std::vector<int32_t> snap_stat(n_units * 4);
    std::vector<std::atomic<int32_t>> progress(n_units);
    for (auto& p : progress)
        p.store(0, std::memory_order_relaxed);
    std::atomic<int32_t> g_err{0};

    auto run_unit = [&](int u) {
        const Unit& un = units[u];
        int64_t n44 = (int64_t)un.tw << (2 * (P.log2_ctb - 2));
        int64_t cap_rec, cap_lvl;
        region_caps(n44, &cap_rec, &cap_lvl);
        bufs[u].alloc(cap_rec, cap_lvl);
        int base = row_base[un.k];
        decode_wpp_row(d, un.j, un.cx0, un.tw, un.cy0, un.rows, un.seg,
                       &bufs[u], ctxs.data() + (int64_t)u * P.n_ctx,
                       stats.data() + u * 4,
                       snaps.data() + (int64_t)base * P.n_ctx,
                       snap_stat.data() + base * 4,
                       progress.data() + base, &g_err);
    };

    int T = n_threads < n_units ? n_threads : n_units;
    std::vector<std::thread> pool;
    for (int t = 1; t < T; t++)
        pool.emplace_back([&, t]() {
            for (int u = t; u < n_units; u += T)
                run_unit(u);
        });
    for (int u = 0; u < n_units; u += T)
        run_unit(u);
    for (auto& th : pool)
        th.join();
    if (g_err.load(std::memory_order_relaxed))
        return g_err.load(std::memory_order_relaxed);
    int err = merge_bufs(d, bufs);
    if (err)
        return err;
    return (int64_t)(P.ctb_w * P.ctb_h - 1);
}

// dispatch: parallel when the segment layout allows bit-exact fan-out,
// sequential decode_ctus otherwise
static int64_t run_slice(Dec& d, int n_threads) {
    const Params& P = d.P;
    bool whole_pic = P.seg_addr == 0;
    if (n_threads > 1 && whole_pic && P.wpp && !P.tiles
        && P.n_segs == P.ctb_h && P.ctb_w >= 3 && P.ctb_h >= 2)
        return decode_wpp_mt(d, n_threads);
    if (n_threads > 1 && whole_pic && P.tiles && P.n_segs >= 2) {
        int n_ctbs = P.ctb_w * P.ctb_h;
        std::vector<int> starts;
        for (int ts = 0; ts < n_ctbs; ts++)
            if (ts == 0 || d.tile_id_of_ts[ts] != d.tile_id_of_ts[ts - 1])
                starts.push_back(ts);
        if (!P.wpp && (int)starts.size() == P.n_segs)
            return decode_tiles_mt(d, n_threads, starts);
        if (P.wpp) {
            // count tile rows: a segment per (tile x row)
            int total_rows = 0;
            bool ok = true;
            for (size_t k = 0; k < starts.size() && ok; k++) {
                int ts0 = starts[k];
                int ts1 = k + 1 < starts.size() ? starts[k + 1] : n_ctbs;
                int cy0 = d.ts_to_rs[ts0] / P.ctb_w;
                int tw = 0;
                while (ts0 + tw < ts1
                       && d.ts_to_rs[ts0 + tw] / P.ctb_w == cy0)
                    tw++;
                if (tw < 3 || (ts1 - ts0) % tw != 0)
                    ok = false;
                else
                    total_rows += (ts1 - ts0) / tw;
            }
            if (ok && total_rows == P.n_segs) {
                int64_t r = decode_wpp_tiles_mt(d, n_threads, starts);
                if (r != -30 && r != -31)  // geometry bailouts only
                    return r;
            }
        }
    }
    return decode_ctus(d);
}

}  // namespace
}  // namespace hevc_native

#endif  // HEVC_TPU_STAGE_A_MT_H
