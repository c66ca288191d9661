"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. checks that the port's native stage A is built (with g++, into
   ``hevc_tpu_torch/build/``; it would silently fall back to Python
   otherwise), builds the CUDA kernels from ``csrc/`` and measures the
   launch floor (``intra_cuda.launch_floor_ms``: the device time between
   two back-to-back empty launches, the intra kernel's chain step);
3. holds each kernel against its plain PyTorch version, bit for bit
   (tolerance 0), on random cases of every MC flavour and residual class,
   on a picture's mixed MC groups and all four residual classes in one
   launch each, the intra kernel on the six seeded chunk tables of
   ``hevc_tpu_torch.intra_cases`` (one launch per live chunk), and the
   loop filter kernels (deblocking, two launches; SAO, one) on two draws
   of each picture of ``hevc_tpu_torch.filter_cases``, and the residual
   kernel (one launch) on two draws of each case of
   ``hevc_tpu_torch.resid_cases``;
4. decodes a 96x80 IPP stream on the card and compares it with the
   port's inline NumPy decoder, then decodes a 4-frame 1920x1080 IPP/WPP
   stream (the headline stream of ``bench.py``, cut to 4 frames and
   cached under ``.bench/``) twice uncounted (the second capturing each
   kernel's inputs) and once counted, through ``hevc_tpu_torch.cli.main``,
   and checks every frame's SEI MD5, that MC launched once and the
   residual add at most once per inter picture on that run, and that the
   outputs lived on the card, that the intra kernel launched once per
   live chunk of every picture, the loop filter kernels three times a
   picture and the residual kernel once a picture; then holds both inter
   kernels against
   their plain versions on the captured rows of a real 1080p P frame and
   the intra kernel on the captured I picture (``intra_place``: error 0,
   its time beside the plain version's and its bound) and times them
   there with CUDA events and ``torch.profiler`` (after the counted run,
   which no profiler session may precede: see PERF.md); then both inter
   kernels and the intra kernel on the first five pictures of the 10-bit
   3840x2160 bank ``main10_2160/ra`` (``phase_bank_kernels``); then the
   loop filter kernels on pictures of the benchmark's banks
   (``phase_loop_filter``: an IDR, a P and a leaf B of ``main1080/ra``
   and of ``main10_2160/ra``, an IDR of ``main1080/intra``), bit for
   bit, timed beside the plain versions, the wrappers' host cost and the
   bound; then the residual kernel the same way (``phase_residuals``:
   those pictures and the SHVC bank's base-layer IDR and an
   enhancement-layer P).  The 1080p
   streams are encoded once into ``.bench/`` by worker processes, one a
   stream, that start with the script and are done before the first
   1080p decode;
5. the formats phase: three more 1920x1080 IPP streams (``FORMATS``: A
   4:2:0 with 4 slices over 2x2 tiles without cross-tile filtering,
   per-slice deblocking parameters and PCM CUs exempt from the loop
   filters; B 4:2:2 10-bit with dependent slice segments and WPP, whose
   stage A runs in the Python syntax layer; C 4:0:0), each decoded with
   ``TorchDecoder`` twice: once capturing the kernels' inputs and timing
   each stage with the card synchronised, once counted, with every MD5
   checked, every output and device DPB entry on the card, MC launched
   once per P picture and the residual add at least once; then holds both
   inter kernels against their plain versions on a captured P picture of
   the stream and the intra kernel on its I picture (tolerance 0) and
   prints fps and the stage split; then the
   COO check: how many pictures of the main and formats streams shipped
   their level pools as (idx, val) pairs on their counted decodes, and on
   the first such picture the frame program on the pairs against the
   frame program on the dense pool rebuilt on the host (bit for bit), the
   dense upload, the host's pair build, the pairs' upload and the device
   scatter timed;
6. the SHVC phase: a two-layer stream (``SHVC_STREAM``: 1280x720 base
   layer, 1920x1080 enhancement layer, 3 access units, TMVP from the
   inter-layer reference), decoded by ``TorchDecoder`` with the kernels'
   and the upsampler's inputs captured and the inter-layer build timed
   with the card synchronised, then counted through ``cli.main -l 1``:
   every MD5 of both layers, every picture through the frame program,
   ``mc`` once per P picture of both layers, no reference from the host;
   both inter kernels against their plain versions on a captured EL
   picture, the intra kernel on the EL picture with the most intra
   records (the BL's I picture where the EL pictures hold none), the
   upsampler and a CGS colour mapping on the card against
   the CPU, and each layer's fps without the fetch
   (``LazyPlanes.device_ready``);
7. the CABAC path: captures every WPP substream of that 1080p stream
   with the port's Python engine (one row per substream) and
   encodes random row sets of 4,096 bins (R = 1, 8, 132, 1,024); the sets
   are all 68 substreams, the first 17 (one picture's rows), the random
   ones, the R = 1,024 set repeated to one row more than the card decodes
   at once, and 33 ragged rows whose bins, bytes and row count are all
   one more than a multiple of the kernel's chunk and vector width.  With
   the launch count at 0, decodes all of them through
   ``hevc_tpu_torch.cabac.rows.decode_rows``; then holds the CABAC kernel's
   bins against the captured bins, the encoder's bins and the plain
   version (tolerance 0, the padding included), times the bare launch,
   the entry point and the plain version, and prints each set's chain
   bound with its terms (``cabac.rows.chain_bound``, from the two
   latencies ``chain_latency_kernel`` measures and the card's highest SM
   clock);
8. the banded phase: ``BANDED_STREAM`` (``.bench/smoke_1920x1080_qp30_
   ctb64_tiles3x1_3f.265``: the headline settings without WPP, in three
   column tiles with loop filtering across them, I P P) in three column
   bands of 640 through ``hevc_tpu_torch.sharded`` (on this card, or
   spread over the cards there are): stage A and the band packs on the
   host (``band.prepare_gop_banded``, every MD5 of its NumPy decode
   correct), a captured ``decode_gop_banded`` run (every band's kernel
   inputs; stage B and each halo exchange timed with the cards
   synchronised), a counted run (launch counts and host references from 0
   just before, read just after; each picture's stage B by CUDA events):
   every plane equal to the sequential decode, 0 references from the
   host, ``mc`` once per band of each P picture (6), the intra kernel once
   per live chunk of every band; both inter kernels against their plain
   versions on a P picture's bands 0 and 1, the intra kernel on the I
   picture's band 1 (tolerance 0); ``decode_stream_banded`` over
   ``iter_gop_banded`` with the halo forced to widen mid-GOP; ``TorchDecoder`` on the same stream for
   comparison; with three cards or more ``python -m
   hevc_tpu_torch.dist_worker --stream BANDED_STREAM`` over NCCL, one
   process and one band a card, each rank's band equal to the same
   columns of the sequential decode (with fewer it prints that the path
   was not run); then formats stream A (4 slices over 2x2 tiles with
   per-slice filters, PCM) in its two tile columns, captured and counted
   the same way (``mc`` 4), and with two cards or more through
   ``dist_worker`` over NCCL;
9. the frame-axis phase: ``PGOP_STREAM`` (``.bench/smoke_1920x1080_qp30_
   ctb64_pgop4b.265``: ``ParallelBGopEncoder(n_b=4)`` at the headline
   settings, I0, P5, then B1-B4 reading only the anchors) decoded by
   ``TorchDecoder`` (every MD5), then counted through
   ``pgop_frame.decode_frame_parallel`` over the cards: B1-B4 one batch,
   every picture's MD5 correct and every plane equal to the sequential
   decode, 0 references from the host, ``mc`` once per inter picture;
10. the stage-B phase (right after step 4): the main stream through
   ``capture.stage_timings``: its last P picture's frame program replayed
   16 times (each replay equal to the decode, replays a second), each
   stage alone on that picture's inputs by CUDA events beside its bound
   (``bounds.stage_b_work``), and, at the end, the replays' device-busy
   time and idle share from a ``torch.profiler`` trace;
11. the probe path: with the launch counts at 0, runs
   ``hevc_tpu_torch.probes.run_probes`` (tile roll and slice, the roll of
   an 8K plane, the five TMA window cases of ``tools/probe_dma.py``, the
   2,880-block TMA pipeline and the pipeline over two 8192 x 8192
   planes), checks each kernel against its plain version and the window
   outcomes (four OK, the two at an unaligned inner offset loaded from the
   aligned x while one box there faults in a child process, and the
   (40, 39) box refused by the tensor-map encoder), checks that a tensor
   map was encoded once per plane and box however many launches used it,
   and times each kernel beside its plain version and the one PyTorch
   call for the same function (by CUDA events here, and by
   ``torch.profiler`` at the end), each wrapper's host cost a call, and
   the rate device copies reach in L2 (``probes.copy_rates``), over which
   the TMA ring's bytes on the probe's planes give its bound there;
12. prints the kernel table as JSON: per kernel its launches on the
    counted run (the inter and intra kernels': the main stream's), its
    error against the plain version (the intra kernel's: the largest over
    every place it was held), the kernel's, the plain version's and (where one
    PyTorch call computes the same function) that call's ms, and the
    bound: the largest of the bytes the function must move over 3.35 TB/s,
    its operations over the card's peak rate for their type and, where the
    work is one dependent chain a row, that chain's latency; then the
    card, and last ``{"ok": true, "device": {...}}``, after checking that
    neither ``jax`` nor ``hevc_tpu`` was imported.

Any failure raises, so the script exits nonzero before the last line.  It
also exits nonzero at once without a visible CUDA device.
"""
from __future__ import annotations

import contextlib
import io
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from hevc_tpu_torch.bounds import (HBM_BYTES_S, bound_ms, intra_work,
                                   loop_filter_work, mc_work, resid_work,
                                   residual_work)
from hevc_tpu_torch.capture import (Capture, intra_args, kernel_errors,
                                    mc_error, resid_add_error,
                                    stage_timings)
from hevc_tpu_torch.device import cuda_ms, profiler_ms
from hevc_tpu_torch.encoder.generate import synth_stream

ROOT = os.path.dirname(os.path.abspath(__file__))
# (kernel name, launch) of each kernel to trace with torch.profiler once
# every other phase is done: after a profiler session the process's later
# launches of small eager ops ran slower (PERF.md, PR 3)
PROFILE = []
# (kernel name, the one PyTorch call for the same function): traced there
# too, every kernel and copy of the call summed
PROFILE_LIBRARY = []
# (capture.Replay, replays) of phase_stage_b: their device-busy time is
# traced there too
PROFILE_REPLAYS = []
# the device time between two back-to-back empty launches, ms: (queued on
# the card, as the host issues them); the intra kernel's chain bound is the
# live chunks times the first (prepare)
FLOOR = []
# every intra kernel check's (place, error): all must be 0 (intra_place)
INTRA_ERRORS = []
# every loop filter check's (place, error): all must be 0
LOOP_FILTER_ERRORS = []
# (place, the loop filter kernels' launches of one picture): traced at the
# end, every kernel of the call summed
PROFILE_LOOP_FILTER = []
# every residual kernel check's (place, error): all must be 0
RESID_ERRORS = []
# (place, the residual kernel's launch of one picture): traced at the end
PROFILE_RESID = []
BANKS = os.path.join(ROOT, "benchmark", "data", "main1080")
CACHE = os.path.join(ROOT, ".bench")
W, H, QP, FRAMES = 1920, 1080, 30, 4
STREAM = os.path.join(CACHE, f"smoke_{W}x{H}_qp{QP}_ctb64_wpp_{FRAMES}f.265")


def log(*a):
    print(*a, flush=True)


# the formats phase's 1920x1080 streams: synth_stream's settings plus these
# (PCM CUs are at most 32x32, so stream A codes 32x32 CUs in its 64x64 CTBs)
FORMATS = {
    "A 4:2:0 8-bit, 4 slices over 2x2 tiles, per-slice filters, PCM": (
        dict(slices=4, tiles=(2, 2), lf_across_tiles=False,
             slice_filter_params=(dict(beta_offset=2, tc_offset=-2),
                                  dict(disable=True), dict(lf_across=False),
                                  dict(beta_offset=-4, tc_offset=4)),
             pcm=0.05, pcm_loop_filter_disabled=True, log2_cu_size=5), 3),
    "B 4:2:2 10-bit, dependent slices with WPP": (
        dict(chroma_format_idc=2, bit_depth=10, dependent_slices=2), 3),
    "C 4:0:0 8-bit": (dict(chroma_format_idc=0), 3),
}


# the banded phase's second stream: stream A in its two tile columns
FORMAT_A = next(n for n in FORMATS if n.startswith("A "))
BANDS_A = 2


def format_path(name):
    return os.path.join(CACHE, f"smoke_{W}x{H}_qp{QP}_ctb64_wpp_"
                        f"{FORMATS[name][1]}f_fmt{name[0]}.265")


# the SHVC phase's two-layer stream: the SHM common test conditions' 1.5x
# spatial configuration, a 1280x720 base layer under a 1920x1080
# enhancement layer (an HD layer over a 720p base, as broadcasters send)
SHVC_BL, SHVC_EL, SHVC_AUS = (1280, 720), (W, H), 3
SHVC_STREAM = os.path.join(CACHE, f"smoke_shvc_1280x720_{W}x{H}_qp{QP}_"
                           f"ctb64_tmvp_{SHVC_AUS}au.265")


def decimate(plane, h, w):
    """The plane sampled down to h x w (nearest sample)."""
    return plane[np.arange(h) * plane.shape[0] // h][
        :, np.arange(w) * plane.shape[1] // w]


def synth_shvc(path, aus=SHVC_AUS):
    """SHVC_STREAM: 4:2:0 8-bit, QP 30 on both layers, 64x64 CTBs,
    deblocking and SAO, IPP, TMVP on both layers with the enhancement
    layer's collocated picture the inter-layer reference (the upscaled
    base-layer motion field); the base layer codes the enhancement layer's
    picture decimated to 720p."""
    from hevc_tpu_torch.encoder.core import EncoderConfig
    from hevc_tpu_torch.encoder.generate import synth_frame
    from hevc_tpu_torch.encoder.shvc import ShvcEncoder

    def cfg(wh, seed, **kw):
        return EncoderConfig(width=wh[0], height=wh[1], qp=QP,
                             log2_ctb_size=6, log2_cu_size=6,
                             deblocking=True, sao=True, gop="ipp",
                             search_range=3, tmvp=True, seed=seed, **kw)

    enc = ShvcEncoder(cfg(SHVC_BL, 1), cfg(SHVC_EL, 2, tmvp_col_ref_idx=1))
    (bw, bh), (ew, eh) = SHVC_BL, SHVC_EL
    base = synth_frame("gradient", ew, eh, 0, seed=9)
    data = bytearray()
    for t in range(aus):
        el = [np.roll(base[0], (t * 4, t * 7), (0, 1))] + [
            np.roll(c, (t * 2, t * 3), (0, 1)) for c in base[1:]]
        bl = [decimate(el[0], bh, bw)] + [decimate(c, bh // 2, bw // 2)
                                          for c in el[1:]]
        data += enc.encode_frame(bl, el)
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


# the banded phase's stream: the headline settings without WPP, in three
# column tiles (30 CTB columns: three tile-aligned bands of 640 columns, one
# of them interior), loop filtering across the tiles; I P P.  Broadcast
# encoders send UHD/HD streams with column tiles for such parallel decode.
BANDS, BANDED_FRAMES = 3, 3
BANDED = dict(wpp=False, tiles=(BANDS, 1), lf_across_tiles=True)
BANDED_STREAM = os.path.join(CACHE, f"smoke_{W}x{H}_qp{QP}_ctb64_tiles"
                             f"{BANDS}x1_{BANDED_FRAMES}f.265")
# the banded phase's 4:0:0 stream: all-intra 4:0:0 pictures in three column
# tiles, deblocked, no SAO (the 4:0:0 pictures the banded decode takes:
# one with references, or with both deblocking and SAO, it refuses, as the
# JAX banded decode raises there)
MONO_FRAMES = 2
MONO = dict(wpp=False, tiles=(BANDS, 1), gop="all_intra", sao=False,
            chroma_format_idc=0)
MONO_STREAM = os.path.join(CACHE, f"smoke_{W}x{H}_qp{QP}_ctb64_tiles"
                           f"{BANDS}x1_400_intra_{MONO_FRAMES}f.265")
# the frame-axis phase's stream: ParallelBGopEncoder's GOP at the headline
# settings (RA, no WPP): I0, P5, then B1-B4, which read only the anchors
PGOP_B = 4
PGOP_STREAM = os.path.join(CACHE, f"smoke_{W}x{H}_qp{QP}_ctb64_pgop"
                           f"{PGOP_B}b.265")


def synth_pgop(path, n_b=PGOP_B):
    """PGOP_STREAM: the rolled gradient of ``synth_stream``, n_b + 2
    pictures in display order, through ``ParallelBGopEncoder``."""
    from hevc_tpu_torch.encoder.core import EncoderConfig
    from hevc_tpu_torch.encoder.generate import synth_frame
    from hevc_tpu_torch.encoder.pgop import ParallelBGopEncoder
    cfg = EncoderConfig(width=W, height=H, qp=QP, log2_ctb_size=6,
                        log2_cu_size=6, deblocking=True, sao=True, seed=1,
                        gop="ra", search_range=3)
    base = synth_frame("gradient", W, H, 0, seed=9)
    frames = [[np.roll(base[0], (t * 4, t * 7), (0, 1))]
              + [np.roll(c, (t * 2, t * 3), (0, 1)) for c in base[1:]]
              for t in range(n_b + 2)]
    data = ParallelBGopEncoder(cfg, n_b).encode(frames)
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return path


def stream_jobs():
    """{path: (function, arguments, keywords)} of every stream the smoke
    decodes at 1080p."""
    jobs = {STREAM: (synth_stream, (STREAM, W, H, QP, FRAMES), {})}
    for name, (extra, frames) in FORMATS.items():
        path = format_path(name)
        jobs[path] = (synth_stream, (path, W, H, QP, frames), extra)
    jobs[SHVC_STREAM] = (synth_shvc, (SHVC_STREAM,), {})
    jobs[BANDED_STREAM] = (synth_stream, (BANDED_STREAM, W, H, QP,
                                          BANDED_FRAMES), BANDED)
    jobs[MONO_STREAM] = (synth_stream, (MONO_STREAM, W, H, QP, MONO_FRAMES),
                         MONO)
    jobs[PGOP_STREAM] = (synth_pgop, (PGOP_STREAM,), {})
    return jobs


def start_streams(pool):
    """Encode every missing 1080p stream, each in a worker process of
    ``pool``: {path: (future or None, the time the encode started)}."""
    os.makedirs(CACHE, exist_ok=True)
    return {path: (None if os.path.exists(path) else pool.submit(
        fn, *args, **kw), time.perf_counter())
        for path, (fn, args, kw) in stream_jobs().items()}


def wait_streams(started):
    n = sum(fut is not None for fut, _t0 in started.values())
    for path, (fut, t0) in started.items():
        if fut is not None:
            fut.result()
            log(f"generated {os.path.relpath(path, ROOT)}: encoded in a "
                f"worker process, ready {time.perf_counter() - t0:.1f} s "
                f"after the encodes started (the {n} ran side by side)")


# ---------------------------------------------------------------------------
# random kernel cases (the parametrisation of tests/test_mc_pallas.py);
# generated here rather than imported from tests/, whose conftest imports
# JAX where it is installed
# ---------------------------------------------------------------------------

MC_CASES = [  # is_ch, bi, w, h, bd, wp
    (False, False, 16, 8, 8, False), (False, True, 8, 16, 8, False),
    (False, False, 4, 4, 10, False), (True, False, 8, 4, 8, False),
    (True, True, 4, 8, 10, False), (False, True, 32, 24, 8, False),
    (False, False, 16, 8, 8, True), (False, True, 8, 8, 8, True),
    (True, False, 8, 4, 10, True), (True, True, 4, 8, 8, True),
]


def random_mc_case(rng, is_ch, bi, w, h, bd, wp, n_blk=7):
    """(canvas, refs, rows [N, 17]) with non-overlapping blocks plus two
    padding rows (cy = cx = 30000) that must write nothing."""
    from hevc_tpu_torch.pack import PAD_REF
    rh, rw, ch, cw, nref = 96, 160, 160, 260, 2
    ntaps = 4 if is_ch else 8
    refs = rng.integers(0, (1 << bd) - 1, (nref, rh + 2 * PAD_REF,
                                           rw + 2 * PAD_REF)).astype(np.int32)
    cols = max(1, cw // (w + 8))
    rows = []
    for i in range(n_blk):
        row = np.zeros(17, np.int32)
        for p in range(2 if bi else 1):
            row[5 * p:5 * p + 5] = (
                rng.integers(0, nref),
                rng.integers(0, rh + 2 * PAD_REF - h - ntaps),
                rng.integers(0, rw + 2 * PAD_REF - w - ntaps),
                rng.integers(0, 4 if ntaps == 8 else 8),
                rng.integers(0, 4 if ntaps == 8 else 8))
        row[10] = 8 + (i // cols) * (h + 8)
        row[11] = 8 + (i % cols) * (w + 8)
        if wp:
            row[12:17] = (rng.integers(50, 80),
                          int(rng.integers(-8, 8)) << (bd - 8),
                          rng.integers(50, 80),
                          int(rng.integers(-8, 8)) << (bd - 8), 6 + 14 - bd)
        rows.append(row)
    for _ in range(2):
        pad = np.zeros(17, np.int32)
        pad[10] = pad[11] = 30000
        rows.append(pad)
    canvas = rng.integers(0, 1 << bd, (ch, cw)).astype(np.int32)
    return canvas, refs, np.stack(rows)


def random_resid_case(rng, cls, bd, n_blk=6):
    s = 4 << cls
    ch, cw = 160, 220
    pool = rng.integers(-200, 200, (n_blk + 2, s, s)).astype(np.int32)
    pool[0] = 0
    canvas = rng.integers(0, (1 << bd) - 1, (ch, cw)).astype(np.int32)
    cols = max(1, cw // (s + 8))
    rows = [(8 + (i // cols) * (s + 8), 8 + (i % cols) * (s + 8),
             int(rng.integers(0, n_blk + 2))) for i in range(n_blk)]
    rows.append((-(1 << 20), -(1 << 20), 0))  # padding row
    return canvas, pool, np.asarray(rows, np.int32)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def mixed_mc_case(rng, bd=8):
    """(canvas, refs, groups): two rows of every 8-bit MC flavour, each
    flavour in its own band of rows, one at the canvas's right edge, plus
    a padding row each: one picture's mixed groups for one launch."""
    from hevc_tpu_torch.pack import PAD_REF
    rh, rw, ch, cw, nref = 96, 160, 300, 260, 2
    refs = rng.integers(0, (1 << bd) - 1, (nref, rh + 2 * PAD_REF,
                                           rw + 2 * PAD_REF)).astype(np.int32)
    groups = []
    for k, (is_ch, bi, w, h, _bd, wp) in enumerate(
            c for c in MC_CASES if c[4] == bd):
        _c, _r, rows = random_mc_case(rng, is_ch, bi, w, h, bd, wp, n_blk=2)
        rows = rows[:3]                   # two blocks and one padding row
        rows[0, 10:12] = (8 + 36 * k, 8)
        rows[1, 10:12] = (8 + 36 * k, cw - w + 2)
        groups.append((is_ch, bi, wp, 3, w, h, rows))
    canvas = rng.integers(0, 1 << bd, (ch, cw)).astype(np.int32)
    return canvas, refs, groups


def phase_random_kernels(dev):
    import torch
    from hevc_tpu_torch import build, mc_cuda
    from hevc_tpu_torch.mc import mc_plain, resid_add_plain
    from hevc_tpu_torch.tables import tables_from_reference
    tabs = tables_from_reference(dev)
    rng = np.random.default_rng(7)
    for is_ch, bi, w, h, bd, wp in MC_CASES:
        canvas, refs, rows = random_mc_case(rng, is_ch, bi, w, h, bd, wp)
        c = torch.from_numpy(canvas).to(dev)
        r = torch.from_numpy(refs).to(dev)
        groups = [(is_ch, bi, wp, 3, w, h, torch.from_numpy(rows).to(dev))]
        got = mc_cuda.mc(c.clone(), r, r, groups, bd)
        want = mc_plain(c.clone(), r, r, groups, bd, tabs)
        err = int((got - want).abs().max())
        assert err == 0, f"mc_kernel != plain on {is_ch, bi, w, h, bd, wp}"
        assert torch.equal(got[-60:], c[-60:]), "padding rows wrote pixels"
    canvas, refs, groups = mixed_mc_case(rng)
    c = torch.from_numpy(canvas).to(dev)
    r = torch.from_numpy(refs).to(dev)
    tgroups = [g[:6] + (torch.from_numpy(g[6]).to(dev),) for g in groups]
    before = build.launches["mc"]
    got = mc_cuda.mc(c.clone(), r, r, tgroups, 8)
    assert build.launches["mc"] == before + 1, "mixed groups: one launch"
    want = mc_plain(c.clone(), r, r, tgroups, 8, tabs)
    assert torch.equal(got, want), "mc_kernel != plain on mixed groups"
    for bd in (8, 10):
        cases = [random_resid_case(rng, cls, bd) for cls in range(4)]
        for cls in range(5):      # each class alone, then all four at once
            c = torch.from_numpy(cases[0][0]).to(dev)
            pools = [torch.zeros((1, 4 << k, 4 << k), dtype=torch.int32,
                                 device=dev) for k in range(4)]
            fields = [torch.zeros((0, 3), dtype=torch.int32, device=dev)
                      for _ in range(4)]
            for k in (range(4) if cls == 4 else (cls,)):
                pools[k] = torch.from_numpy(cases[k][1]).to(dev)
                rows = cases[k][2].copy()
                if cls == 4:   # the classes in disjoint bands of rows
                    rows[:-1, 0] += (0, 16, 40, 72)[k]
                fields[k] = torch.from_numpy(rows).to(dev)
            before = build.launches["resid_add"]
            got = mc_cuda.resid_add(c.clone(), fields, pools, bd)
            assert build.launches["resid_add"] == before + 1
            want = resid_add_plain(c.clone(), fields, pools, bd)
            err = int((got - want).abs().max())
            assert err == 0, f"resid_add_kernel != plain on class {cls}"
    from hevc_tpu_torch import intra, intra_cuda
    from hevc_tpu_torch.intra_cases import random_case
    n_live = 0
    for seed in range(6):
        case = random_case(seed)
        counts = intra.chunk_counts(case[1])
        c, scal, avail, resids = (
            torch.from_numpy(case[0]).to(dev),
            *([torch.from_numpy(a).to(dev) for a in case[k]]
              for k in (1, 2, 3)))
        before = build.launches["intra"]
        got = intra_cuda.reconstruct_wavefront(c.clone(), scal, avail,
                                               resids, case[4], tabs, counts)
        live = intra_cuda.live_chunks(counts)
        assert build.launches["intra"] == before + live, "intra launches"
        want = intra.reconstruct_wavefront(c.clone(), scal, avail, resids,
                                           case[4], tabs, counts)
        err = int((got - want).abs().max())
        assert err == 0, f"intra_chunk_kernel != plain on random case {seed}"
        n_live += live
    INTRA_ERRORS.append(("random cases", 0))
    from hevc_tpu_torch import filter_cases
    n_lf = 0
    for name in sorted(filter_cases.CASES):
        for seed in (0, 1):
            case = filter_cases.make(name, seed)
            err, launches, kept = filter_cases.kernel_errors(case, dev)
            assert err == 0 and kept, \
                f"loop filter kernels != plain on {name}, seed {seed} " \
                f"(error {err}, samples outside the planes kept: {kept})"
            assert launches == 2 * case["deblock"] + case["sao"], launches
            n_lf += launches
    LOOP_FILTER_ERRORS.append(("random cases", 0))
    from hevc_tpu_torch import resid_cases
    from hevc_tpu_torch.capture import residual_errors
    for name in sorted(resid_cases.CASES):
        for seed in (0, 1):
            err, launches = residual_errors(resid_cases.tensors(
                resid_cases.make(name, seed), dev)[:4])
            assert (err, launches) == (0, 1), \
                f"resid_tx_kernel != plain on {name}, seed {seed} (error " \
                f"{err}, {launches} launches)"
    RESID_ERRORS.append(("random cases", 0))
    torch.cuda.synchronize()
    log(f"random kernel cases: {len(MC_CASES)} MC flavours, their mixed "
        "groups in one launch, and 4 residual classes alone and together "
        "at 8 and 10 bit, bit-exact; the intra kernel on 6 random cases "
        "(every mode of every size, filters on and off, 8 and 10 bit, "
        f"partial availability, padding, empty chunks), {n_live} launches, "
        "bit-exact; the loop filter kernels on "
        f"{2 * len(filter_cases.CASES)} random pictures (4:0:0 to 4:4:4, 8 "
        "to 16 bit, per-slice maps and SAO edge flags, nf maps, deblocking "
        f"or SAO alone, sizes off the 8-grid and the CTB), {n_lf} launches, "
        "bit-exact, every sample outside the planes kept; the residual "
        f"kernel on {2 * len(resid_cases.CASES)} random pictures' pools (8 "
        "to 16 bit, skip, bypass, matrices, int16 limits, rotation, RDPCM, "
        "CCP, empty classes), one launch each, bit-exact")


def intra_records(args):
    """The live records of one captured intra wavefront call."""
    return sum(int(c.sum()) for c in args[5])


def intra_place(label, args, smi):
    """The intra kernel against its plain version on one captured
    picture's (or band's) wrapper inputs (``Capture.intra``: canvas, scal,
    avail, resids, bd, counts), bit for bit (tolerance 0); the kernel's ms
    a call (CUDA events over its launches, in place on a copy; traced by
    ``torch.profiler`` at the end), the plain version's ms (CUDA events
    around the one call compared), its launches a call and the bound: the
    larger of the bytes (``bounds.intra_work``) over 3.35 TB/s and the
    chain, the live chunks times the queued launch floor (FLOOR).  Returns
    (error, ms, plain ms, bound)."""
    import torch
    from hevc_tpu_torch import intra, intra_cuda
    from hevc_tpu_torch.tables import tables_from_reference
    canvas, scal, avail, resids, bd, counts = args
    tabs = tables_from_reference(canvas.device)
    got = intra_cuda.reconstruct_wavefront(canvas.clone(), scal, avail,
                                           resids, bd, tabs, counts)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    want = intra.reconstruct_wavefront(canvas.clone(), scal, avail, resids,
                                       bd, tabs, counts)
    e1.record()
    e1.synchronize()
    plain_ms = e0.elapsed_time(e1)
    err = int((got - want).abs().max())
    assert err == 0, f"intra_chunk_kernel != plain on {label} ({err})"
    INTRA_ERRORS.append((label, err))
    work = canvas.clone()

    def launch():
        intra_cuda.reconstruct_wavefront(work, scal, avail, resids, bd, tabs,
                                         counts)

    ms = cuda_ms(launch, iters=10, warmup=2)
    PROFILE.append((f"intra_chunk_kernel {label}", launch))
    n_bytes, chunks = intra_work([x.cpu().numpy() for x in scal], counts,
                                 resids)
    chain = chunks * FLOOR[0][0]
    bound = bound_ms(n_bytes, 0, chain)
    log(f"intra {label}: {intra_records(args)} records in {chunks} live "
        f"chunks (launches a call), {bd}-bit, canvas "
        f"{tuple(canvas.shape)}; kernel == plain (error 0); kernel {ms} ms "
        f"a call by CUDA events ({ms / chunks * 1e3} us a launch), plain "
        f"{plain_ms} ms ({plain_ms / ms:.1f}x); bound {bound[0]} ms "
        f"({bound[1]}: bytes {n_bytes} B = {n_bytes / HBM_BYTES_S * 1e3} "
        f"ms, chain {chunks} x {FLOOR[0][0]} ms = {chain} ms; kernel at "
        f"{bound[0] / ms:.3f} of it) ({smi})")
    return err, ms, plain_ms, bound


def best_intra(calls):
    """The captured intra call with the most live records."""
    return max(calls, key=intra_records)


def phase_real_kernels(cap, dev, smi):
    """Kernel vs plain on the largest captured 1080p row sets and on the
    I picture's intra records; times and bounds."""
    import torch
    from hevc_tpu_torch import mc_cuda
    from hevc_tpu_torch.mc import mc_plain, resid_add_plain
    from hevc_tpu_torch.tables import tables_from_reference
    assert cap.mc and cap.resid, "the captured decode ran no inter frame"
    canvas, refs_l, refs_c, groups, bd = max(
        cap.mc, key=lambda a: sum(g[6].shape[0] for g in a[3]))
    table = mc_cuda.mc_table(groups, canvas.shape)
    n_mc = table.rows.shape[0]
    rows = torch.from_numpy(table.rows).to(dev)
    tg = mc_cuda.table_groups(table, rows.int())
    tabs = tables_from_reference(dev)
    got = mc_cuda.mc(canvas.clone(), refs_l, refs_c, groups, bd)
    want = mc_plain(canvas.clone(), refs_l, refs_c, tg, bd, tabs)
    mc_err = int((got - want).abs().max())
    assert mc_err == 0, "mc_kernel != plain on the 1080p P frame"
    work = canvas.clone()
    params = mc_cuda.mc_params(work, refs_l, refs_c, table, bd)

    def launch_mc():
        mc_cuda.launch_mc(work, refs_l, refs_c, rows, params)

    mc_ms = cuda_ms(launch_mc)
    PROFILE.append(("mc_kernel", launch_mc))
    mc_call_ms = cuda_ms(lambda: mc_cuda.mc(work, refs_l, refs_c, groups, bd))
    mc_plain_ms = cuda_ms(lambda: mc_plain(work, refs_l, refs_c, tg, bd,
                                           tabs), iters=5, warmup=1)

    canvas, fields, pools, bd = max(
        cap.resid, key=lambda a: sum(f.shape[0] for f in a[1]))
    n_tu = [int(f.shape[0]) for f in fields]
    got = mc_cuda.resid_add(canvas.clone(), fields, pools, bd)
    want = resid_add_plain(canvas.clone(), fields, pools, bd)
    ra_err = int((got - want).abs().max())
    assert ra_err == 0, "resid_add_kernel != plain on the 1080p P frame"
    work = canvas.clone()
    rparams = mc_cuda.resid_params(work, fields, pools, bd)

    def launch_ra():
        mc_cuda.launch_resid_add(work, rparams)

    ra_ms = cuda_ms(launch_ra)
    PROFILE.append(("resid_add_kernel", launch_ra))
    ra_call_ms = cuda_ms(lambda: mc_cuda.resid_add(work, fields, pools, bd))
    ra_plain_ms = cuda_ms(lambda: resid_add_plain(work, fields, pools, bd),
                          iters=5, warmup=1)
    log(f"1080p P frame: {n_mc} MC rows in {len(table.groups)} block "
        f"classes ({params.unit_start[params.ngroups]} work units), inter "
        f"TUs per class {n_tu}; kernels bit-exact")
    mc_b, mc_ops = mc_work(refs_l, refs_c, table)
    ra_b, ra_ops = resid_work(fields, pools)
    log(f"work: mc {mc_b} B, {mc_ops} int32 ops ({mc_b / mc_ms / 1e6} GB/s);"
        f" resid_add {ra_b} B, {ra_ops} ops ({ra_b / ra_ms / 1e6} GB/s)")
    log(f"ms per call (CUDA events): mc launch {mc_ms}, mc wrapper "
        f"{mc_call_ms} (table, upload, launch), plain {mc_plain_ms}; "
        f"resid_add launch {ra_ms}, wrapper "
        f"{ra_call_ms}, plain {ra_plain_ms}")
    intra = intra_place("main stream I picture", best_intra(cap.intra), smi)
    return {"mc": (mc_err, mc_ms, mc_plain_ms, bound_ms(mc_b, mc_ops)),
            "resid_add": (ra_err, ra_ms, ra_plain_ms,
                          bound_ms(ra_b, ra_ops)),
            "intra": intra}


def phase_loop_filter(dev, smi):
    """The loop filter kernels on pictures of the benchmark's banks: the
    first access units of each bank's first segment decoded with the
    wrappers' inputs captured (``capture.captured_filters``), then on the
    pictures of ``filter_cases.BANK_PICTURES`` (an IDR, a P and a leaf B of
    ``main1080/ra`` and of the 10-bit 3840x2160 ``main10_2160/ra``, the
    IDR of ``main1080/intra``), bit for bit
    against the plain versions on the card (tolerance 0); per picture the
    three launches' ms by CUDA events, each call deblocking a fresh copy of
    the captured planes (deblocking writes in place), less the copies' own
    ms; the plain versions' ms, the wrappers' host us a picture
    (``probes.host_us``, less the copies') and the bound
    (``bounds.loop_filter_work`` over 3.35 TB/s); the launches are traced
    at the end.  Returns the RA P picture's (error, ms, plain ms, bound)
    for the kernel table."""
    import torch
    from hevc_tpu_torch import filter_cases, filters_cuda, probes
    from hevc_tpu_torch.capture import (bank_prefix, captured_filters,
                                        loop_filter_errors, pick_picture)
    data = os.path.dirname(BANKS)
    rows = {}
    for bank, (n_aus, kinds, shape) in filter_cases.BANK_PICTURES.items():
        calls = captured_filters(
            bank_prefix(os.path.join(data, bank), n_aus), dev)
        for kind in kinds:
            call = pick_picture(calls, kind)
            label = f"{bank} {kind} POC {call['at'][1]}"
            errs = loop_filter_errors(call)
            err = max(errs.values())
            assert errs == {"deblock_planes": 0, "sao_planes": 0}, \
                f"loop filter kernels != plain on {label}: {errs}"
            LOOP_FILTER_ERRORS.append((label, err))
            (dplanes, *da), dk = call["deblock_planes"]
            (splanes, *sa), sk = call["sao_planes"]
            assert tuple(dplanes[0].shape) == shape, (label, dplanes[0].shape)
            work = [p.clone() for p in dplanes]

            def fresh(work=work, dplanes=dplanes):
                for w, p in zip(work, dplanes):
                    w.copy_(p)

            def kernels(work=work, da=da, dk=dk, splanes=splanes, sa=sa,
                        sk=sk, fresh=fresh):
                fresh()
                filters_cuda.deblock_planes(work, *da, **dk)
                filters_cuda.sao_planes(splanes, *sa, **sk)

            def plain(dplanes=dplanes, da=da, dk=dk, splanes=splanes, sa=sa,
                      sk=sk):
                filters_cuda.deblock_plain(dplanes, *da, **dk)
                filters_cuda.sao_plain(splanes, *sa, **sk)

            ms = cuda_ms(kernels, iters=20, warmup=3) \
                - cuda_ms(fresh, iters=20, warmup=3)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            host = probes.host_us(kernels, calls=200) \
                - probes.host_us(fresh, calls=200)
            PROFILE_LOOP_FILTER.append((label, kernels))
            qp4, sao_t, nf4 = da[0], sa[0], da[10]
            n_bytes = sum(loop_filter_work(
                [tuple(p.shape) for p in dplanes], *qp4.shape,
                *sao_t.shape[1:], True, True, da[3].dim() == 2,
                nf4 is not None).values())
            bound = bound_ms(n_bytes, 0)
            rows[label] = (err, ms, plain_ms, bound)
            log(f"loop filter, {label} ({shape[1]}x{shape[0]} "
                f"{len(dplanes)} planes of {dplanes[0].dtype}): "
                f"kernels == plain (error 0); 3 launches {ms} ms by CUDA "
                f"events, plain {plain_ms} ms ({plain_ms / ms:.0f}x), "
                f"wrappers' host {host} us a picture; bound {bound[0]} ms "
                f"({bound[1]}, {n_bytes} B; kernels at {bound[0] / ms:.3f} "
                f"of it) ({smi})")
    return next(v for k, v in rows.items() if k.startswith("main1080/ra P"))


def phase_bank_kernels(dev, smi):
    """MC, the residual add and the intra kernel on the 10-bit 3840x2160
    bank (``main10_2160/ra``): its first five access units (an IDR, a P and
    three B) decoded with every MD5 checked, the pack inline and each
    wrapper's inputs captured; every inter picture's MC and residual add
    and the intra records of the IDR and of the inter picture with the
    most, bit for bit against the plain versions on the card (tolerance
    0).  Returns each kernel's largest error, for the kernel table."""
    from hevc_tpu_torch import decoder
    from hevc_tpu_torch.capture import bank_prefix
    bank = "main10_2160/ra"
    data = bank_prefix(os.path.join(os.path.dirname(BANKS), bank), 5)
    cap = Capture()
    os.environ["HEVC_TPU_ASYNC_PACK"] = "0"
    try:
        with cap.installed():
            frames = decoder.TorchDecoder(check_md5=True,
                                          device=dev).decode_bytes(data)
    finally:
        os.environ.pop("HEVC_TPU_ASYNC_PACK")
    assert len(frames) == 5 and all(f.md5_ok is True for f in frames), \
        f"{bank}: MD5 {[f.md5_ok for f in frames]}"
    assert cap.mc and cap.resid and {a[4] for a in cap.mc} == {10}, bank
    errs = {}
    for name, fn, calls, ats in (("mc", mc_error, cap.mc, cap.mc_at),
                                 ("resid_add", resid_add_error, cap.resid,
                                  cap.resid_at)):
        per = {at[1]: fn(args) for args, at in zip(calls, ats)}
        assert not any(per.values()), \
            f"{bank}: {name} kernel != plain, error by POC {per}"
        errs[name] = max(per.values())
    assert cap.intra_at[0] not in cap.mc_at, f"{bank}: no IDR first"
    intra_place(f"{bank} I POC {cap.intra_at[0][1]}", cap.intra[0], smi)
    inter = [i for i, at in enumerate(cap.intra_at)
             if at in cap.mc_at and intra_records(cap.intra[i])]
    if inter:
        k = max(inter, key=lambda i: intra_records(cap.intra[i]))
        intra_place(f"{bank} inter POC {cap.intra_at[k][1]}", cap.intra[k],
                    smi)
    log(f"{bank}: 5 pictures 3840x2160 10-bit, every MD5 correct; "
        f"mc_kernel == plain on {len(cap.mc)} pictures, resid_add_kernel "
        f"on {len(cap.resid)}, the intra kernel on "
        f"{1 + bool(inter)} (error 0) ({smi})")
    return errs


def phase_residuals(dev, smi):
    """The residual kernel on pictures of the benchmark's banks: the first
    access units of each bank's first segment decoded with the stage's
    inputs captured (``capture.captured_residuals``), then on the pictures
    of ``resid_cases.BANK_PICTURES`` (an IDR, a P and a leaf B of
    ``main1080/ra`` and of the 10-bit 3840x2160 ``main10_2160/ra``, the
    IDR of ``intra``, the base layer's IDR and an enhancement-layer P of
    ``shvc1080_x1.5/ldp``), bit for bit
    against the plain version on the card (tolerance 0, one launch); per
    picture the launch's ms by CUDA events, the plain version's ms, the
    wrapper's host us (``probes.host_us``) and the bound
    (``bounds.residual_work``); the launches are traced at the end.
    Returns the RA P picture's (error, ms, plain ms, bound) for the kernel
    table."""
    from hevc_tpu_torch import probes, resid_cases, resid_cuda
    from hevc_tpu_torch.capture import (bank_prefix, captured_residuals,
                                        pick_picture, residual_errors)
    from hevc_tpu_torch.tables import tables_from_reference
    data = os.path.dirname(BANKS)
    tables = tables_from_reference(dev)
    rows = {}
    for bank, (n_aus, picks) in resid_cases.BANK_PICTURES.items():
        calls = captured_residuals(
            bank_prefix(os.path.join(data, bank), n_aus), dev)
        for kind, layer in picks:
            call = pick_picture([c for c in calls if c["at"][0] == layer],
                                kind)
            label = f"{bank} {kind} {call['at']}"
            err, launches = residual_errors(call["args"])
            assert (err, launches) == (0, 1), \
                f"resid_tx_kernel != plain on {label}: error {err}, " \
                f"{launches} launches"
            RESID_ERRORS.append((label, err))
            levels, rmeta, bd, bank_m = call["args"]

            def kernel(a=(levels, rmeta, bd, bank_m, tables)):
                resid_cuda.residuals(*a)

            def plain(a=(levels, rmeta, bd, bank_m, tables)):
                resid_cuda.residuals_plain(*a)

            ms = cuda_ms(kernel, iters=20, warmup=3)
            plain_ms = cuda_ms(plain, iters=3, warmup=1)
            host = probes.host_us(kernel, calls=200)
            PROFILE_RESID.append((label, kernel))
            n_bytes, n_ops = residual_work([m.cpu().numpy() for m in rmeta])
            bound = bound_ms(n_bytes, n_ops)
            rows[label] = (err, ms, plain_ms, bound)
            log(f"residual kernel, {label} ({sum(m.shape[0] for m in rmeta)}"
                f" records): kernel == plain (error 0); one launch {ms} ms "
                f"by CUDA events, plain {plain_ms} ms "
                f"({plain_ms / ms:.0f}x), the wrapper's host {host} us a "
                f"picture; bound {bound[0]} ms ({bound[1]}, {n_bytes} B, "
                f"{n_ops} int32 operations; kernel at {bound[0] / ms:.3f} "
                f"of it) ({smi})")
    return next(v for k, v in rows.items() if k.startswith("main1080/ra P"))


def phase_stage_b(dev, smi):
    """The main stream through ``capture.stage_timings`` (no new encode):
    its last P picture's frame program replayed 16 times, every replay
    equal to the decode, then each stage alone on that picture's inputs
    (16 calls between CUDA events) beside its bound, both inter kernels
    against their plain versions.  The replays' device-busy time and idle
    share are traced at the end (``PROFILE_REPLAYS``)."""
    iters = 16
    rep, out = stage_timings(STREAM, dev, iters, "smoke")
    assert out["kernel_max_abs_err"] == {"mc": 0, "resid_add": 0}, out
    PROFILE_REPLAYS.append((rep, iters))
    log(f"stage-B replay, main stream's last P picture: {rep.count} replays "
        f"of its frame program equal to the decode, "
        f"{out['stageB_replay_fps_smoke']} replays a second (card "
        f"synchronised); kernels == plain versions (error 0) ({smi})")
    for k, us in out["kernel_us"].items():
        log(f"stage-B replay, stage {k}: {us} us by CUDA events, bound "
            f"{out['kernel_bound_us'][k]} us ({out['kernel_bound_by'][k]}, "
            f"{out['kernel_bytes'][k]} B), {out['kernel_gbps'][k]} GB/s "
            f"({smi})")
    log(f"stage-B replay, elementwise roofline (p + 1 over the luma plane): "
        f"{out['kernel_gbps']['roofline_elementwise']} GB/s ({smi})")


def captured_kernel_errors(cap, layer=None):
    """(mc_err, resid_add_err, (layer, POC)): each kernel against its plain
    version on the captured inputs of the P picture (of ``layer``, if
    given) with the most MC rows."""
    k = max((i for i, at in enumerate(cap.mc_at)
             if layer is None or at[0] == layer),
            key=lambda i: sum(g[6].shape[0] for g in cap.mc[i][3]))
    # the same picture's residual inputs
    at = cap.mc_at[k]
    return kernel_errors(cap.mc[k], cap.resid[cap.resid_at.index(at)]) \
        + (at,)


def counted_decode(decode, dev, pipeline, trace, build):
    """``decode()`` once, counted: launch counts, the trace and the count of
    references resolved from the host from 0 just before, read just after.
    For each picture through the frame program it records its layer, where
    its output and DPB entries lie, whether it is inter, its planes, PCM
    records and slices, whether its stage A ran in the Python syntax layer
    and how many (idx, val) pairs its level pool shipped as (0: dense);
    every output and DPB entry must be on ``dev``, and every reference
    must come from the device DPB; the intra kernel must launch once per
    live chunk of the pictures' packs (``live``), the loop filter
    kernels twice for each pack whose spec deblocks (``deblock``) and once
    for each that applies SAO (``sao``), and the residual kernel once a
    picture (``resid_tx``, and the trace's ``residual_launches``).  Returns (decode's result, seen,
    counts, split, wall seconds)."""
    from hevc_tpu_torch import intra, intra_cuda
    from hevc_tpu_torch import native as N
    seen, coo, live = [], [], []
    filtered = {"deblock": 0, "sao": 0}
    orig_finish, orig_pack = pipeline.finish_frame, pipeline.pack_frame

    def pack(pic):
        out = orig_pack(pic)
        spec = dict(out[6])
        coo.append(spec["coo"][0])
        filtered["deblock"] += 2 * bool(spec["do_deblock"])
        filtered["sao"] += bool(spec["do_sao"])
        scal = pipeline.host_views(np.asarray(out[0], np.int32), out[1],
                                   dict(out[6]))[0]
        live.append(intra_cuda.live_chunks(intra.chunk_counts(scal)))
        return out

    def finish(pic, lay, poc, device):
        out = orig_finish(pic, lay, poc, device)
        seen.append(dict(
            coo=coo[-1], live=live[-1],
            layer=lay.layer_id,
            devices={out[0].device.type} | {
                t.device.type for t in lay.dpb_dev[poc]},
            inter=bool(getattr(pic, "ref_list_l0", None)
                       or getattr(pic, "ref_list_l1", None)),
            planes=len(out[1]),
            pcm=sum(int((rec[:, N.REC_KIND] == N.KIND_PCM).sum())
                    for rec, _lvl in pic.native_chunks),
            slices=len(pic.slice_params or ()), from_plan=bool(pic.plan)))
        return out

    pipeline.finish_frame, pipeline.pack_frame = finish, pack
    trace.reset()
    build.reset_launches()
    pipeline.host_refs["count"] = 0
    t0 = time.perf_counter()
    try:
        result = decode()
    finally:
        pipeline.finish_frame, pipeline.pack_frame = orig_finish, orig_pack
    wall = time.perf_counter() - t0
    counts = {k: build.launches[k]
              for k in ("mc", "resid_add", "intra", "deblock", "sao",
                        "resid_tx")}
    split = trace.report()
    assert all(s["devices"] == {dev.type} for s in seen), \
        f"outputs or DPB entries not on the card: {seen}"
    assert pipeline.host_refs["count"] == 0, \
        f"{pipeline.host_refs['count']} references resolved from the host"
    assert counts["intra"] == sum(s["live"] for s in seen) > 0, \
        f"intra launches {counts['intra']} for the live chunks " \
        f"{[s['live'] for s in seen]}"
    assert {k: counts[k] for k in filtered} == filtered \
        and filtered["sao"] > 0, \
        f"loop filter launches {counts} for the packs' filters {filtered}"
    assert counts["resid_tx"] == len(seen) \
        == split["residual_launches"]["total"], \
        f"residual launches {counts['resid_tx']} for {len(seen)} pictures"
    return result, seen, counts, split, wall


def phase_format(name, dev, smi, decoder, pipeline, trace, build):
    """One stream of FORMATS on the card, twice through ``TorchDecoder``:
    first with the kernels' inputs captured and each stage timed with the
    card synchronised around it (also the warm-up), then counted: launch
    counts from 0 just before, read just after, every MD5 checked, every
    output and device DPB entry on the card.  Returns the counted run's
    pictures (``counted_decode``'s ``seen``)."""
    import torch
    data = open(format_path(name), "rb").read()
    n_frames = FORMATS[name][1]
    cap = Capture()
    os.environ["HEVC_TPU_ASYNC_PACK"] = "0"
    try:
        with cap.installed():
            frames = decoder.TorchDecoder(check_md5=True,
                                          device=dev).decode_bytes(data)
            assert [f.md5_ok for f in frames] == [True] * n_frames, \
                f"{name}: MD5 of the captured run"
    finally:
        os.environ.pop("HEVC_TPU_ASYNC_PACK")

    def decode():
        frames = decoder.TorchDecoder(check_md5=True,
                                      device=dev).decode_bytes(data)
        return [f.md5_ok for f in frames]

    md5, seen, counts, split, wall = counted_decode(
        decode, dev, pipeline, trace, build)
    n_inter = sum(s["inter"] for s in seen)
    assert md5 == [True] * n_frames, f"{name}: MD5 {md5}"
    assert len(seen) == n_frames and n_inter == n_frames - 1, seen
    assert counts["mc"] == n_inter and counts["resid_add"] > 0, \
        f"{name}: launches {counts} for {n_inter} P pictures"
    fmt = name[0]
    if fmt == "A":
        assert seen[0]["pcm"] > 0 and all(s["slices"] == 4 for s in seen)
    if fmt == "B":
        assert all(s["from_plan"] for s in seen), "B: native records?"
    if fmt == "C":
        assert all(s["planes"] == 1 for s in seen)
    mc_err, ra_err, _at = captured_kernel_errors(cap)
    assert mc_err == 0 and ra_err == 0, \
        f"{name}: kernels != plain ({mc_err}, {ra_err})"
    intra_place(f"format {name[0]} I picture", best_intra(cap.intra), smi)
    torch.cuda.synchronize()
    log(f"format {name}: {n_frames} frames, every MD5 correct, outputs and "
        f"DPB on the card, launches {counts} for {n_inter} P pictures, "
        f"PCM records per picture {[s['pcm'] for s in seen]}, slices "
        f"{[s['slices'] for s in seen]}, Python stage A "
        f"{[s['from_plan'] for s in seen]}; mc_kernel and resid_add_kernel "
        f"== plain on the captured P picture (error {mc_err}, {ra_err})")
    log(f"format {name}: {n_frames / wall} fps (TorchDecoder.decode_bytes "
        f"and the MD5 fetch, {wall:.3f} s) ({smi}); trace split, "
        "ms/frame: " + ", ".join(f"{k} {v['total_s'] * 1e3 / n_frames}"
                                 for k, v in sorted(split.items())
                                 if "total_s" in v))
    log(f"format {name}, captured run, stages synchronised, ms per call: "
        f"{cap.report()} ({smi})")
    return seen


def phase_coo(dev, smi, pipeline, sparse):
    """The sparse (COO) level upload on the main path.  sparse: {stream
    path: the (idx, val) pairs of each picture's level pool on its counted
    decode, 0 where it shipped dense}.  Prints how many pictures shipped
    sparse; then, on the first such picture (its ``frame_program`` inputs
    captured on one more decode of its stream), holds the frame program on
    the pairs against the frame program on the dense pool rebuilt on the
    host (spec ``coo`` (0, total)), bit for bit, and times the dense
    upload, the host's pair build (``pack.coo_pairs``: ``np.nonzero`` and
    the pairs), the pairs' upload and the device scatter
    (``pipeline.scatter_levels``)."""
    import torch
    from hevc_tpu_torch import decoder
    from hevc_tpu_torch.pack import coo_pairs
    n = sum(bool(c) for cs in sparse.values() for c in cs)
    total_pics = sum(len(cs) for cs in sparse.values())
    log(f"COO: {n} of the {total_pics} pictures of the 1080p main and "
        f"formats streams shipped their level pools as (idx, val) pairs: "
        + "; ".join(f"{os.path.basename(p)} {cs}" for p, cs in sparse.items()))
    path = next((p for p, cs in sparse.items() if any(cs)), None)
    assert path is not None, "COO: no picture of the 1080p streams is sparse"
    got, calls = [], []
    orig = pipeline.frame_program

    def program(*args):
        out = orig(*args)
        calls.append(1)
        if dict(args[10])["coo"][0] and not got:
            refs = tuple([r.clone() for r in args[i]] for i in (7, 8, 9))
            got.append((len(calls) - 1, args[:7] + refs + args[10:],
                        [o.clone() for o in out]))
        return out

    pipeline.frame_program = program
    try:
        frames = decoder.TorchDecoder(check_md5=True, device=dev) \
            .decode_bytes(open(path, "rb").read())
    finally:
        pipeline.frame_program = orig
    assert all(f.md5_ok is True for f in frames), "COO: MD5"
    k, args, out = got[0]
    idx, val = args[4]
    spec = dict(args[10])
    coo_n, total = spec["coo"]
    pool = np.zeros(total, np.int16)
    keep = idx < total
    np.put(pool, idx[keep], val[keep])
    dense_spec = tuple((k, (0, total) if k == "coo" else v)
                       for k, v in args[10])
    dense = orig(*args[:4], pool, *args[5:10], dense_spec, dev)
    same = [torch.equal(a, b) for a, b in zip(out, dense)]
    assert all(same), f"COO: frame program on the pairs != dense: {same}"
    again = coo_pairs(pool)
    assert np.array_equal(again[0], idx) and np.array_equal(again[1], val)
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        coo_pairs(pool)
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    dense_ms = cuda_ms(lambda: torch.from_numpy(pool).to(dev))
    pair_ms = cuda_ms(lambda: (torch.from_numpy(idx).to(dev),
                               torch.from_numpy(val).to(dev)))
    idx_d = torch.from_numpy(idx).to(dev)
    val_d = torch.from_numpy(val).to(dev)
    scat = pipeline.scatter_levels(idx_d, val_d, total)
    assert torch.equal(scat.cpu(), torch.from_numpy(pool)), "COO: scatter"
    scatter_ms = cuda_ms(lambda: pipeline.scatter_levels(idx_d, val_d, total))
    log(f"COO: {os.path.basename(path)}, picture {k} in decode order "
        f"({'P' if spec['n_refs'] else 'I'}): {coo_n} pairs "
        f"({int(keep.sum())} nonzero) for a pool of {total} levels; "
        f"frame program on the pairs == on the dense pool (every output, "
        f"bit for bit); bytes up {6 * coo_n} against {2 * total} (factor "
        f"{2 * total / (6 * coo_n)}) ({smi})")
    log(f"COO times: dense upload {dense_ms} ms (CUDA events, pageable); "
        f"pairs: host np.nonzero + pair build {host_ms} ms (perf counter), "
        f"upload {pair_ms} ms, device scatter {scatter_ms} ms (CUDA events); "
        f"COO total on the card {pair_ms + scatter_ms} ms against "
        f"{dense_ms} ms dense ({smi})")


# tests/test_cgs.py DELTAS1: the colour-mapping LUT the SHVC phase times
CGS_DELTAS = {(0, 0, 0, 0): (-3, 0, 1), (0, 0, 0, 3): (2, -1, 0),
              (0, 1, 0, 1): (4, 2, -2), (1, 0, 1, 2): (-2, 3, 1),
              (1, 1, 1, 3): (1, 1, 1)}


def phase_shvc(dev, smi, cli, decoder, pipeline, trace, build):
    """SHVC_STREAM on the card: a captured ``TorchDecoder`` run (every MD5
    of both layers; kernel and upsampler inputs; stages and the inter-layer
    build timed with the card synchronised), a counted ``cli.main -l 1``
    run (every EL MD5, every picture of both layers through the frame
    program, ``mc`` once per P picture, no reference from the host), both
    inter kernels against their plain versions on a captured EL picture,
    the upsampler and the CGS colour mapping on the card against the CPU,
    and each layer's fps without the fetch (``LazyPlanes.device_ready``).
    """
    import torch
    from hevc_tpu_torch import upsample as UP
    from hevc_tpu_torch.bitstream.bits import BitWriter
    from hevc_tpu_torch.ops.cgs import CgsLut, write_cgs_lut
    data = open(SHVC_STREAM, "rb").read()
    n = SHVC_AUS
    cap = Capture()
    os.environ["HEVC_TPU_ASYNC_PACK"] = "0"
    try:
        with cap.installed():
            frames = decoder.TorchDecoder(check_md5=True,
                                          device=dev).decode_bytes(data)
            md5 = {(f.layer, f.poc): f.md5_ok for f in frames}
    finally:
        os.environ.pop("HEVC_TPU_ASYNC_PACK")
    assert len(frames) == 2 * n and md5 == {
        (lay, poc): True for lay in (0, 1) for poc in range(n)}, \
        f"SHVC: MD5 of the captured run {md5}"
    assert len(cap.upsample) == n and not cap.ms["il_color_map"]

    buf = io.StringIO()

    def decode():
        with contextlib.redirect_stdout(buf):
            return cli.main(["-i", SHVC_STREAM, "-l", "1", "-v", "40",
                             "--device", "cuda"])

    rc, seen, counts, split, wall = counted_decode(
        decode, dev, pipeline, trace, build)
    out = buf.getvalue()
    n_inter = sum(s["inter"] for s in seen)
    assert rc == 0 and out.count("Correct MD5") == n, out
    assert [s["layer"] for s in seen] == [0, 1] * n, seen
    assert n_inter == 2 * n - 1 and not seen[0]["inter"], seen
    assert counts["mc"] == n_inter and 0 < counts["resid_add"] <= n_inter, \
        f"SHVC: launches {counts} for {n_inter} P pictures"

    mc_err, ra_err, at = captured_kernel_errors(cap, layer=1)
    assert mc_err == 0 and ra_err == 0, \
        f"SHVC: kernels != plain on EL picture {at} ({mc_err}, {ra_err})"
    # the EL picture with the most intra records; where the EL pictures
    # hold none (each predicted from the inter-layer reference), the BL's I
    # picture
    n_el = [intra_records(a) for a, at in zip(cap.intra, cap.intra_at)
            if at[0] == 1]
    k = max(range(len(cap.intra)), key=lambda i: (
        cap.intra_at[i][0] == 1 and intra_records(cap.intra[i]) > 0,
        intra_records(cap.intra[i])))
    log(f"SHVC: intra records of the EL pictures {n_el}; the intra kernel "
        f"is held on picture {cap.intra_at[k]} (layer, POC)")
    intra_place(f"SHVC picture {cap.intra_at[k]}", cap.intra[k], smi)
    up_err = 0
    for planes, a, k, il in cap.upsample:
        assert il[0].shape == (SHVC_EL[1], SHVC_EL[0]), il[0].shape
        cpu = UP.upsample_frame([p.cpu() for p in planes], *a, **k)
        up_err = max([up_err] + [int((c - o.cpu()).abs().max())
                                 for c, o in zip(cpu, il)])
    assert up_err == 0, f"SHVC: upsampler on the card != CPU ({up_err})"
    cgs = CgsLut(octant_depth=1, y_part_num_log2=1, res_quant_bit=1,
                 flc_bits=2, adapt_threshold_u_delta=5,
                 adapt_threshold_v_delta=-3)
    write_cgs_lut(BitWriter(), cgs, deltas=CGS_DELTAS)
    planes, a, k, il = cap.upsample[-1]
    cm_err = max(int((c - o.cpu()).abs().max()) for c, o in zip(
        UP.color_map_frame(cgs, [p.cpu() for p in planes]),
        UP.color_map_frame(cgs, planes)))
    assert cm_err == 0, f"SHVC: colour mapping on the card != CPU ({cm_err})"
    ev = {"colour map": cuda_ms(lambda: UP.color_map_frame(cgs, planes),
                                iters=10),
          "upsample": cuda_ms(lambda: UP.upsample_frame(planes, *a, **k),
                              iters=10),
          "pad": cuda_ms(lambda: pipeline.pad_dev_refs(il), iters=10)}

    def ready_decode(target_layer):
        """(pictures, seconds) of a decode timed to the card's last
        picture without fetching one (no MD5 check)."""
        t0 = time.perf_counter()
        frames = decoder.TorchDecoder(
            check_md5=False, device=dev,
            target_layer=target_layer).decode_bytes(data)
        for f in frames:
            f.planes.device_ready()
        return len(frames), time.perf_counter() - t0

    n_bl, t_bl = ready_decode(0)
    n_all, t_all = ready_decode(1)
    assert n_bl == n and n_all == 2 * n, (n_bl, n_all)
    torch.cuda.synchronize()
    fp = cap.ms["frame_program"]
    il_au = [u + p for u, p in zip(cap.ms["il_upsample"], cap.ms["il_pad"])]
    log(f"SHVC {SHVC_BL[0]}x{SHVC_BL[1]} -> {SHVC_EL[0]}x{SHVC_EL[1]}, "
        f"{n} access units: every MD5 of both layers correct, every "
        f"picture of both layers through the frame program, outputs and "
        f"DPB on the card, 0 references from the host, launches {counts} "
        f"for {n_inter} P pictures; mc_kernel and resid_add_kernel == plain "
        f"on EL picture {at} (error {mc_err}, {ra_err}); upsampler card == "
        f"CPU on the {n} captured base-layer pictures, CGS colour mapping "
        f"card == CPU (error {up_err}, {cm_err})")
    log(f"SHVC inter-layer build, ms per access unit, card synchronised "
        f"(captured run): upsample {cap.ms['il_upsample']}, pad "
        f"{cap.ms['il_pad']}, colour map not in this stream; total "
        f"{il_au} against the EL picture's frame program {fp[1::2]} and the "
        f"BL's {fp[0::2]} ({smi})")
    log(f"SHVC inter-layer build, ms per call (CUDA events, the captured "
        f"base-layer picture of access unit {n - 1}): {ev} ({smi})")
    log(f"SHVC fps without the fetch (LazyPlanes.device_ready, no MD5): "
        f"base layer alone {n / t_bl} fps ({t_bl:.3f} s), both layers "
        f"{n / t_all} access units a second ({t_all:.3f} s); counted "
        f"cli.main -l 1 with the MD5 fetch {n / wall} access units a second "
        f"({wall:.3f} s) ({smi})")
    log("SHVC trace split of the counted run, ms per access unit: " + ", "
        .join(f"{k} {v['total_s'] * 1e3 / n}" for k, v in sorted(
            split.items()) if "total_s" in v))
    log(f"SHVC captured run, stages synchronised, ms per call: "
        f"{cap.report()} ({smi})")


def cards():
    import torch
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def sync_cards():
    import torch
    for d in cards():
        torch.cuda.synchronize(d)


def synced(fn, out):
    """fn timed with every card synchronised before and after: ms appended
    to ``out``."""
    def run(*a, **k):
        sync_cards()
        t0 = time.perf_counter()
        res = fn(*a, **k)
        sync_cards()
        out.append((time.perf_counter() - t0) * 1e3)
        return res
    return run


class BandCapture:
    """On an uncounted banded decode: the inputs each band's recon hands the
    three kernel wrappers, keyed (POC, band) (the intra wavefront's as
    ``Capture.intra``), and each picture's stage B and each halo exchange
    in it timed with the cards synchronised."""

    def __init__(self):
        self.mc, self.resid, self.intra = {}, {}, {}
        self.at = None
        self.step_ms, self.exchange_ms, self.exchanges = [], [], []

    @contextlib.contextmanager
    def installed(self):
        from hevc_tpu_torch import mc_cuda, sharded
        orig = (mc_cuda.mc, mc_cuda.resid_add, sharded.band_recon,
                sharded.band_step, sharded._exchange,
                sharded.reconstruct_wavefront)

        def mc(canvas, refs_l, refs_c, groups, bd):
            self.mc[self.at] = (canvas.clone(), refs_l.clone(),
                                refs_c.clone(),
                                [g[:6] + (np.array(g[6]),) for g in groups],
                                bd)
            return orig[0](canvas, refs_l, refs_c, groups, bd)

        def resid_add(canvas, fields, pools, bd):
            self.resid[self.at] = (canvas.clone(),
                                   [f.clone() for f in fields],
                                   [q.clone() for q in pools], bd)
            return orig[1](canvas, fields, pools, bd)

        def band_recon(*a):
            self.at = (self.at[0], self.at[1] + 1)
            return orig[2](*a)

        def reconstruct_wavefront(canvas, scal, avail, resids, bd, tables,
                                  counts=None):
            self.intra[self.at] = intra_args(canvas, scal, avail, resids,
                                             bd, counts)
            return orig[5](canvas, scal, avail, resids, bd, tables, counts)

        timed_step = synced(orig[3], self.step_ms)

        def band_step(layout, fb, *a):
            self.at = (fb["poc"], layout.first - 1)
            n = len(self.exchange_ms)
            out = timed_step(layout, fb, *a)
            self.exchanges.append(sum(self.exchange_ms[n:]))
            return out

        mc_cuda.mc, mc_cuda.resid_add = mc, resid_add
        sharded.band_recon, sharded.band_step = band_recon, band_step
        sharded._exchange = synced(orig[4], self.exchange_ms)
        sharded.reconstruct_wavefront = reconstruct_wavefront
        try:
            yield self
        finally:
            (mc_cuda.mc, mc_cuda.resid_add, sharded.band_recon,
             sharded.band_step, sharded._exchange,
             sharded.reconstruct_wavefront) = orig


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def first_diff(got, want):
    """'' when the planes are equal, else where they first differ."""
    for p, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            return f"plane {p}: shape {g.shape} != {w.shape}"
        bad = np.argwhere(g != w)
        if bad.size:
            yx = tuple(int(v) for v in bad[0])
            return (f"plane {p}: {len(bad)} samples differ, first (y, x) "
                    f"{yx}: {g[yx]} != {w[yx]}")
    return ""


def displayed(planes, shapes):
    """Coded-size planes cut to the output pictures' shapes (the smoke's
    encoder pads only at the right and the bottom)."""
    return [np.asarray(p)[:h, :w] for p, (h, w) in zip(planes, shapes)]


def check_bands(outs, ref, what):
    """Every decoded picture's stitched bands equal the sequential host
    decode's planes."""
    from hevc_tpu_torch import sharded
    assert len(outs) == len(ref), what
    for i, (out, want) in enumerate(zip(outs, ref)):
        bad = first_diff(sharded.stitch(out), want)
        assert not bad, f"{what}: picture {i} {bad}"


def counted_banded(layout, frames, halo, pipeline, build):
    """``decode_gop_banded`` picture by picture, counted: launch counts and
    host references from 0 just before, read just after; each picture's
    stage B by CUDA events, the cards synchronised; the intra kernel must
    launch once per live chunk of every band, the residual kernel once a
    band.  Returns (outputs, ms per
    picture, launch counts, references from the host)."""
    import torch
    from hevc_tpu_torch import intra, intra_cuda, sharded
    dpb, outs, ev_ms = {}, [], []
    build.reset_launches()
    pipeline.host_refs["count"] = 0
    for fb in frames:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        outs += sharded.decode_gop_banded(layout, [fb], *halo, dpb=dpb)
        sync_cards()
        e1.record()
        e1.synchronize()
        ev_ms.append(e0.elapsed_time(e1))
    counts = {k: build.launches[k]
              for k in ("mc", "resid_add", "intra", "deblock", "sao",
                        "resid_tx")}
    live = sum(intra_cuda.live_chunks(intra.chunk_counts(
        fb["bands"][k].scal)) for fb in frames for k in layout.bands)
    assert counts["intra"] == live > 0, \
        f"banded: intra launches {counts['intra']} for {live} live chunks"
    # the bands' loop filters are the plain ones (ROADMAP item 22)
    assert counts["deblock"] == counts["sao"] == 0, \
        f"banded: loop filter launches {counts}"
    bands = len(frames) * len(layout.bands)
    assert counts["resid_tx"] == bands, \
        f"banded: residual launches {counts['resid_tx']} for {bands} bands"
    return outs, ev_ms, counts, pipeline.host_refs["count"]


def banded_decode(path, n_bands, n_frames, label, pipeline, build, smi):
    """``path`` in n_bands column bands through ``sharded`` (on one card,
    or spread over the cards there are): the host's stage A and band packs
    (``band.prepare_gop_banded``, every MD5 of its decode correct), a
    captured ``decode_gop_banded`` run (kernel inputs of every band; stage
    B and each halo exchange timed with the cards synchronised), a counted
    run (launch counts and host references from 0 just before, read just
    after; each picture's stage B by CUDA events): every plane equal to
    the sequential decode, no reference from the host, ``mc`` once per band
    of each P picture; both inter kernels against their plain versions on
    the last P picture's bands 0 and 1.  Returns what the phase prints."""
    from hevc_tpu_torch import band, sharded
    data = open(path, "rb").read()
    t0 = time.perf_counter()
    frames, ref, halo = band.prepare_gop_banded(data, n_bands)
    stage_a = time.perf_counter() - t0
    md5 = [f["md5_ok"] for f in frames]
    assert md5 == [True] * n_frames, f"{label}: host decode MD5 {md5}"
    n_inter = sum(bool(f["ref_pocs_l0"] or f["ref_pocs_l1"]) for f in frames)
    assert n_inter == n_frames - 1
    layout = sharded.BandLayout.over(n_bands, cards())
    cap = BandCapture()
    with cap.installed():
        check_bands(sharded.decode_gop_banded(layout, frames, *halo), ref,
                    f"{label} (captured)")
    outs, ev_ms, counts, host = counted_banded(layout, frames, halo,
                                               pipeline, build)
    check_bands(outs, ref, f"{label} (counted)")
    assert host == 0, f"{label}: {host} references from the host"
    assert counts["mc"] == n_bands * n_inter and counts["resid_add"] > 0, \
        f"{label}: launches {counts} for {n_inter} P pictures x {n_bands} " \
        "bands"
    poc = frames[-1]["poc"]
    errs = {k: kernel_errors(cap.mc[(poc, k)], cap.resid[(poc, k)])
            for k in (0, 1)}
    assert all(e == (0, 0) for e in errs.values()), \
        f"{label}: kernels != plain on POC {poc}'s bands: {errs}"
    poc0 = frames[0]["poc"]
    intra_place(f"{label} I picture POC {poc0} band 1", cap.intra[(poc0, 1)],
                smi)
    return dict(data=data, frames=frames, ref=ref, halo=halo, layout=layout,
                outs=outs, ev_ms=ev_ms, counts=counts, cap=cap, errs=errs,
                poc=poc, n_inter=n_inter, stage_a=stage_a)


def phase_banded(dev, smi, decoder, pipeline, build):
    """BANDED_STREAM in BANDS column bands (``banded_decode``), then the
    streaming decode with the halo widened mid-GOP, ``TorchDecoder`` on
    the same stream for comparison, and with BANDS cards or more
    ``dist_worker`` on the same stream over NCCL, one process and one band
    a card; then formats stream A, several slices over 2 x 2 tiles with
    per-slice filters and PCM, in BANDS_A bands (``phase_banded_slices``),
    and MONO_STREAM in BANDS bands (``phase_banded_mono``)."""
    from hevc_tpu_torch import band, sharded
    r = banded_decode(BANDED_STREAM, BANDS, BANDED_FRAMES, "banded",
                      pipeline, build, smi)
    data, layout, outs, halo = r["data"], r["layout"], r["outs"], r["halo"]
    counts, errs, poc, cap = r["counts"], r["errs"], r["poc"], r["cap"]

    orig = band.required_halo_frame
    calls, halos = [], []

    def bumped(plan, sps, nb):
        """From the third picture on, a bound wider than the halo so far."""
        hl, hc = orig(plan, sps, nb)
        calls.append(1)
        if len(calls) < 3:
            return hl, hc
        return max(hl, halos[-1][0]) + 8, max(hc, halos[-1][1]) + 4

    def tap(it):
        for fb, h in it:
            halos.append(h)
            yield fb, h

    band.required_halo_frame = bumped
    t0 = time.perf_counter()
    try:
        souts = list(sharded.decode_stream_banded(layout, tap(
            band.iter_gop_banded(data, BANDS, margin_l=0, margin_c=0))))
    finally:
        band.required_halo_frame = orig
    stream_s = time.perf_counter() - t0
    check_bands(souts, r["ref"], "banded (streamed, halo widened)")
    assert halos[2][0] > halos[1][0] and halos[2][1] > halos[1][1], \
        f"banded: the halo did not widen at the third picture {halos}"

    t0 = time.perf_counter()
    tframes = decoder.TorchDecoder(check_md5=True,
                                   device=dev).decode_bytes(data)
    tmd5 = [f.md5_ok for f in tframes]
    torch_s = time.perf_counter() - t0
    assert tmd5 == [True] * BANDED_FRAMES, f"banded: TorchDecoder MD5 {tmd5}"
    for i, f in enumerate(tframes):
        shapes = [p.shape for p in f.planes]
        bad = first_diff(displayed(sharded.stitch(outs[i]), shapes),
                         f.planes)
        assert not bad, f"banded != TorchDecoder, picture {i}: {bad}"
    t0 = time.perf_counter()
    for f in decoder.TorchDecoder(check_md5=False,
                                  device=dev).decode_bytes(data):
        f.planes.device_ready()
    torch_ready_s = time.perf_counter() - t0

    log(f"banded {W}x{H}, {BANDS} tile-aligned bands of {W // BANDS} "
        f"columns on {[str(d) for d in layout.devices]}, halo {halo}, "
        f"{BANDED_FRAMES} pictures (I P P): every plane == the sequential "
        f"host decode (every MD5 correct) on the captured, counted and "
        f"streamed runs, and == TorchDecoder; 0 references from the host; "
        f"launches {counts} ({r['n_inter']} P pictures x {BANDS} bands); "
        f"mc_kernel and resid_add_kernel == plain on POC {poc}'s bands 0 "
        f"and 1 (errors {errs}); streamed halos {halos}")
    log(f"banded stage A on the host (Decoder(recon_backend='plan'), its "
        f"NumPy stage B and filters, then the band packs): "
        f"{r['stage_a']:.3f} s for {BANDED_FRAMES} pictures; the streamed "
        f"run with its own stage A on a worker thread {stream_s:.3f} s "
        f"({smi})")
    share = [x / t for x, t in zip(cap.exchanges, cap.step_ms)]
    log(f"banded stage B, ms per picture: {r['ev_ms']} (CUDA events, "
        f"counted run); captured run with the cards synchronised "
        f"{cap.step_ms}, of which halo exchanges {cap.exchanges} (share "
        f"{share}) ({smi})")
    log(f"TorchDecoder on the banded stream: {torch_s:.3f} s with the MD5 "
        f"fetch, {torch_ready_s:.3f} s to the last picture on the card "
        f"without it, {BANDED_FRAMES} pictures ({smi})")
    banded_over_nccl(len(cards()), smi, BANDED_STREAM, BANDS)
    phase_banded_slices(smi, pipeline, build)
    phase_banded_mono(smi, pipeline, build)


def phase_banded_slices(smi, pipeline, build):
    """Formats stream A (1920x1080, 4 slices over 2 x 2 tiles with their
    own filter offsets, one slice without deblocking and one without loop
    filtering across its edges, no loop filtering across tiles, PCM exempt
    from the filters) in BANDS_A bands, one a tile column
    (``banded_decode``): the band filters take the gated boundary
    strengths, the offset maps, the SAO edge restrictions and the PCM
    exemption; with BANDS_A cards or more ``dist_worker`` on it over NCCL,
    one process and one band a card."""
    name = FORMAT_A
    n_frames = FORMATS[name][1]
    r = banded_decode(format_path(name), BANDS_A, n_frames, "banded A",
                      pipeline, build, smi)
    fis = [f["filters"] for f in r["frames"]]
    assert all(fi.per_slice and fi.sao_flags is not None for fi in fis), \
        "banded A: not per-slice filter inputs"
    assert fis[0].no_filter is not None, "banded A: no PCM exemption"
    cap = r["cap"]
    log(f"banded A {W}x{H} ({name}), {BANDS_A} tile-aligned bands of "
        f"{W // BANDS_A} columns on {[str(d) for d in r['layout'].devices]},"
        f" halo {r['halo']}, {n_frames} pictures (I P P), per-slice filter "
        f"maps, SAO edge restrictions and the PCM exemption on the bands: "
        f"every plane == the sequential host decode (every MD5 correct) on "
        f"the captured and counted runs; 0 references from the host; "
        f"launches {r['counts']} ({r['n_inter']} P pictures x {BANDS_A} "
        f"bands); mc_kernel and resid_add_kernel == plain on POC "
        f"{r['poc']}'s bands 0 and 1 (errors {r['errs']})")
    log(f"banded A stage A on the host: {r['stage_a']:.3f} s for {n_frames} "
        f"pictures; stage B ms per picture {r['ev_ms']} (CUDA events, "
        f"counted run); captured run with the cards synchronised "
        f"{cap.step_ms}, of which halo exchanges {cap.exchanges} ({smi})")
    banded_over_nccl(len(cards()), smi, format_path(name), BANDS_A)


def phase_banded_mono(smi, pipeline, build):
    """MONO_STREAM (1920x1080 4:0:0 intra pictures, deblocked) in BANDS
    column bands, counted: every plane equal to the sequential host decode
    (every MD5 correct), luma alone, no reference from the host, no MC
    launch (no inter picture); each picture's stage B by CUDA events."""
    from hevc_tpu_torch import band, sharded
    data = open(MONO_STREAM, "rb").read()
    t0 = time.perf_counter()
    frames, ref, halo = band.prepare_gop_banded(data, BANDS)
    stage_a = time.perf_counter() - t0
    md5 = [f["md5_ok"] for f in frames]
    assert md5 == [True] * MONO_FRAMES, f"banded 4:0:0: MD5 {md5}"
    assert all(f["mono"] and f["filters"].do_deblock for f in frames)
    layout = sharded.BandLayout.over(BANDS, cards())
    outs, ev_ms, counts, host = counted_banded(layout, frames, halo,
                                               pipeline, build)
    assert host == 0 and counts["mc"] == 0, (host, counts)
    assert all(len(w) == 1 for w in ref) and all(
        len(b) == 1 for out in outs for b in out), \
        "banded 4:0:0: not luma alone"
    check_bands(outs, ref, "banded 4:0:0")
    log(f"banded 4:0:0 {W}x{H}, {MONO_FRAMES} intra pictures deblocked, "
        f"{BANDS} bands: every luma plane == the sequential host decode "
        f"(every MD5 correct); 0 references from the host; launches "
        f"{counts}; stage A on the host {stage_a:.3f} s; stage B ms per "
        f"picture {ev_ms} (CUDA events) ({smi})")


def banded_over_nccl(n_cards, smi, path, n_bands):
    """``path`` through ``python -m hevc_tpu_torch.dist_worker`` over NCCL,
    one process and one band a card, each rank's band checked against the
    same columns of the sequential decode; with fewer than n_bands cards a
    line says that it did not run."""
    what = os.path.basename(path)
    if n_cards < n_bands:
        log(f"banded across processes (dist_worker over NCCL) on {what}: "
            f"{n_cards} card(s) visible, its {n_bands} bands need "
            f"{n_bands}, one rank a band; not run")
        return
    port, world = free_port(), n_bands
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hevc_tpu_torch.dist_worker", str(port),
         str(r), str(world), "1", "--stream", path, "--backend", "nccl"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"worker {r} OK" in out, \
            f"dist_worker rank {r} over NCCL on {what}:\n{out[-3000:]}"
    log(f"banded across processes: dist_worker over NCCL on {what}, "
        f"{world} ranks x 1 band, each rank's band == the sequential "
        f"decode: " + "; ".join(o.strip().splitlines()[-1] for o in outs)
        + f" ({time.perf_counter() - t0:.1f} s with start-up) ({smi})")


def phase_frame_axis(dev, smi, decoder, pipeline, build):
    """PGOP_STREAM through ``pgop_frame.decode_frame_parallel`` over the
    cards there are: the sequential ``TorchDecoder`` decode first (every
    MD5), then the frame axis counted (launch counts and host references
    from 0 just before, read just after; each picture's stage B timed with
    the cards synchronised): the 4 B pictures in one batch, every plane's
    MD5 == its SEI MD5 and == the sequential decode, 0 references from the
    host, ``mc`` once per inter picture."""
    from hevc_tpu_torch import pgop_frame
    from hevc_tpu_torch.bitstream.sei import picture_md5
    data = open(PGOP_STREAM, "rb").read()
    n = PGOP_B + 2
    t0 = time.perf_counter()
    seq = decoder.TorchDecoder(check_md5=True, device=dev).decode_bytes(data)
    seq_s = time.perf_counter() - t0
    md5 = {f.poc: f.md5_ok for f in seq}
    assert md5 == {p: True for p in range(n)}, f"frame axis: MD5 {md5}"
    step_ms = []
    orig = pgop_frame.band_step
    pgop_frame.band_step = synced(orig, step_ms)
    build.reset_launches()
    pipeline.host_refs["count"] = 0
    t0 = time.perf_counter()
    try:
        out, batches = pgop_frame.decode_frame_parallel(data, cards())
        sync_cards()
    finally:
        pgop_frame.band_step = orig
    wall = time.perf_counter() - t0
    counts = {k: build.launches[k]
              for k in ("mc", "resid_add", "intra", "deblock", "sao")}
    host = pipeline.host_refs["count"]
    assert batches == [[0], [PGOP_B + 1], list(range(1, PGOP_B + 1))], \
        f"frame axis: batches {batches}"
    assert host == 0, f"frame axis: {host} references from the host"
    assert counts["mc"] == n - 1 and counts["resid_add"] > 0 \
        and counts["intra"] > 0, \
        f"frame axis: launches {counts} for {n - 1} inter pictures"
    # each picture runs ``sharded.band_step``, whose loop filters are the
    # plain ones (ROADMAP item 22)
    assert counts["deblock"] == counts["sao"] == 0, \
        f"frame axis: loop filter launches {counts}"
    for f in seq:
        got = [p.cpu().numpy() for p in out[f.poc]]
        assert picture_md5(got, 8) == f.sei_hash.md5, \
            f"frame axis: POC {f.poc}'s MD5"
        bad = first_diff(displayed(got, [p.shape for p in f.planes]),
                         f.planes)
        assert not bad, f"frame axis != TorchDecoder, POC {f.poc}: {bad}"
    log(f"frame axis {W}x{H}, ParallelBGopEncoder(n_b={PGOP_B}): batches "
        f"{batches} over {[str(d) for d in cards()]}; every picture's MD5 "
        f"correct and every plane == the sequential TorchDecoder decode; 0 "
        f"references from the host; launches {counts} for {n - 1} inter "
        f"pictures")
    log(f"frame axis: {wall:.3f} s with its host stage A (Decoder("
        f"recon_backend='plan')) and packs; stage B ms per picture, decode "
        f"order, cards synchronised: {step_ms}; the sequential TorchDecoder "
        f"{seq_s:.3f} s with the MD5 fetch ({smi})")


def phase_small_reference(dev):
    """A 96x80 IPP/WPP stream: port on the card == the port's inline NumPy
    decoder."""
    import tempfile

    from hevc_tpu_torch.decoder import Decoder, TorchDecoder
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "small.265")
        synth_stream(path, 96, 80, 30, 3, log2_ctb=5)
        data = open(path, "rb").read()
    ref = Decoder(check_md5=True, recon_backend="inline").decode_bytes(data)
    got = TorchDecoder(check_md5=True, device=dev).decode_bytes(data)
    assert len(ref) == len(got) == 3
    for a, b in zip(ref, got):
        assert b.md5_ok is True, f"small stream: MD5 poc {b.poc}"
        for p in range(3):
            assert np.array_equal(a.planes[p], b.planes[p]), \
                f"small stream: plane {p} poc {a.poc} differs from inline"
    log("96x80 IPP/WPP: port on the card == inline NumPy decoder, MD5 ok")


def phase_cabac(data, dev):
    """The CABAC path on the 1080p stream's substreams and on random rows;
    returns (launches, max_abs_err, ms, plain_ms, bound) with both times
    and the bound on the R = 132 set."""
    import torch
    from hevc_tpu_torch import build, cabac_cuda
    from hevc_tpu_torch.cabac import rows as cabac
    from hevc_tpu_torch.device import max_sm_clock_mhz
    t0 = time.perf_counter()
    real = cabac.capture_substreams(data)
    n_real = sum(len(r.sched) for r in real)
    log(f"captured {len(real)} substreams, {n_real} bins (rows of "
        f"{min(len(r.sched) for r in real)} to "
        f"{max(len(r.sched) for r in real)}), in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rand = cabac.random_rows(np.random.default_rng(5), max(cabac.ROWS),
                             cabac.N_BINS, init_types=(0, 1, 2))
    log(f"encoded {len(rand)} random rows of {cabac.N_BINS} bins in "
        f"{time.perf_counter() - t0:.1f} s")
    resident = cabac_cuda.resident_rows(dev)
    assert resident == cabac.BLOCKS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    sets = {"1080p substreams": real}
    sets.update({f"R={R}": rand[:R] for R in cabac.ROWS})
    sets[f"R={resident + 1} (one more than resident)"] = [
        rand[k % len(rand)] for k in range(resident + 1)]
    packed = {k: [t.to(dev) for t in cabac.pack_rows(v)]
              for k, v in sets.items()}
    # one 1080p picture's 17 rows, at the width of all 68: the plain
    # version's bins of a row do not depend on the other rows, so this
    # set's are the first 17 rows of the 68 rows' (73,193 eager steps once)
    sets["R=17 (one 1080p picture)"] = real[:17]
    packed["R=17 (one 1080p picture)"] = [
        t[:17].contiguous() for t in packed["1080p substreams"]]
    ragged = cabac.ragged_rows(33, 2 * cabac.CHUNK + 1)
    sets["33 ragged rows"] = ragged[0]
    packed["33 ragged rows"] = [t.to(dev) for t in ragged[1:]]
    d, sc = packed["33 ragged rows"][:2]
    assert d.shape[1] % 16 == 1 and sc.shape[1] % cabac.CHUNK == 1

    smem, alu = cabac_cuda.chain_latencies(dev)
    mhz = max_sm_clock_mhz()
    assert 10 < smem < 100 and 2 < alu < 20, (smem, alu)
    log(f"chain bound terms: {smem} SM clocks a shared-memory round trip, "
        f"{alu} a dependent ALU instruction (chain_latency_kernel), "
        f"{mhz} MHz (nvidia-smi clocks.max.sm), {resident} rows at a time; "
        f"per bin (round trips, instructions): {cabac.CHAIN}")

    # the counted run: every set through the entry point, count from 0
    build.reset_launches()
    got = {k: cabac.decode_rows(*p[:3]) for k, p in packed.items()}
    torch.cuda.synchronize()
    launches = build.launches["cabac"]
    assert launches == len(sets), f"cabac launches {launches}"

    err, ms, bounds, plain68 = 0, {}, {}, None
    for k, rows in sets.items():
        data_t, sched, init, lens = packed[k]
        # the bins the Python engine decoded (captured rows) or the encoder
        # was given (random rows); -1 in the padding
        want = np.full(tuple(sched.shape), -1, np.int32)
        for i, r in enumerate(rows):
            want[i, :len(r.bins)] = r.bins
        want = torch.from_numpy(want).to(dev)
        assert bool(((got[k] == want) | (want < 0)).all()), \
            f"cabac_kernel: {k} != the expected bins"
        if k.startswith("R=17"):
            plain, plain_s = plain68[:17], float("nan")
        else:
            t0 = time.perf_counter()
            plain = cabac.decode_rows_plain(data_t, sched, init)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if k == "1080p substreams":
                plain68 = plain
        e = int((got[k] - plain).abs().max())
        assert e == 0, f"cabac_kernel != plain on {k}"
        err = max(err, e)
        n = int(lens.sum())
        ms[k] = cuda_ms(lambda: cabac_cuda.launch_cabac(
            data_t, sched, init, sched.shape[1]), iters=10)
        entry_ms = cuda_ms(lambda: cabac.decode_rows(data_t, sched, init),
                           iters=10)
        bounds[k] = cabac.chain_bound(sched, smem, alu, mhz, resident)
        n_bytes = 4 * (data_t.numel() + 2 * sched.numel() + init.numel())
        log(f"cabac {k}: {len(rows)} rows x {sched.shape[1]} bins; kernel "
            f"== plain == expected; kernel {ms[k]} ms per launch, "
            f"{n / ms[k] / 1e3} Mbins/s ({sched.numel() / ms[k] / 1e3} "
            f"Mbins/s counting padding); entry point decode_rows {entry_ms} "
            f"ms; plain {plain_s * 1e3} ms once; chain bound "
            f"{bounds[k]['ms']} ms ({bounds[k]['ms'] / ms[k]:.3f} of the "
            f"kernel's time) for the longest row's (context, bypass, "
            f"terminate) bins {bounds[k]['bins']} = {bounds[k]['clocks']} "
            f"clocks x {bounds[k]['waves']} waves; bytes bound "
            f"{n_bytes / HBM_BYTES_S * 1e3} ms")
    data_t, sched, init, _ = packed["R=132"]
    plain_ms = cuda_ms(lambda: cabac.decode_rows_plain(data_t, sched, init),
                       iters=2, warmup=1)
    PROFILE.append(("cabac_kernel", lambda: cabac_cuda.launch_cabac(
        data_t, sched, init, sched.shape[1])))
    log(f"cabac R=132: plain {plain_ms} ms (CUDA events)")
    # bytes: data, schedule and initial states read once, bins written
    # once; operations: about 16 int32 operations a bin step; chain: the
    # longest row's
    n_bytes = 4 * (data_t.numel() + 2 * sched.numel() + init.numel())
    return launches, err, ms["R=132"], plain_ms, bound_ms(
        n_bytes, 16 * sched.numel(), bounds["R=132"]["ms"])


# what the card answers: a window at an unaligned inner offset (x = 37
# int32) moves as two aligned boxes, while one box there faults
ONE_BOX_FAULT = ("OK as two aligned boxes; one box: fault, CUDA error 715 "
                 "(an illegal instruction was encountered)")
WINDOW_OUTCOMES = {
    "fully aligned": "OK", "aligned-shape, odd offset": ONE_BOX_FAULT,
    "rows8, lanes39":
        "rejected at encode (CUresult 1 CUDA_ERROR_INVALID_VALUE)",
    "aligned": "OK", "16x32 odd": ONE_BOX_FAULT}


def phase_probes(dev, smi):
    """The probe path; returns {kernel: (launches, max_abs_err, ms,
    plain_ms, library_ms, bound)}: tile_shift and tma_window at the
    probes' shapes, tma_pipe on the planes larger than L2 (at the probe's
    plane both stay in L2, where device memory's rate bounds nothing)."""
    import torch
    from hevc_tpu_torch import build, probes
    build.reset_launches()
    probes.clear_tensor_maps()
    res = probes.run_probes(dev, log=log)
    torch.cuda.synchronize()
    counts = {k: build.launches[k] for k in probes.PROBES}
    assert all(v > 0 for v in counts.values()), counts
    assert set(res["tile_shift"].values()) == {0}, res["tile_shift"]
    assert res["tma_window"] == WINDOW_OUTCOMES, res["tma_window"]
    assert res["tma_pipe"] == 0, "tma_pipe_kernel != plain"
    # a tensor map per plane and box: on the one window plane each box the
    # encoder took (its refusal of (40, 39) is not kept) and each box of the
    # plans (bands of 4 rows: (4, 128), (4, 132), (4, 36)); the two pipes'
    # sources and destinations
    taken = [c for c in probes.WINDOW_CASES if c.shape != (40, 39)]
    boxes = {c.shape for c in taken} | {
        probes.window_plan(c.shape, c.origin).box for c in taken}
    encodes = build.launches["tma_encode"]
    assert counts["tma_window"] == 4 and counts["tile_shift"] == 3 \
        and counts["tma_pipe"] == 2 and encodes == len(boxes) + 4 == 10, \
        f"{encodes} tensor maps encoded for {counts}"
    probes.clear_tensor_maps()
    times, host = probes.time_probes(dev)
    timed = {k: build.launches[k] - counts[k] for k in probes.PROBES}
    encodes = build.launches["tma_encode"] - encodes
    assert min(timed.values()) >= 20 and timed["tma_window"] >= 40 \
        and encodes == 6, \
        f"{encodes} tensor maps encoded for the timed launches {timed}"
    log(f"tensor maps: 10 encoded on the probe path, {encodes} for the "
        f"timed launches {timed} (one plane and box each: the window's "
        "(40, 128) box and its plan's (4, 132), the two pipes' sources and "
        "destinations)")
    big_org = probes.pipe_tiling(probes.PIPE_BIG_PLANE)
    for k, org in (("tma_pipe", probes.pipe_origins()),
                   ("tma_pipe_big", big_org)):
        ms, plain_ms = times[k]
        log(f"{k}: {ms} ms per launch, {ms / org.shape[0] * 1e3} us/block, "
            f"{probes.pipe_bytes(org) / ms / 1e6} GB/s "
            f"({probes.pipe_bytes(org)} B); plain index copy {plain_ms} ms "
            f"({smi})")
    log(f"probe times, ms (kernel, plain; CUDA events; tma_window is the "
        f"bare launch, tma_window_call the entry point): {times} ({smi}); "
        f"launch counts {counts}")
    log(f"host us a call (time.perf_counter over 1,000 calls, no sync): "
        f"{host} ({smi})")

    # one PyTorch call for the same function on the same inputs, and the
    # kernels' launches to trace with the profiler at the end
    tile = probes.ramp(probes.TILE, dev)
    big = probes.ramp(probes.TILE_8K, dev)
    shift = torch.tensor(probes.SHIFT, dtype=torch.int32, device=dev)
    plane = probes.ramp(probes.PLANE, dev)
    case = probes.WINDOW_CASES[1]
    (wh, ww), (oy, ox) = case.shape, case.origin
    x = probes.ramp(probes.PIPE_BIG_PLANE, dev)
    org = big_org.to(dev)
    o = org.long()
    bh, bw = probes.PIPE_BOX
    ys = (o[:, 0, None] + torch.arange(bh, device=dev))[:, :, None]
    xs = (o[:, 1, None] + torch.arange(bw, device=dev))[:, None, :]
    out = torch.zeros_like(x)

    def index_copy():
        out[ys, xs] = x[ys, xs]

    calls = {"tile_shift": lambda: torch.roll(tile, probes.SHIFT, (0, 1)),
             "tile_shift 4320x7680":
                 lambda: torch.roll(big, probes.SHIFT, (0, 1)),
             "tma_window": lambda: plane[oy:oy + wh, ox:ox + ww].clone(),
             "tma_pipe": index_copy}
    library = {k: cuda_ms(fn, iters=3 if k == "tma_pipe" else 20)
               for k, fn in calls.items()}
    PROFILE_LIBRARY.extend(calls.items())
    pout = torch.zeros_like(x)
    plan = probes.window_plan(case.shape, case.origin)
    tmap = probes.tensor_map(plane, plan.box)
    wout = torch.empty(case.shape, dtype=torch.int32, device=dev)
    PROFILE.extend([
        ("tile_shift_kernel",
         lambda: probes.tile_shift(tile, shift, probes.ROLL)),
        ("tile_shift_kernel 4320x7680",
         lambda: probes.tile_shift(big, shift, probes.ROLL)),
        ("tma_window_kernel",
         lambda: probes.launch_tma_window(tmap, plan, False, wout)),
        ("tma_pipe_kernel 8192x8192",
         lambda: probes.launch_tma_pipe(x, org, pout))])
    log(f"probe library calls, ms (CUDA events): {library} ({smi})")
    # bytes each function must move: its input read once, its output
    # written once (the pipe's count both, plus the origins)
    work = {"tile_shift": 2 * tile.numel() * 4,
            "tile_shift 4320x7680": 2 * big.numel() * 4,
            "tma_window": 2 * wh * ww * 4,
            "tma_pipe": probes.pipe_bytes(big_org) + org.numel() * 4}
    bounds = {k: bound_ms(v, 0) for k, v in work.items()}
    # the pipe on the probe's plane stays in L2: its bound is the bytes
    # over the L2's rate as a graph of repeated device copies measures it
    rates = probes.copy_rates(dev)
    l2 = max(rates[n] for n in probes.L2_BUFFERS)
    org_small = probes.pipe_origins()
    pipe_l2 = (probes.pipe_bytes(org_small) + org_small.numel() * 4) / l2 * 1e3
    log(f"copy rates, GB/s by buffer bytes (dst.copy_(src), 50 copies in a "
        f"CUDA graph): { {n: r / 1e9 for n, r in rates.items()} }; "
        f"tma_pipe on the probe's {probes.PIPE_PLANE} planes: L2 bound "
        f"{pipe_l2} ms (bytes) against {times['tma_pipe'][0]} ms "
        f"({pipe_l2 / times['tma_pipe'][0]:.3f} of it) ({smi})")
    ms8k = times["tile_shift_8k"][0]
    log(f"tile_shift 4320x7680: {ms8k} ms, bytes bound "
        f"{bounds['tile_shift 4320x7680'][0]} ms "
        f"({bounds['tile_shift 4320x7680'][0] / ms8k:.3f} of it), torch.roll"
        f" {library['tile_shift 4320x7680']} ms ({smi})")
    errs = {"tile_shift": max(res["tile_shift"].values()),
            "tma_window": res["tma_window_err"], "tma_pipe": res["tma_pipe"]}
    times["tma_pipe"] = times["tma_pipe_big"]
    return {k: (counts[k], errs[k]) + times[k]
            + (library[k], bounds[k]) for k in counts}


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               library_ms, bound):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # the 1080p streams encode in worker processes while the kernels build
    # and the first phases run; the workers are gone before the first 1080p
    # decode, so that nothing of theirs runs beside a timed phase
    dev = torch.device("cuda", 0)
    with ProcessPoolExecutor(len(stream_jobs()),
                             mp_context=mp.get_context("spawn")) as pool:
        started = start_streams(pool)
        prepare(dev)
        wait_streams(started)
    return run(smi, dev)


def prepare(dev):
    """Build stage A and the kernels; the launch floor, the random kernel
    cases and the small stream."""
    from hevc_tpu_torch import build, native
    assert native.available(), "native stage A failed to build"
    log(f"native stage A: {os.path.relpath(native._SO, ROOT)}")
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(os.path.relpath(s, ROOT) for s in build.sources())})")
    from hevc_tpu_torch import intra_cuda
    FLOOR.append(intra_cuda.launch_floor_ms(dev))
    FLOOR.append(intra_cuda.launch_floor_ms(dev))
    assert 0 < FLOOR[0][0] < 0.05, FLOOR
    log(f"launch floor (hevc_launch_floor: 500 empty launches back to back "
        f"on one stream), ms a launch: queued on the card {FLOOR[0][0]}, "
        f"{FLOOR[1][0]}; as the host issues them {FLOOR[0][1]}, "
        f"{FLOOR[1][1]}; the intra chain bound takes {FLOOR[0][0]}")
    phase_random_kernels(dev)
    phase_small_reference(dev)


def run(smi, dev):
    import torch
    from hevc_tpu_torch import build, cli, decoder, pipeline, trace

    # two uncounted decodes: a warm-up, then one with the pack and the
    # frame program inline (not overlapped with the next frames' stage A)
    # that captures each kernel's real inputs and times each stage
    data = open(STREAM, "rb").read()

    def decode_all():
        frames = decoder.TorchDecoder(check_md5=True,
                                      device=dev).decode_bytes(data)
        assert len(frames) == FRAMES and all(f.md5_ok is True
                                             for f in frames), "MD5"

    decode_all()
    cap = Capture()
    os.environ["HEVC_TPU_ASYNC_PACK"] = "0"
    try:
        with cap.installed():
            decode_all()
    finally:
        os.environ.pop("HEVC_TPU_ASYNC_PACK")

    # the counted run: the CLI entry point, launch counts from zero; before
    # any torch.profiler session (after one, this run was 15-25% slower)
    buf = io.StringIO()

    def decode():
        with contextlib.redirect_stdout(buf):
            return cli.main(["-i", STREAM, "-v", "40", "--device", "cuda"])

    rc, seen, counts, split, wall = counted_decode(
        decode, dev, pipeline, trace, build)
    out = buf.getvalue()
    log(out.strip())
    n_inter = sum(s["inter"] for s in seen)
    assert rc == 0, f"cli.main returned {rc}"
    assert out.count("Correct MD5") == FRAMES, "not every frame's MD5 ok"
    assert len(seen) == FRAMES and n_inter == FRAMES - 1, seen
    assert counts["mc"] == n_inter and 0 < counts["resid_add"] <= n_inter, \
        f"launches {counts} for {n_inter} inter pictures"
    assert counts["deblock"] == 2 * FRAMES and counts["sao"] == FRAMES, \
        f"loop filter launches {counts} for {FRAMES} pictures"

    log(f"1080p decode via cli.main: {FRAMES / wall} fps wall "
        f"(incl. MD5 fetch), {out.strip().splitlines()[-1]}")
    log("trace split of the counted run, ms/frame: " + ", ".join(
        f"{k} {v['total_s'] * 1e3 / FRAMES}"
        for k, v in sorted(split.items()) if "total_s" in v))
    log(f"inline decode, stages synchronised, ms per call: {cap.report()}")
    log(f"1080p I picture (POC 0), card synchronised: frame program "
        f"{cap.ms['frame_program'][0]} ms, of which the intra wavefront "
        f"{cap.ms['reconstruct_wavefront'][0]} ms; the P pictures' frame "
        f"programs {cap.ms['frame_program'][1:]} ms ({smi})")
    log(f"launch counts of the counted run: {counts} (intra: the live "
        f"chunks {[s['live'] for s in seen]})")

    real = phase_real_kernels(cap, dev, smi)
    uhd = phase_bank_kernels(dev, smi)
    loop_filter = phase_loop_filter(dev, smi)
    resid_tx = phase_residuals(dev, smi)
    phase_stage_b(dev, smi)
    sparse = {STREAM: [s["coo"] for s in seen]}
    for name in FORMATS:
        sparse[format_path(name)] = [
            s["coo"] for s in phase_format(name, dev, smi, decoder, pipeline,
                                           trace, build)]
    phase_coo(dev, smi, pipeline, sparse)
    phase_shvc(dev, smi, cli, decoder, pipeline, trace, build)
    kernels = []
    for name, line in (("mc", 161), ("resid_add", 356)):
        err, ms, plain_ms, bound = real[name]
        kernels.append(kernel_row(
            f"{name}_kernel", "hevc_tpu_torch/csrc/mc.cu",
            f"hevc_tpu/tpu/mc_pallas.py:{line}", counts[name],
            max(err, uhd[name]), ms,
            plain_ms, None, bound))

    n, err, ms, plain_ms, bound = phase_cabac(data, dev)
    kernels.append(kernel_row(
        "cabac_kernel", "hevc_tpu_torch/csrc/cabac.cu",
        "hevc_tpu/tpu/cabac_pallas.py:49", n, err, ms, plain_ms, None,
        bound))
    phase_banded(dev, smi, decoder, pipeline, build)
    phase_frame_axis(dev, smi, decoder, pipeline, build)
    # the intra kernel's row: launches on the main stream's counted run, its
    # largest error over every place it was held against the plain version
    _err, ms, plain_ms, bound = real["intra"]
    kernels.append(kernel_row(
        "intra_kernel", "hevc_tpu_torch/csrc/intra.cu",
        "hevc_tpu/tpu/intra.py:201", counts["intra"],
        max(e for _p, e in INTRA_ERRORS), ms, plain_ms, None, bound))
    log(f"intra kernel held against its plain version (error) at: "
        f"{INTRA_ERRORS}")
    # the loop filter kernels' row: the main stream's counted launches, the
    # largest error over every place they were held, the RA P picture's
    # times and bound
    _err, ms, plain_ms, bound = loop_filter
    kernels.append(kernel_row(
        "loop_filter_kernels", "hevc_tpu_torch/csrc/filters.cu",
        "hevc_tpu_torch/filters.py deblock, sao_plane",
        counts["deblock"] + counts["sao"],
        max(e for _p, e in LOOP_FILTER_ERRORS), ms, plain_ms, None, bound))
    log(f"loop filter kernels held against their plain versions (error) "
        f"at: {LOOP_FILTER_ERRORS}")
    # the residual kernel's row: the main stream's counted launches, the
    # largest error over every place it was held, the RA P picture's times
    # and bound
    _err, ms, plain_ms, bound = resid_tx
    kernels.append(kernel_row(
        "resid_tx_kernel", "hevc_tpu_torch/csrc/resid.cu",
        "hevc_tpu_torch/recon.py residuals", counts["resid_tx"],
        max(e for _p, e in RESID_ERRORS), ms, plain_ms, None, bound))
    log(f"residual kernel held against its plain version (error) at: "
        f"{RESID_ERRORS}")
    for name, row in phase_probes(dev, smi).items():
        kernels.append(kernel_row(
            f"{name}_kernel", "hevc_tpu_torch/csrc/probes.cu",
            {"tile_shift": "tools/probe_roll.py:34",
             "tma_window": "tools/probe_dma.py:18",
             "tma_pipe": "tools/probe_roll.py:79"}[name], *row))
    device = {name: profiler_ms(fn, name.split()[0], iters=5)
              for name, fn in PROFILE}
    log(f"device ms per launch (torch.profiler, after every other phase): "
        f"{device} ({smi})")
    library = {name: profiler_ms(fn, None, iters=5)
               for name, fn in PROFILE_LIBRARY}
    log(f"device ms of the probes' library calls (torch.profiler, every "
        f"kernel of the call): {library} ({smi})")
    lf = {name: sum(profiler_ms(fn, k, iters=5) or 0
                    for k in ("deblock_kernel", "sao_kernel"))
          for name, fn in PROFILE_LOOP_FILTER}
    log(f"device ms of a picture's three loop filter launches "
        f"(torch.profiler, the kernels alone, each deblocking a fresh copy "
        f"of the captured planes): {lf} ({smi})")
    rt = {name: profiler_ms(fn, "resid_tx_kernel", iters=5)
          for name, fn in PROFILE_RESID}
    log(f"device ms of a picture's residual launch (torch.profiler, the "
        f"kernel alone): {rt} ({smi})")
    for rep, iters in PROFILE_REPLAYS:
        busy, idle = rep.profiled(iters)
        log(f"stage-B trace, {rep.name}: device-busy {busy} ms a replay"
            f" ({1e3 / busy} device fps), idle share {idle} over {iters} "
            f"replays (torch.profiler) ({smi})")
    blocked = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "hevc_tpu"))
    assert not blocked, f"the port imported {blocked}"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
