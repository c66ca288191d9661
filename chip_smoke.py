"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. checks that the native stage A is built (it would silently fall back
   to Python otherwise) and builds the CUDA kernels from ``csrc/``;
3. holds each kernel against its plain PyTorch version, bit for bit
   (tolerance 0), on random cases of every MC flavour and residual class
   and on the row sets of a real 1080p P frame, and times both versions
   with CUDA events at those 1080p shapes;
4. decodes a 96x80 IPP stream on the card and compares it with the
   inline NumPy decoder, then decodes a 4-frame 1920x1080 IPP/WPP stream
   (the headline stream of ``bench.py``, cut to 4 frames and cached under
   ``.bench/``) through ``hevc_tpu_torch.cli.main`` and checks every
   frame's SEI MD5, that both kernels launched on that run and that the
   outputs lived on the card;
5. the CABAC path: captures every WPP substream of that 1080p stream
   with the JAX package's Python engine (one row per substream) and
   encodes random row sets of 4,096 bins (R = 1, 8, 132, 1,024); with the
   launch count at 0, decodes all of them through
   ``hevc_tpu_torch.cabac.decode_rows``; then holds the CABAC kernel's
   bins against the captured bins, the encoder's bins and the plain
   version (tolerance 0), and times kernel and plain version;
6. the probe path: with the launch counts at 0, runs
   ``hevc_tpu_torch.probes.run_probes`` (tile roll and slice, the five
   TMA window cases of ``tools/probe_dma.py``, the 2,880-block TMA
   pipeline), checks each kernel against its plain version and the
   window outcomes (four OK, the two at an unaligned inner offset as two
   aligned boxes while one box there faults in a child process, and the
   (40, 39) box refused by the tensor-map encoder), and times each kernel
   beside its plain version;
7. prints the kernel table and the card as JSON; the last line is
   ``{"ok": true, "device": {...}}``.

Any failure raises, so the script exits nonzero before the last line.  It
also exits nonzero at once without a visible CUDA device.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

from hevc_tpu_torch.device import cuda_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench")
W, H, QP, FRAMES = 1920, 1080, 30, 4
STREAM = os.path.join(CACHE, f"smoke_{W}x{H}_qp{QP}_ctb64_wpp_{FRAMES}f.265")


def log(*a):
    print(*a, flush=True)


def synth_stream(path, w, h, qp, frames, wpp=True, log2_ctb=6):
    """IPP stream with the settings of bench.py's _synth_stream."""
    from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=w, height=h, qp=qp, log2_ctb_size=log2_ctb,
        log2_cu_size=log2_ctb, deblocking=True, sao=True, seed=1,
        gop="ipp", search_range=3, wpp=wpp))
    base = synth_frame("gradient", w, h, 0, seed=9)
    data = bytearray()
    for t in range(frames):
        data += enc.encode_frame([np.roll(base[0], (t * 4, t * 7), (0, 1)),
                                  np.roll(base[1], (t * 2, t * 3), (0, 1)),
                                  np.roll(base[2], (t * 2, t * 3), (0, 1))])
    tmp = path + f".{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


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
    from hevc_tpu.tpu.pack import PAD_REF
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

def phase_random_kernels(dev):
    import torch
    from hevc_tpu_torch import mc_cuda
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
    for cls in range(4):
        for bd in (8, 10):
            canvas, pool, rows = random_resid_case(rng, cls, bd)
            c = torch.from_numpy(canvas).to(dev)
            pools = [torch.zeros((1, 4 << k, 4 << k), dtype=torch.int32,
                                 device=dev) for k in range(4)]
            pools[cls] = torch.from_numpy(pool).to(dev)
            fields = [torch.zeros((0, 3), dtype=torch.int32, device=dev)
                      for _ in range(4)]
            fields[cls] = torch.from_numpy(rows).to(dev)
            got = mc_cuda.resid_add(c.clone(), fields, pools, bd)
            want = resid_add_plain(c.clone(), fields, pools, bd)
            err = int((got - want).abs().max())
            assert err == 0, f"resid_add_kernel != plain on class {cls}"
    torch.cuda.synchronize()
    log(f"random kernel cases: {len(MC_CASES)} MC flavours and 4x2 residual "
        "classes bit-exact")


class Capture:
    """On an uncounted decode: records the inputs the frame program
    hands each kernel wrapper, and times each stage of the frame program
    with the device synchronised before and after (ms per call)."""

    STAGES = ("frame_program", "residuals", "reconstruct_wavefront",
              "deblock", "sao_plane")

    def __init__(self):
        self.mc, self.resid = [], []
        self.ms = {k: [] for k in self.STAGES + ("mc", "resid_add")}

    @contextlib.contextmanager
    def installed(self):
        import torch
        from hevc_tpu_torch import mc_cuda, pipeline
        orig = {k: getattr(pipeline, k) for k in self.STAGES}
        orig_mc, orig_ra = mc_cuda.mc, mc_cuda.resid_add

        def timed(fn, name):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.ms[name].append((time.perf_counter() - t0) * 1e3)
                return out
            return run

        mc_t, ra_t = timed(orig_mc, "mc"), timed(orig_ra, "resid_add")

        def mc(canvas, refs_l, refs_c, groups, bd):
            self.mc.append((canvas.clone(), refs_l.clone(), refs_c.clone(),
                            [g[:6] + (g[6].clone(),) for g in groups], bd))
            return mc_t(canvas, refs_l, refs_c, groups, bd)

        def resid_add(canvas, fields, pools, bd):
            self.resid.append((canvas.clone(), [f.clone() for f in fields],
                               [p.clone() for p in pools], bd))
            return ra_t(canvas, fields, pools, bd)

        mc_cuda.mc, mc_cuda.resid_add = mc, resid_add
        for k, fn in orig.items():
            setattr(pipeline, k, timed(fn, k))
        try:
            yield self
        finally:
            mc_cuda.mc, mc_cuda.resid_add = orig_mc, orig_ra
            for k, fn in orig.items():
                setattr(pipeline, k, fn)

    def report(self):
        return "; ".join(f"{k} " + ", ".join(f"{t:.3f}" for t in v)
                         for k, v in self.ms.items())


def phase_real_kernels(cap, dev):
    """Kernel vs plain on the largest captured 1080p row sets; times."""
    import torch
    from hevc_tpu_torch import mc_cuda
    from hevc_tpu_torch.mc import mc_plain, resid_add_plain
    from hevc_tpu_torch.tables import tables_from_reference
    tabs = tables_from_reference(dev)
    assert cap.mc and cap.resid, "the captured decode ran no inter frame"
    canvas, refs_l, refs_c, groups, bd = max(
        cap.mc, key=lambda a: sum(g[6].shape[0] for g in a[3]))
    n_mc = sum(g[6].shape[0] for g in groups)
    got = mc_cuda.mc(canvas.clone(), refs_l, refs_c, groups, bd)
    want = mc_plain(canvas.clone(), refs_l, refs_c, groups, bd, tabs)
    mc_err = int((got - want).abs().max())
    assert mc_err == 0, "mc_kernel != plain on the 1080p P frame"
    work = canvas.clone()
    rows = mc_cuda.mc_rows(groups, dev)
    mc_ms = cuda_ms(lambda: mc_cuda.launch_mc(work, refs_l, refs_c, rows, bd))
    mc_call_ms = cuda_ms(lambda: mc_cuda.mc(work, refs_l, refs_c, groups, bd))
    mc_plain_ms = cuda_ms(lambda: mc_plain(work, refs_l, refs_c, groups, bd,
                                           tabs), iters=5, warmup=1)

    canvas, fields, pools, bd = max(
        cap.resid, key=lambda a: sum(f.shape[0] for f in a[1]))
    n_tu = [int(f.shape[0]) for f in fields]
    got = mc_cuda.resid_add(canvas.clone(), fields, pools, bd)
    want = resid_add_plain(canvas.clone(), fields, pools, bd)
    ra_err = int((got - want).abs().max())
    assert ra_err == 0, "resid_add_kernel != plain on the 1080p P frame"
    work = canvas.clone()

    def all_classes():
        for c, f in enumerate(fields):
            mc_cuda.launch_resid_add(work, f, pools[c], bd)

    ra_ms = cuda_ms(all_classes)
    ra_call_ms = cuda_ms(lambda: mc_cuda.resid_add(work, fields, pools, bd))
    ra_plain_ms = cuda_ms(lambda: resid_add_plain(work, fields, pools, bd),
                          iters=5, warmup=1)
    log(f"1080p P frame: {n_mc} MC rows in {len(groups)} groups, "
        f"inter TUs per class {n_tu}; kernels bit-exact")
    # bytes the kernels must move: each prediction's (h+t-1)(w+t-1)
    # window read once, the block written once; residual add reads the
    # canvas tile and the residual block and writes the tile (int32)
    mc_bytes = sum(g[6].shape[0] * 4 * (
        (2 if g[1] else 1) * (g[5] + (3 if g[0] else 7))
        * (g[4] + (3 if g[0] else 7)) + g[4] * g[5]) for g in groups)
    ra_bytes = sum(int(f.shape[0]) * 12 * (4 << c) ** 2
                   for c, f in enumerate(fields))
    log(f"bytes: mc {mc_bytes} ({mc_bytes / mc_ms / 1e6} GB/s), resid_add "
        f"{ra_bytes} ({ra_bytes / ra_ms / 1e6} GB/s)")
    log(f"ms per call (CUDA events): mc launch {mc_ms}, mc wrapper "
        f"{mc_call_ms}, plain {mc_plain_ms}; resid_add launches {ra_ms}, "
        f"wrapper {ra_call_ms}, plain {ra_plain_ms}")
    return {"mc": (mc_err, mc_ms, mc_plain_ms),
            "resid_add": (ra_err, ra_ms, ra_plain_ms)}


def phase_small_reference(dev):
    """A 96x80 IPP/WPP stream: port on the card == inline NumPy decoder."""
    import tempfile

    from hevc_tpu.decoder.core import Decoder
    from hevc_tpu_torch.decoder import TorchDecoder
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
    returns (launches, max_abs_err, ms, plain_ms) with both times on the
    R = 132 set."""
    import torch
    from hevc_tpu_torch import build, cabac, cabac_cuda
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
    sets = {"1080p substreams": real}
    sets.update({f"R={R}": rand[:R] for R in cabac.ROWS})
    packed = {k: [t.to(dev) for t in cabac.pack_rows(v)]
              for k, v in sets.items()}

    # the counted run: every set through the entry point, count from 0
    build.reset_launches()
    got = {k: cabac.decode_rows(*p[:3]) for k, p in packed.items()}
    torch.cuda.synchronize()
    launches = build.launches["cabac"]
    assert launches == len(sets), f"cabac launches {launches}"

    err, ms = 0, {}
    for k, rows in sets.items():
        data_t, sched, init, lens = packed[k]
        out = got[k].cpu()
        for i, r in enumerate(rows):
            assert out[i, :len(r.bins)].tolist() == r.bins, \
                f"cabac_kernel: {k} row {i} != the Python engine's bins"
        t0 = time.perf_counter()
        plain = cabac.decode_rows_plain(data_t, sched, init)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        e = int((got[k] - plain).abs().max())
        assert e == 0, f"cabac_kernel != plain on {k}"
        err = max(err, e)
        n = int(lens.sum())
        ms[k] = cuda_ms(lambda: cabac_cuda.launch_cabac(
            data_t, sched, init, sched.shape[1]), iters=10)
        log(f"cabac {k}: {len(rows)} rows x {sched.shape[1]} bins; kernel "
            f"== plain == expected; kernel {ms[k]} ms per launch, "
            f"{n / ms[k] / 1e3} Mbins/s ({sched.numel() / ms[k] / 1e3} "
            f"Mbins/s counting padding); plain {plain_s * 1e3} ms once")
    data_t, sched, init, _ = packed["R=132"]
    plain_ms = cuda_ms(lambda: cabac.decode_rows_plain(data_t, sched, init),
                       iters=2, warmup=1)
    log(f"cabac R=132: plain {plain_ms} ms (CUDA events)")
    return launches, err, ms["R=132"], plain_ms


# what the card answers: a window at an unaligned inner offset (x = 37
# int32) moves as two aligned boxes, while one box there faults
ONE_BOX_FAULT = ("OK as two aligned boxes; one box: fault, CUDA error 715 "
                 "(an illegal instruction was encountered)")
WINDOW_OUTCOMES = {
    "fully aligned": "OK", "aligned-shape, odd offset": ONE_BOX_FAULT,
    "rows8, lanes39":
        "rejected at encode (CUresult 1 CUDA_ERROR_INVALID_VALUE)",
    "aligned": "OK", "16x32 odd": ONE_BOX_FAULT}


def phase_probes(dev):
    """The probe path; returns {kernel: (launches, max_abs_err, ms,
    plain_ms)}."""
    import torch
    from hevc_tpu_torch import build, probes
    build.reset_launches()
    res = probes.run_probes(dev, log=log)
    torch.cuda.synchronize()
    counts = {k: build.launches[k] for k in probes.PROBES}
    assert all(v > 0 for v in counts.values()), counts
    assert set(res["tile_shift"].values()) == {0}, res["tile_shift"]
    assert res["tma_window"] == WINDOW_OUTCOMES, res["tma_window"]
    assert res["tma_pipe"] == 0, "tma_pipe_kernel != plain"
    times = probes.time_probes(dev)
    ms, plain_ms = times["tma_pipe"]
    log(f"tma pipe: {ms} ms per launch, {ms / probes.PIPE_BLOCKS * 1e3} "
        f"us/block, {probes.PIPE_BYTES / ms / 1e6} GB/s "
        f"({probes.PIPE_BYTES} B); plain index copy {plain_ms} ms")
    log(f"probe times, ms (kernel, plain): {times}; launch counts {counts}")
    errs = {"tile_shift": max(res["tile_shift"].values()),
            "tma_window": res["tma_window_err"], "tma_pipe": res["tma_pipe"]}
    return {k: (counts[k], errs[k]) + times[k] for k in counts}


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

    from hevc_tpu import native, trace
    from hevc_tpu_torch import build, cli, decoder
    dev = torch.device("cuda", 0)
    assert native.available(), "native stage A failed to build"
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(os.path.relpath(s, ROOT) for s in build.sources())})")

    phase_random_kernels(dev)
    phase_small_reference(dev)

    os.makedirs(CACHE, exist_ok=True)
    if not os.path.exists(STREAM):
        t0 = time.perf_counter()
        synth_stream(STREAM, W, H, QP, FRAMES)
        log(f"generated {os.path.relpath(STREAM, ROOT)} in "
            f"{time.perf_counter() - t0:.1f} s")

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
    real = phase_real_kernels(cap, dev)

    # the counted run: the CLI entry point, launch counts from zero
    seen = []
    orig_finish = decoder.finish_frame

    def finish(pic, lay, poc, device):
        out = orig_finish(pic, lay, poc, device)
        seen.append((out[0].device.type, lay.dpb_dev[poc][0].device.type))
        return out

    decoder.finish_frame = finish
    trace.reset()
    build.reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-i", STREAM, "-v", "40", "--device", "cuda"])
    finally:
        decoder.finish_frame = orig_finish
    wall = time.perf_counter() - t0
    counts = {k: build.launches[k] for k in ("mc", "resid_add")}
    split = trace.report()
    out = buf.getvalue()
    log(out.strip())
    assert rc == 0, f"cli.main returned {rc}"
    assert out.count("Correct MD5") == FRAMES, "not every frame's MD5 ok"
    assert counts["mc"] > 0 and counts["resid_add"] > 0, counts
    assert len(seen) == FRAMES and all(d == ("cuda", "cuda") for d in seen), \
        f"outputs not on the card: {seen}"
    assert "jax" not in sys.modules, "the port imported jax"

    log(f"1080p decode via cli.main: {FRAMES / wall} fps wall "
        f"(incl. MD5 fetch), {out.strip().splitlines()[-1]}")
    log("trace split of the counted run, ms/frame: " + ", ".join(
        f"{k} {v['total_s'] * 1e3 / FRAMES}" for k, v in sorted(split.items())))
    log(f"inline decode, stages synchronised, ms per call: {cap.report()}")
    log(f"launch counts of the counted run: {counts}")

    kernels = []
    for name, line in (("mc", 161), ("resid_add", 356)):
        err, ms, plain_ms = real[name]
        kernels.append({
            "name": f"{name}_kernel", "route": "cuda",
            "source": "hevc_tpu_torch/csrc/mc.cu",
            "replaces": f"hevc_tpu/tpu/mc_pallas.py:{line}",
            "launches": counts[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms})

    n, err, ms, plain_ms = phase_cabac(data, dev)
    kernels.append({
        "name": "cabac_kernel", "route": "cuda",
        "source": "hevc_tpu_torch/csrc/cabac.cu",
        "replaces": "hevc_tpu/tpu/cabac_pallas.py:49", "launches": n,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    for name, (n, err, ms, plain_ms) in phase_probes(dev).items():
        kernels.append({
            "name": f"{name}_kernel", "route": "cuda",
            "source": "hevc_tpu_torch/csrc/probes.cu",
            "replaces": {"tile_shift": "tools/probe_roll.py:34",
                         "tma_window": "tools/probe_dma.py:18",
                         "tma_pipe": "tools/probe_roll.py:79"}[name],
            "launches": n, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms})
    assert "jax" not in sys.modules, "the port imported jax"
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
