"""Probes of the card's copy engines: the Hopper counterparts of the Mosaic
probes ``tools/probe_roll.py`` and ``tools/probe_dma.py``.

- ``tile_shift``: a (48, 256) int32 tile rolled by, or cut at, offsets
  that only the device knows (``dynroll_kern``, ``dynslice_kern``);
- ``tma_window``: one TMA box read from, or written into, a (512, 1408)
  int32 plane at an offset (``try_case``, ``try_write``); the tensor-map
  encoder refuses some box shapes, which is the probe's answer;
- ``tma_pipe``: 2,880 (48, 256) blocks at 8/128-aligned origins read and
  written back through a 4-stage TMA ring (``pipe_kern``).

Each kernel (``csrc/probes.cu``) has a plain PyTorch version here; CPU
tensors take it, CUDA tensors launch the kernel or raise.  Each launch
adds one to ``build.launches[name]``.  A TMA launch takes its tensor map
from ``tensor_map``, which encodes one per plane and box and keeps it
(``build.launches["tma_encode"]`` counts the encodings).

    python -m hevc_tpu_torch.probes

prints what the TPU scripts print, for the card.  A window at an inner
offset that is not 16-byte aligned moves as two aligned boxes; what one
box at that offset does is asked in a child process
(``--one-box CASE``), since a fault poisons the CUDA context of the
process that made it.
"""
from __future__ import annotations

import argparse
import ctypes as C
import functools
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .device import cuda_ms, resolve_device

ROLL, SLICE = 0, 1
TILE = (48, 256)
SHIFT = (3, 37)
SLICE_SHAPE = (40, 128)
PLANE = (512, 1408)
PIPE_PLANE = (1024, 1536)
PIPE_BOX = (48, 256)
PIPE_BLOCKS = 2880
PIPE_RING = 4
# planes larger than the card's 50 MB L2, where device memory bounds a copy:
# an 8K luma plane as the canvas holds it (int32) for the roll, and two
# 8192 x 8192 int32 planes (268 MB each) for the pipe, tiled by PIPE_BOX
TILE_8K = (4320, 7680)
PIPE_BIG_PLANE = (8192, 8192)
PROBES = ("tile_shift", "tma_window", "tma_pipe")
ONE_BOX = "one box: "  # the child's outcome line

_CU_ERRORS = {1: "CUDA_ERROR_INVALID_VALUE"}


class WindowCase(NamedTuple):
    name: str
    write: bool
    shape: tuple
    origin: tuple


# tools/probe_dma.py:81-85
WINDOW_CASES = (
    WindowCase("fully aligned", False, (8, 128), (16, 256)),
    WindowCase("aligned-shape, odd offset", False, (40, 128), (13, 37)),
    WindowCase("rows8, lanes39", False, (40, 39), (13, 37)),
    WindowCase("aligned", True, (8, 128), (16, 256)),
    WindowCase("16x32 odd", True, (16, 32), (13, 37)),
)


class TmaRejected(RuntimeError):
    """cuTensorMapEncodeTiled refused the box; ``code`` is its CUresult."""

    def __init__(self, code: int):
        name = _CU_ERRORS.get(code)
        super().__init__(f"rejected at encode (CUresult {code}"
                         f"{' ' + name if name else ''})")
        self.code = code


# encoded tensor maps (128 bytes each) by ``tensor_map_key``, oldest first
_TENSOR_MAPS: dict = {}
_MAX_TENSOR_MAPS = 64


def clear_tensor_maps() -> None:
    """Forget every encoded tensor map (a count of encodings starts from
    a known state)."""
    _TENSOR_MAPS.clear()


def tensor_map_key(plane, box):
    """What a tensor map encodes: the plane's address and shape and the
    box.  A map outlives the tensor it was made for: another tensor of the
    same shape at the same address takes the same map."""
    return (plane.data_ptr(), *plane.shape, *box)


def tensor_map(plane, box):
    """The TMA tensor map (128 bytes) of the contiguous int32 CUDA
    ``plane`` with ``box``: encoded on first use, then kept, so a second
    launch on the same plane and box encodes nothing.  Raises
    ``TmaRejected`` when the encoder refuses the box; a refusal is not
    kept."""
    if plane.device.type != "cuda":
        raise ValueError(f"tensor_map: the plane lies on {plane.device}")
    key = tensor_map_key(plane, box)
    m = _TENSOR_MAPS.get(key)
    if m is None:
        m, stage = (C.c_ubyte * 128)(), C.c_int(0)
        with torch.cuda.device(plane.device):
            rc = build.load().hevc_tma_encode(m, plane.data_ptr(),
                                              *plane.shape, *box,
                                              C.byref(stage))
        if stage.value == 1:
            raise TmaRejected(rc)
        if stage.value == 3:
            raise RuntimeError("tensor_map: libcuda has no "
                               "cuTensorMapEncodeTiled")
        build.raise_on(rc, "tensor_map")
        build.launches["tma_encode"] += 1
        if len(_TENSOR_MAPS) >= _MAX_TENSOR_MAPS:
            del _TENSOR_MAPS[next(iter(_TENSOR_MAPS))]
        _TENSOR_MAPS[key] = m
    return m


# ---------------------------------------------------------------------------
# tile shift (dynroll_kern / dynslice_kern)
# ---------------------------------------------------------------------------

def tile_shift_plain(x, shift, mode):
    """``x`` rolled by ``shift`` (``ROLL``), or its ``SLICE_SHAPE`` window
    at ``shift`` (``SLICE``) with the start taken as ``jax.lax.dynamic_slice``
    takes it: a negative one counts from the end, then it is clamped so
    that the window fits."""
    sy, sx = (int(v) for v in shift.tolist())
    if mode == ROLL:
        return torch.roll(x, (sy, sx), (0, 1))
    (h, w), (oh, ow) = x.shape, SLICE_SHAPE
    sy, sx = sy + h if sy < 0 else sy, sx + w if sx < 0 else sx
    oy, ox = min(max(sy, 0), h - oh), min(max(sx, 0), w - ow)
    return x[oy:oy + oh, ox:ox + ow].clone()


SHIFT_THREADS = 128  # csrc/probes.cu kShiftThreads


def tile_shift_grid(oh, ow):
    """(CTAs, threads) of ``tile_shift_kernel`` for an (oh, ow) output: a
    thread for each 16-byte segment of the flat output."""
    segs = (oh * ow + 3) // 4
    return (segs + SHIFT_THREADS - 1) // SHIFT_THREADS, SHIFT_THREADS


def tile_shift_sources(h, w, shift, mode, oh, ow):
    """int64 [CTAs * threads, 4]: the flat index into the (h, w) tile that
    each thread of ``tile_shift_kernel`` reads for each of its four output
    elements, -1 past the output's end; the kernel's arithmetic, one thread
    a row of the result (NumPy over the threads)."""
    blocks, threads = tile_shift_grid(oh, ow)
    n = oh * ow
    e0 = 4 * np.arange(blocks * threads, dtype=np.int64)
    sy, sx = (int(v) for v in shift)
    if mode == ROLL:
        oy, ox = -int(np.fmod(sy, h)), -int(np.fmod(sx, w))  # C's %
        oy, ox = oy + (h if oy < 0 else 0), ox + (w if ox < 0 else 0)
    else:
        oy = min(max(sy + h if sy < 0 else sy, 0), h - oh)
        ox = min(max(sx + w if sx < 0 else sx, 0), w - ow)
    y = e0 // ow
    c = e0 - y * ow
    sr, sc = y + oy, c + ox
    sr = np.where(sr >= h, sr - h, sr)
    sc = np.where(sc >= w, sc - w, sc)
    src = np.full((e0.size, 4), -1, np.int64)
    for j in range(4):
        live = e0 + j < n
        src[live, j] = sr[live] * w + sc[live]
        c = c + 1
        row_end = c == ow
        c = np.where(row_end, 0, c)
        sr = np.where(row_end, np.where(sr + 1 == h, 0, sr + 1), sr)
        sc = np.where(row_end, ox, np.where(sc + 1 == w, 0, sc + 1))
    return src


class ShiftParams(C.Structure):
    """``tile_shift_kernel``'s launch for one tile shape and mode (the
    struct of the same name in ``csrc/probes.cu``): the (h, w) tile, the
    (oh, ow) output and ``blocks`` CTAs (``tile_shift_grid``)."""
    _fields_ = [(k, C.c_int) for k in ("h", "w", "mode", "oh", "ow",
                                        "blocks")]


@functools.lru_cache(maxsize=256)
def tile_shift_plan(h, w, mode):
    """The ``ShiftParams`` of a roll (``ROLL``) or ``SLICE_SHAPE`` cut
    (``SLICE``) of an (h, w) tile (kept: a launch passes the address of the
    same struct); raises on what the kernel does not take."""
    if mode not in (ROLL, SLICE):
        raise ValueError(f"tile_shift: mode {mode}")
    oh, ow = (h, w) if mode == ROLL else SLICE_SHAPE
    if not (0 < oh <= h and 0 < ow <= w) or h * w >= 2 ** 31:
        raise ValueError(f"tile_shift: tile {h}x{w}, window {oh}x{ow}")
    return ShiftParams(h, w, mode, oh, ow, tile_shift_grid(oh, ow)[0])


def tile_shift(x, shift, mode):
    """Roll or cut the int32 tile ``x`` by the int32 [2] ``shift`` that
    lies on the same device."""
    dev = x.device
    build.check_tensor("x", x, 2, dev)
    build.check_tensor("shift", shift, 1, dev)
    if shift.numel() != 2:
        raise ValueError(f"tile_shift: shift {tuple(shift.shape)}")
    plan = tile_shift_plan(*x.shape, mode)
    if not x.is_cuda:
        return tile_shift_plain(x, shift, mode)
    out = torch.empty_like(x) if mode == ROLL else x.new_empty(SLICE_SHAPE)
    return launch_tile_shift(x, shift, plan, out)


def launch_tile_shift(x, shift, plan, out):
    """Launch ``tile_shift_kernel`` once with ``plan``
    (``tile_shift_plan``) into ``out``; nothing is checked here:
    ``tile_shift`` does."""
    dev = out.device
    rc = build.launch(dev, build.load().hevc_tile_shift_launch, x.data_ptr(),
                      shift.data_ptr(), out.data_ptr(), C.addressof(plan),
                      build.stream(dev))
    build.launches["tile_shift"] += 1
    build.raise_on(rc, "tile_shift_kernel")
    return out


# ---------------------------------------------------------------------------
# TMA window (try_case / try_write)
# ---------------------------------------------------------------------------

def _check_window(plane, shape, origin):
    (wh, ww), (oy, ox) = shape, origin
    H, W = plane.shape
    if not (0 < wh <= 256 and 0 < ww <= 256 and 0 <= oy <= H - wh
            and 0 <= ox <= W - ww):
        raise ValueError(f"tma_window: window {shape} at {origin} does not "
                         f"lie inside the {H}x{W} plane")


def window_plain(plane, shape, origin, write):
    """Read: the ``shape`` window of ``plane`` at ``origin``.  Write:
    ``plane`` with that window set to 7, in place."""
    _check_window(plane, shape, origin)
    (wh, ww), (oy, ox) = shape, origin
    if write:
        plane[oy:oy + wh, ox:ox + ww] = 7
        return plane
    return plane[oy:oy + wh, ox:ox + ww].clone()


WINDOW_BAND = 4     # rows of a tma_window_kernel CTA
MAX_BOX = 256       # a TMA box's largest extent


class WindowParams(C.Structure):
    """``tma_window_kernel``'s plan for one window (the struct of the same
    name in ``csrc/probes.cu``): the window (wh, ww) at (oy, ox); ``lead``
    columns of the box before the window, so that the box starts at the
    aligned ``ox - lead``; the (bh, bw) box each of the ``bands`` CTAs
    loads."""
    _fields_ = [(k, C.c_int) for k in ("wh", "ww", "oy", "ox", "lead", "bh",
                                        "bw", "bands")]

    @property
    def box(self):
        return self.bh, self.bw

    @property
    def boxes(self):
        """Boxes a CTA moves: two of ww at x0 and x0 + 4 when one of
        ww + 4 would be wider than a box may be."""
        return 2 if self.lead and self.bw == self.ww else 1


@functools.lru_cache(maxsize=256)
def window_plan(shape, origin, split=True, band=WINDOW_BAND):
    """The ``WindowParams`` of the ``shape`` window at ``origin`` (kept:
    a launch passes the address of the same struct).  With ``split``, bands
    of ``band`` rows, each one box from the aligned x0 (of ww + 4 columns
    when the window's inner offset is not 16-byte aligned and that fits in
    a box); without it, one box of the window's shape at the window's own
    offset, aligned or not."""
    (wh, ww), (oy, ox) = shape, origin
    if not split:
        return WindowParams(wh, ww, oy, ox, 0, wh, ww, 1)
    lead, bh = ox & 3, min(wh, band)
    bw = ww + 4 if lead and ww + 4 <= MAX_BOX else ww
    return WindowParams(wh, ww, oy, ox, lead, bh, bw, -(-wh // bh))


def window_boxes(p):
    """What each CTA of ``tma_window_kernel`` does under plan ``p``: a list
    of (box row y, box columns x, first window row the box holds, window
    rows [r0, r1) it reads out), the kernel's arithmetic."""
    x0 = p.ox - p.lead
    xs = (x0, x0 + 4) if p.boxes == 2 else (x0,)
    out = []
    for b in range(p.bands):
        r0 = b * p.bh
        ys = min(r0, p.wh - p.bh)
        out.append((p.oy + ys, xs, ys, r0, min(r0 + p.bh, p.wh)))
    return out


def tma_window(plane, shape, origin, write, split=True):
    """The ``shape`` window of the int32 plane at ``origin`` moved by TMA:
    the window that was read, or the plane after the in-place write.  With
    ``split``, a window whose inner offset is not 16-byte aligned moves in
    boxes at aligned offsets (``window_plan``); without it, as one box at
    its own offset (``one_box_outcome`` asks what that does).  On the card,
    raises ``TmaRejected`` when the tensor-map encoder refuses the
    window's box (``tensor_map``): that box is encoded first, whatever box
    the plan loads."""
    if plane.device.type == "cpu":
        return window_plain(plane, shape, origin, write)
    dev = plane.device
    build.check_tensor("plane", plane, 2, dev)
    _check_window(plane, shape, origin)
    out = plane if write else plane.new_empty(shape)
    plan = window_plan(tuple(shape), tuple(origin), split)
    tensor_map(plane, shape)
    return launch_tma_window(tensor_map(plane, plan.box), plan, write, out)


def launch_tma_window(tmap, plan, write, out):
    """Launch ``tma_window_kernel`` once with plan ``plan``
    (``window_plan``) and the encoded tensor map ``tmap`` of the plane with
    the plan's box (``tensor_map``): the window is read into ``out``, or
    set to 7 in the plane, which ``out`` then is.  Nothing is checked here:
    ``tma_window`` does."""
    dev = out.device
    rc = build.launch(dev, build.load().hevc_tma_window_launch, tmap,
                      C.addressof(plan), int(write), out.data_ptr(),
                      build.stream(dev))
    build.launches["tma_window"] += 1
    build.raise_on(rc, "tma_window_kernel")
    return out


# ---------------------------------------------------------------------------
# TMA pipeline (pipe_kern)
# ---------------------------------------------------------------------------

def pipe_origins(n=PIPE_BLOCKS, seed=0):
    """int32 [n, 2] block origins (y, x), 8- and 128-aligned, as
    ``tools/probe_roll.py:73-76`` draws them."""
    rng = np.random.RandomState(seed)
    by = rng.randint(0, 900, n) & ~7
    bx = rng.randint(0, 1200, n) & ~127
    return torch.from_numpy(np.stack([by, bx], 1).astype(np.int32))


def pipe_tiling(shape):
    """int32 [n, 2] origins (y, x) of the ``PIPE_BOX`` blocks that tile an
    (H, W) plane row by row, as far as whole blocks reach: each byte read
    and written once."""
    (bh, bw), (H, W) = PIPE_BOX, shape
    ys, xs = np.meshgrid(np.arange(0, H - bh + 1, bh),
                         np.arange(0, W - bw + 1, bw), indexing="ij")
    return torch.from_numpy(np.stack([ys.ravel(), xs.ravel()], 1)
                            .astype(np.int32))


def pipe_bytes(origins):
    """Bytes the pipe must move for ``origins``: each block read once and
    written once (overlapping blocks counted once each)."""
    return 2 * origins.shape[0] * PIPE_BOX[0] * PIPE_BOX[1] * 4


def _check_origins(x, origins):
    """Every ``PIPE_BOX`` inside the plane, at an inner offset of a
    multiple of 16 B (a TMA copy at another one faults)."""
    (bh, bw), (H, W), o = PIPE_BOX, x.shape, origins
    if o.dim() != 2 or o.shape[1] != 2:
        raise ValueError(f"tma_pipe: origins {tuple(o.shape)}")
    if o.shape[0] and (int(o.min()) < 0 or int(o[:, 0].max()) > H - bh
                       or int(o[:, 1].max()) > W - bw
                       or bool((o[:, 1] % 4).any())):
        raise ValueError(f"tma_pipe: a {PIPE_BOX} box outside the {H}x{W} "
                         "plane or at an x that is not a multiple of 4")


def pipe_plain(x, origins):
    """Zeros, with every ``PIPE_BOX`` at ``origins`` copied from ``x`` (an
    index copy; overlapping boxes carry equal values).  ``tma_pipe``
    checks the origins."""
    bh, bw = PIPE_BOX
    o = origins.long()
    ys = (o[:, 0, None] + torch.arange(bh, device=x.device))[:, :, None]
    xs = (o[:, 1, None] + torch.arange(bw, device=x.device))[:, None, :]
    out = torch.zeros_like(x)
    out[ys, xs] = x[ys, xs]
    return out


def launch_tma_pipe(x, origins, out):
    """Launch ``tma_pipe_kernel`` once: the ``PIPE_BOX`` blocks of ``x`` at
    ``origins`` into ``out`` (same shape).  The origins are not read here
    (that would wait for the card): ``tma_pipe`` checks them."""
    dev = x.device
    for name, t in (("x", x), ("origins", origins), ("out", out)):
        build.check_tensor(name, t, 2, dev)
    if out.shape != x.shape:
        raise ValueError(f"tma_pipe: out {tuple(out.shape)} != x "
                         f"{tuple(x.shape)}")
    if origins.shape[0] == 0:
        return out
    rc = build.launch(dev, build.load().hevc_tma_pipe_launch,
                      tensor_map(x, PIPE_BOX), tensor_map(out, PIPE_BOX),
                      origins.data_ptr(), origins.shape[0], *PIPE_BOX,
                      build.stream(dev))
    build.launches["tma_pipe"] += 1
    build.raise_on(rc, "tma_pipe_kernel")
    return out


def tma_pipe(x, origins):
    """The blocks of ``x`` at ``origins`` copied into zeros, through the
    4-stage TMA ring of ``tma_pipe_kernel`` on the card."""
    _check_origins(x, origins)
    if x.device.type == "cpu":
        return pipe_plain(x, origins)
    return launch_tma_pipe(x, origins, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# the probe run (python -m hevc_tpu_torch.probes)
# ---------------------------------------------------------------------------

def _one_box(case, dev) -> str:
    """Move ``case`` as one TMA box at its own offset on ``dev``; the
    outcome: "OK", "WRONG DATA", the encoder's refusal or the fault."""
    plane = torch.arange(PLANE[0] * PLANE[1], dtype=torch.int32) \
        .reshape(PLANE)
    try:
        got = tma_window(plane.to(dev), case.shape, case.origin, case.write,
                         split=False)
    except TmaRejected as e:
        return str(e)
    rc = build.load().hevc_stream_sync(
        torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        return f"fault, CUDA error {rc} ({build.error_string(rc)})"
    want = window_plain(plane, case.shape, case.origin, case.write)
    return "OK" if torch.equal(got.cpu(), want) else "WRONG DATA"


def one_box_outcome(index: int) -> str:
    """The outcome of ``WINDOW_CASES[index]`` moved as one TMA box at its
    own offset, from a child process (``--one-box``) on the first card: a
    fault poisons the CUDA context of the process that made it."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-m", "hevc_tpu_torch.probes",
                        "--one-box", str(index)], cwd=root,
                       capture_output=True, text=True, timeout=300)
    got = [ln for ln in r.stdout.splitlines() if ln.startswith(ONE_BOX)]
    if not got:
        raise RuntimeError(f"one-box probe of case {index} printed no "
                           f"outcome (rc {r.returncode}):\n{r.stderr[-3000:]}")
    return got[-1][len(ONE_BOX):]


def ramp(shape, dev):
    """int32 0, 1, 2, ... in a 2-D ``shape`` on ``dev``: the probes' data."""
    return torch.arange(shape[0] * shape[1], dtype=torch.int32,
                        device=dev).reshape(shape)


def run_probes(dev, log=print):
    """Every probe once on ``dev``, each held against its plain version:
    the roll and the slice of the probe's tile and the roll of an 8K plane
    (``TILE_8K``), the window cases, the pipe on the probe's plane and on
    ``PIPE_BIG_PLANE``.  Returns {"tile_shift": {case: max_abs_err},
    "tma_window": {case name: outcome}, "tma_window_err": max_abs_err over
    the cases that moved data, "tma_pipe": max_abs_err over both planes}.
    An outcome is "OK", "WRONG DATA" or the encoder's refusal; for a window
    at an unaligned inner offset it is "OK as two aligned boxes; one box: "
    and what one box at that offset did (``one_box_outcome``)."""
    tile = ramp(TILE, "cpu")
    shift = torch.tensor(SHIFT, dtype=torch.int32)
    res = {"tile_shift": {}, "tma_window": {}, "tma_window_err": 0}
    for mode, name in ((ROLL, "dyn-roll"), (SLICE, "dyn-slice-value")):
        got = tile_shift(tile.to(dev), shift.to(dev), mode).cpu()
        want = tile_shift_plain(tile, shift, mode)
        err = int((got - want).abs().max()) if got.shape == want.shape \
            else -1
        res["tile_shift"][name] = err
        log(f"{name}: {'OK' if err == 0 else 'WRONG'}")
    big, s = ramp(TILE_8K, dev), shift.to(dev)
    err = int((tile_shift(big, s, ROLL)
               - tile_shift_plain(big, s, ROLL)).abs().max())
    res["tile_shift"][f"dyn-roll {TILE_8K[0]}x{TILE_8K[1]}"] = err
    log(f"dyn-roll of a {TILE_8K[0]}x{TILE_8K[1]} plane: "
        f"{'OK' if err == 0 else 'WRONG'}")
    del big
    plane = ramp(PLANE, "cpu")
    src = plane.to(dev)  # one plane for every case: a tensor map per box
    for k, case in enumerate(WINDOW_CASES):
        src.copy_(plane)
        try:
            got = tma_window(src, case.shape, case.origin, case.write).cpu()
            want = window_plain(plane.clone(), case.shape, case.origin,
                                case.write)
            err = int((got - want).abs().max())
            res["tma_window_err"] = max(res["tma_window_err"], err)
            outcome = "OK" if err == 0 else "WRONG DATA"
        except TmaRejected as e:
            outcome = str(e)
        p = window_plan(case.shape, case.origin)
        if p.lead and outcome == "OK":
            log(f"  inner offset {4 * case.origin[1]} B is not 16-byte "
                f"aligned: {p.bands} bands of {p.boxes} ({p.bh}, {p.bw}) "
                f"box(es) at x={list(window_boxes(p)[0][1])}")
            outcome += f" as two aligned boxes; one box: {one_box_outcome(k)}"
        res["tma_window"][case.name] = outcome
        log(f"{'WRITE' if case.write else 'READ '} {case.name}: "
            f"shape={case.shape} off={case.origin} -> {outcome}")
    x = ramp(PIPE_PLANE, "cpu")
    org = pipe_origins()
    got = tma_pipe(x.to(dev), org.to(dev)).cpu()
    err = int((got - pipe_plain(x, org)).abs().max())
    x, org = ramp(PIPE_BIG_PLANE, dev), pipe_tiling(PIPE_BIG_PLANE).to(dev)
    err_big = int((tma_pipe(x, org) - pipe_plain(x, org)).abs().max())
    res["tma_pipe"] = max(err, err_big)
    log(f"tma-pipeline({PIPE_BLOCKS} blocks rd+wr {PIPE_BOX[0]}x"
        f"{PIPE_BOX[1]}, ring {PIPE_RING}): {'OK' if err == 0 else 'WRONG'}; "
        f"{org.shape[0]} blocks tiling {PIPE_BIG_PLANE[0]}x"
        f"{PIPE_BIG_PLANE[1]}: {'OK' if err_big == 0 else 'WRONG'}")
    return res


def host_us(fn, calls=1000):
    """Host time in us per call of fn(): ``calls`` calls without a sync,
    timed by ``time.perf_counter``, then one sync (not timed)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def time_probes(dev):
    """Times of each probe on the card.  Returns (ms, host): ms[case] =
    (kernel ms, plain ms) by CUDA events, host[case] = us a call on the
    host (``host_us``).  Cases: ``tile_shift`` the entry point's roll of
    the probe's tile, ``tile_shift_8k`` that of ``TILE_8K``;
    ``tma_window`` the bare launch of the (40, 128) odd-offset window read
    (the plan and its tensor map in hand, ``launch_tma_window``),
    ``tma_window_call`` the entry point with its checks, its look-up of the
    maps and its allocation; ``tma_pipe`` the pipe on the probe's plane,
    ``tma_pipe_big`` on ``PIPE_BIG_PLANE``, each timed without the origins'
    check, which reads them back and so waits for the card (its plain
    index copy too).  The host column also holds the library calls:
    ``torch.roll`` of the probe's tile and slice + clone of the window."""
    tile, shift = ramp(TILE, dev), torch.tensor(SHIFT, dtype=torch.int32,
                                                   device=dev)
    big = ramp(TILE_8K, dev)
    plane = ramp(PLANE, dev)
    case = WINDOW_CASES[1]
    (wh, ww), (oy, ox) = case.shape, case.origin
    plan = window_plan(case.shape, case.origin)
    tmap = tensor_map(plane, plan.box)
    wout = torch.empty(case.shape, dtype=torch.int32, device=dev)
    x, org = ramp(PIPE_PLANE, dev), pipe_origins().to(dev)
    out = torch.zeros_like(x)
    calls = {
        "tile_shift": lambda: tile_shift(tile, shift, ROLL),
        "tile_shift_8k": lambda: tile_shift(big, shift, ROLL),
        "tma_window": lambda: launch_tma_window(tmap, plan, False, wout),
        "tma_window_call": lambda: tma_window(plane, case.shape,
                                              case.origin, False),
        "tma_pipe": lambda: launch_tma_pipe(x, org, out)}
    ms = {k: cuda_ms(fn) for k, fn in calls.items()}
    host = {k: host_us(fn) for k, fn in calls.items()
            if k not in ("tile_shift_8k", "tma_pipe")}
    host["torch.roll"] = host_us(lambda: torch.roll(tile, SHIFT, (0, 1)))
    host["slice + clone"] = host_us(
        lambda: plane[oy:oy + wh, ox:ox + ww].clone())
    plain = {"tile_shift": cuda_ms(lambda: tile_shift_plain(tile, shift,
                                                            ROLL)),
             "tile_shift_8k": cuda_ms(lambda: tile_shift_plain(big, shift,
                                                               ROLL)),
             "tma_pipe": cuda_ms(lambda: pipe_plain(x, org), iters=5)}
    plain["tma_window"] = plain["tma_window_call"] = cuda_ms(
        lambda: window_plain(plane, case.shape, case.origin, False))
    del big, x, out
    x = ramp(PIPE_BIG_PLANE, dev)
    org, out = pipe_tiling(PIPE_BIG_PLANE).to(dev), torch.zeros_like(x)
    ms["tma_pipe_big"] = cuda_ms(lambda: launch_tma_pipe(x, org, out))
    plain["tma_pipe_big"] = cuda_ms(lambda: pipe_plain(x, org), iters=3,
                                    warmup=1)
    return {k: (v, plain[k]) for k, v in ms.items()}, host


# int32 buffer sizes (bytes) whose copy, source and destination together,
# fits the card's 50 MB L2 (on an H100 the rate rose up to 12 MB, as each
# copy's fixed cost shrinks against its bytes, and fell beyond, as the
# pair outgrows what L2 keeps); and one far larger, for device memory
L2_BUFFERS = (4 << 20, 8 << 20, 12 << 20, 16 << 20, 20 << 20)
HBM_BUFFER = 512 << 20


def copy_rates(dev, reps=50):
    """{buffer bytes: bytes a second} of ``dst.copy_(src)`` on the card:
    ``reps`` copies captured in one CUDA graph (one launch for all) and
    replayed, timed by CUDA events; each copy reads and writes the buffer
    once.  The largest rate over ``L2_BUFFERS`` is the L2's rate as a copy
    reaches it, the rate of ``tma_pipe``'s bound on ``PIPE_PLANE`` (a
    kernel may move data faster: it is not the L2's peak);
    ``HBM_BUFFER`` checks the method against device memory's."""
    out = {}
    for n in L2_BUFFERS + (HBM_BUFFER,):
        src = torch.arange(n // 4, dtype=torch.int32, device=dev)
        dst = torch.empty_like(src)
        dst.copy_(src)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                dst.copy_(src)
        ms = cuda_ms(graph.replay, iters=10, warmup=2) / reps
        if not torch.equal(dst, src):
            raise RuntimeError("copy_rates: the copy is wrong")
        out[n] = 2 * n / (ms * 1e-3)
        del graph, src, dst
    return out


def time_window_plans(dev, bands=(40, 20, 16, 8, 4, 2)):
    """{plan: (events ms, device ms)} of ``tma_window_kernel`` on the
    (40, 128) odd-offset read under each band height, with one box of
    ww + 4 columns a band and with two boxes of ww (the plan of a window
    too wide for one), each held against slice + clone first; and
    slice + clone itself."""
    from .device import profiler_ms
    plane = ramp(PLANE, dev)
    case = WINDOW_CASES[1]
    (wh, ww), (oy, ox) = case.shape, case.origin
    want = plane[oy:oy + wh, ox:ox + ww].clone()
    out = torch.empty_like(want)
    res = {}
    for band in bands:
        p = window_plan(case.shape, case.origin, True, band)
        for plan in (p, WindowParams(*(getattr(p, f) for f, _ in
                                       WindowParams._fields_[:6]), p.ww,
                                     p.bands)):
            tmap = tensor_map(plane, plan.box)
            fn = functools.partial(launch_tma_window, tmap, plan, False, out)
            fn()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"tma_window_kernel: plan {plan.box} x "
                                   f"{plan.boxes} != slice")
            res[f"bands of {plan.bh}, {plan.boxes} box(es) of {plan.box}"] \
                = (cuda_ms(fn), profiler_ms(fn, "tma_window_kernel"))
    lib = lambda: plane[oy:oy + wh, ox:ox + ww].clone()  # noqa: E731
    res["slice + clone"] = (cuda_ms(lib), profiler_ms(lib))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hevc_tpu_torch.probes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one-box", type=int, metavar="CASE",
                    help="move WINDOW_CASES[CASE] as one TMA box at its own "
                    "offset and print the outcome (what one_box_outcome "
                    "runs in a child process)")
    ap.add_argument("--plans", action="store_true",
                    help="only time tma_window_kernel under each plan of "
                    "the (40, 128) odd-offset read (time_window_plans)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        print("the probes describe the card: run them with --device cuda",
              file=sys.stderr)
        return 2
    if args.one_box is not None:
        print(ONE_BOX + _one_box(WINDOW_CASES[args.one_box], dev), flush=True)
        return 0
    if args.plans:
        card = card_label()
        for k, (ev, device) in time_window_plans(dev).items():
            print(f"{k}: {ev:.5f} ms by events, {device:.6f} ms on the "
                  f"device ({card})")
        return 0
    run_probes(dev)
    times, host = time_probes(dev)
    card = card_label()
    for k, (ms, plain) in times.items():
        print(f"{k}: {ms:.5f} ms a launch, plain {plain:.5f} ms (CUDA "
              f"events; {card})")
    for k, pipe in (("tma_pipe", pipe_origins()),
                    ("tma_pipe_big", pipe_tiling(PIPE_BIG_PLANE))):
        ms = times[k][0]
        print(f"{k}: {ms / pipe.shape[0] * 1e3:.4f} us/block, "
              f"{pipe_bytes(pipe) / ms / 1e6:.1f} GB/s ({card})")
    print(f"host us a call: {host} ({card})")
    rates = copy_rates(dev)
    l2 = max(rates[n] for n in L2_BUFFERS)
    pipe = pipe_origins()
    print(f"copy rates, GB/s by buffer bytes: "
          f"{ {n: r / 1e9 for n, r in rates.items()} }; tma_pipe on "
          f"{PIPE_PLANE}: L2 bound {pipe_bytes(pipe) / l2 * 1e3:.5f} ms "
          f"against {times['tma_pipe'][0]:.5f} ms ({card})")
    return 0


def card_label() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives
    them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

if __name__ == "__main__":
    sys.exit(main())
