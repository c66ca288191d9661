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
import os
import subprocess
import sys
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
PIPE_BYTES = 2 * PIPE_BLOCKS * PIPE_BOX[0] * PIPE_BOX[1] * 4  # read + write
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


def tile_shift(x, shift, mode):
    """Roll or cut the int32 tile ``x`` by the int32 [2] ``shift`` that
    lies on the same device."""
    if mode not in (ROLL, SLICE):
        raise ValueError(f"tile_shift: mode {mode}")
    if x.device.type == "cpu":
        return tile_shift_plain(x, shift, mode)
    dev = x.device
    build.check_tensor("x", x, 2, dev)
    build.check_tensor("shift", shift, 1, dev)
    h, w = x.shape
    oh, ow = (h, w) if mode == ROLL else SLICE_SHAPE
    if shift.numel() != 2 or not (0 < oh <= h and 0 < ow <= w) \
            or h * w * 4 > 227 * 1024:
        raise ValueError(f"tile_shift: tile {h}x{w}, window {oh}x{ow}")
    out = torch.empty((oh, ow), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = build.load().hevc_tile_shift_launch(
            x.data_ptr(), h, w, shift.data_ptr(), mode, oh, ow,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
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


def tma_window(plane, shape, origin, write, split=True):
    """The ``shape`` window of the int32 plane at ``origin`` moved by TMA:
    the window that was read, or the plane after the in-place write.  With
    ``split``, a window whose inner offset is not 16-byte aligned moves as
    two boxes at aligned offsets; without it, as one box at its own offset
    (``one_box_outcome`` asks what that does).  On the card,
    raises ``TmaRejected`` when the tensor-map encoder refuses the box
    (``tensor_map``)."""
    if plane.device.type == "cpu":
        return window_plain(plane, shape, origin, write)
    dev = plane.device
    build.check_tensor("plane", plane, 2, dev)
    _check_window(plane, shape, origin)
    out = (plane if write else
           torch.empty(shape, dtype=torch.int32, device=dev))
    return launch_tma_window(tensor_map(plane, shape), shape, origin, split,
                             write, out)


def launch_tma_window(tmap, shape, origin, split, write, out):
    """Launch ``tma_window_kernel`` once with the encoded tensor map
    ``tmap`` of the plane and ``shape`` (``tensor_map``): the window at
    ``origin`` is read into ``out``, or set to 7 in the plane, which
    ``out`` then is.  Nothing is checked here: ``tma_window`` does."""
    dev = out.device
    with torch.cuda.device(dev):
        rc = build.load().hevc_tma_window_launch(
            tmap, *shape, *origin, int(split), int(write), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
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
    with torch.cuda.device(dev):
        rc = build.load().hevc_tma_pipe_launch(
            tensor_map(x, PIPE_BOX), tensor_map(out, PIPE_BOX),
            origins.data_ptr(), origins.shape[0], *PIPE_BOX,
            torch.cuda.current_stream(dev).cuda_stream)
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


def run_probes(dev, log=print):
    """Every probe once on ``dev``, each held against its plain version on
    the CPU.  Returns {"tile_shift": {mode: max_abs_err}, "tma_window":
    {case name: outcome}, "tma_window_err": max_abs_err over the cases
    that moved data, "tma_pipe": max_abs_err}.  An outcome is "OK",
    "WRONG DATA" or the encoder's refusal; for a window at an unaligned
    inner offset it is "OK as two aligned boxes; one box: " and what one
    box at that offset did (``one_box_outcome``)."""
    tile = torch.arange(TILE[0] * TILE[1], dtype=torch.int32).reshape(TILE)
    shift = torch.tensor(SHIFT, dtype=torch.int32)
    res = {"tile_shift": {}, "tma_window": {}, "tma_window_err": 0}
    for mode, name in ((ROLL, "dyn-roll"), (SLICE, "dyn-slice-value")):
        got = tile_shift(tile.to(dev), shift.to(dev), mode).cpu()
        want = tile_shift_plain(tile, shift, mode)
        err = int((got - want).abs().max()) if got.shape == want.shape \
            else -1
        res["tile_shift"][name] = err
        log(f"{name}: {'OK' if err == 0 else 'WRONG'}")
    plane = torch.arange(PLANE[0] * PLANE[1], dtype=torch.int32) \
        .reshape(PLANE)
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
        (_, ww), (_, ox) = case.shape, case.origin
        if ox & 3 and outcome == "OK":
            log(f"  inner offset {4 * ox} B is not 16-byte aligned: boxes at "
                f"x={ox & ~3} and {(ox & ~3) + ww}")
            outcome += f" as two aligned boxes; one box: {one_box_outcome(k)}"
        res["tma_window"][case.name] = outcome
        log(f"{'WRITE' if case.write else 'READ '} {case.name}: "
            f"shape={case.shape} off={case.origin} -> {outcome}")
    x = torch.arange(PIPE_PLANE[0] * PIPE_PLANE[1], dtype=torch.int32) \
        .reshape(PIPE_PLANE)
    org = pipe_origins()
    got = tma_pipe(x.to(dev), org.to(dev)).cpu()
    err = int((got - pipe_plain(x, org)).abs().max())
    res["tma_pipe"] = err
    log(f"tma-pipeline({PIPE_BLOCKS} blocks rd+wr {PIPE_BOX[0]}x"
        f"{PIPE_BOX[1]}, ring {PIPE_RING}): {'OK' if err == 0 else 'WRONG'}")
    return res


def time_probes(dev):
    """(kernel ms, plain ms) of each probe on the card, at the probes'
    shapes: the roll, the (40, 128) odd-offset window read and the pipe.
    The window is timed twice: ``tma_window`` is the bare launch into a
    buffer with the tensor map in hand (``launch_tma_window``),
    ``tma_window_call`` the entry point with its checks, its look-up of
    the map and its allocation.  The pipe's launch and its plain index
    copy are timed without the origins' check, which reads them back and
    so waits for the card."""
    tile = torch.arange(TILE[0] * TILE[1], dtype=torch.int32,
                        device=dev).reshape(TILE)
    shift = torch.tensor(SHIFT, dtype=torch.int32, device=dev)
    plane = torch.arange(PLANE[0] * PLANE[1], dtype=torch.int32,
                         device=dev).reshape(PLANE)
    x = torch.arange(PIPE_PLANE[0] * PIPE_PLANE[1], dtype=torch.int32,
                     device=dev).reshape(PIPE_PLANE)
    org = pipe_origins().to(dev)
    out = torch.zeros_like(x)
    case = WINDOW_CASES[1]
    tmap = tensor_map(plane, case.shape)
    wout = torch.empty(case.shape, dtype=torch.int32, device=dev)
    plain_ms = cuda_ms(lambda: window_plain(plane, case.shape, case.origin,
                                            False))
    return {
        "tile_shift": (cuda_ms(lambda: tile_shift(tile, shift, ROLL)),
                       cuda_ms(lambda: tile_shift_plain(tile, shift, ROLL))),
        "tma_window": (
            cuda_ms(lambda: launch_tma_window(tmap, case.shape, case.origin,
                                              True, False, wout)), plain_ms),
        "tma_window_call": (
            cuda_ms(lambda: tma_window(plane, case.shape, case.origin,
                                       False)), plain_ms),
        "tma_pipe": (cuda_ms(lambda: launch_tma_pipe(x, org, out)),
                     cuda_ms(lambda: pipe_plain(x, org), iters=5)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hevc_tpu_torch.probes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--one-box", type=int, metavar="CASE",
                    help="move WINDOW_CASES[CASE] as one TMA box at its own "
                    "offset and print the outcome (what one_box_outcome "
                    "runs in a child process)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        print("the probes describe the card: run them with --device cuda",
              file=sys.stderr)
        return 2
    if args.one_box is not None:
        print(ONE_BOX + _one_box(WINDOW_CASES[args.one_box], dev), flush=True)
        return 0
    run_probes(dev)
    times = time_probes(dev)
    ms, plain = times["tma_pipe"]
    print(f"tma-pipeline: {ms:.4f} ms ({ms / PIPE_BLOCKS * 1e3:.4f} us/block, "
          f"{PIPE_BYTES / ms / 1e6:.1f} GB/s); plain index copy {plain:.4f} "
          "ms")
    for k in ("tile_shift", "tma_window", "tma_window_call"):
        print(f"{k}: {times[k][0]:.4f} ms per launch, plain {times[k][1]:.4f}"
              " ms")
    print(f"card: {torch.cuda.get_device_name(dev)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
