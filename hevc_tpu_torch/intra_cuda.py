"""Wrapper of the intra wavefront kernel in ``csrc/intra.cu``.

``reconstruct_wavefront`` takes the plain version's arguments
(``intra.reconstruct_wavefront``).  For tensors on the CPU it runs that
plain version; for CUDA tensors it checks every tensor, launches
``intra_chunk_kernel`` once per live chunk from one C call and raises on
any refusal: it never falls back.  The live chunks come from the host's
``counts`` (``intra.chunk_counts`` of the pack's host buffers), so the
call never waits on the card.  Each launch adds one to
``build.launches["intra"]`` and to the ``intra_launches`` counter.  The
kernel writes the canvas in place and returns it; its angle tables are
constants of the kernel, so ``tables`` is read only by the plain version.
"""
from __future__ import annotations

import ctypes as C

import numpy as np
import torch

from . import build, intra, trace


class IntraParams(C.Structure):
    """``IntraParams`` of ``csrc/intra.cu``, field for field."""
    _fields_ = [("scal", C.c_void_p * 4), ("avail", C.c_void_p * 4),
                ("resid", C.c_void_p * 4), ("B", C.c_int * 4),
                ("npool", C.c_int * 4), ("ch", C.c_int), ("cw", C.c_int),
                ("bd", C.c_int)]


def chunk_table(counts) -> np.ndarray:
    """Host counts (``intra.chunk_counts``: per class, the live records of
    each chunk) -> the launcher's int32 [n_chunks, 4] table."""
    if len(counts) != 4:
        raise ValueError("intra: counts of four classes")
    cols = [np.asarray(c).reshape(-1) for c in counts]
    if len({c.shape[0] for c in cols}) != 1:
        raise ValueError(f"intra: counts of {[c.shape[0] for c in cols]} "
                         "chunks")
    return np.ascontiguousarray(np.stack(cols, axis=1), dtype=np.int32)


def live_chunks(counts) -> int:
    """The chunks that hold a record: one launch each."""
    return int((chunk_table(counts) > 0).any(axis=1).sum())


def intra_params(canvas, scal, avail, resids, bd) -> IntraParams:
    """The launch's ``IntraParams``, after checking each tensor's device,
    type, shape and contiguity against the kernel's layout."""
    dev = canvas.device
    build.check_tensor("canvas", canvas, 2, dev)
    if len(scal) != 4 or len(avail) != 4 or len(resids) != 4:
        raise ValueError("intra: four classes of records, masks and pools")
    if not 5 <= bd <= 16:
        raise ValueError(f"intra: bit depth {bd}")
    p = IntraParams()
    p.ch, p.cw = canvas.shape
    p.bd = bd
    n_chunks = scal[0].shape[0] if scal[0].dim() == 3 else -1
    for c, n in enumerate(intra.SIZES):
        s, a, r = scal[c], avail[c], resids[c]
        build.check_tensor(f"scal[{c}]", s, 3, dev)
        build.check_tensor(f"resids[{c}]", r, 3, dev)
        if (a.device != dev or a.dtype not in (torch.bool, torch.uint8)
                or a.dim() != 3 or not a.is_contiguous()):
            raise ValueError(f"avail[{c}]: expected a contiguous bool 3-D "
                             f"tensor on {dev}, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
        B = s.shape[1]
        if (s.shape != (n_chunks, B, 8) or a.shape != (n_chunks, B, 128)
                or r.shape[1:] != (n, n) or r.shape[0] < 1):
            raise ValueError(f"intra: class {c} records {tuple(s.shape)}, "
                             f"masks {tuple(a.shape)}, pool "
                             f"{tuple(r.shape)}")
        p.scal[c], p.avail[c], p.resid[c] = (s.data_ptr(), a.data_ptr(),
                                             r.data_ptr())
        p.B[c], p.npool[c] = B, r.shape[0]
    return p


def launch_intra(canvas, params: IntraParams, table: np.ndarray):
    """Launch ``intra_chunk_kernel`` once per live chunk of ``table``
    (``chunk_table``), in order, on the canvas's current stream."""
    dev = canvas.device
    lib = build.load()
    done = C.c_int(0)
    rc = build.launch(dev, lib.hevc_intra_launch, canvas.data_ptr(),
                      C.byref(params), table.ctypes.data, table.shape[0],
                      build.stream(dev), C.byref(done))
    build.launches["intra"] += done.value
    trace.count("intra_launches", done.value)
    build.raise_on(rc, "intra_chunk_kernel")
    return canvas


def reconstruct_wavefront(canvas, scal, avail, resids, bd, tables,
                          counts=None):
    """The intra wavefront of one picture (``intra.reconstruct_wavefront``'s
    arguments and result): the plain version on the CPU; on the card the
    kernel, in place, which needs the host's ``counts``."""
    if canvas.device.type == "cpu":
        return intra.reconstruct_wavefront(canvas, scal, avail, resids, bd,
                                           tables, counts)
    if counts is None:
        raise ValueError("intra: the kernel takes the host's chunk counts "
                         "(intra.chunk_counts of the pack's buffers)")
    table = chunk_table(counts)
    params = intra_params(canvas, scal, avail, resids, bd)
    if table.shape[0] != scal[0].shape[0]:
        raise ValueError(f"intra: counts of {table.shape[0]} chunks for "
                         f"records of {scal[0].shape[0]}")
    return launch_intra(canvas, params, table)


def launch_floor_ms(dev, n: int = 500, spin_ns: int = 20_000_000):
    """(device ms, host-issued ms) between two back-to-back empty launches
    on ``dev``'s current stream: ``n`` launches queued behind a kernel
    that holds the stream ``spin_ns`` (the card's pace), then ``n`` as the
    host issues them.  The first is the chain bound's step."""
    lib = build.load()
    out = []
    for spin in (spin_ns, 0):
        ms = C.c_float(0)
        rc = build.launch(dev, lib.hevc_launch_floor, build.stream(dev), n,
                          spin, C.byref(ms))
        build.raise_on(rc, "launch floor")
        out.append(ms.value / n)
    return tuple(out)
