"""Wrapper of the Hopper CABAC kernel in ``csrc/cabac.cu``.

``cabac.rows.decode_rows`` calls it for CUDA tensors, after
``cabac.rows.check_rows`` has checked them; CPU tensors take the plain
version there.  Each launch adds one to ``build.launches["cabac"]``;
nothing else touches the count.  ``chain_latencies`` and ``resident_rows``
measure what ``cabac.rows.chain_bound`` needs of the card.
"""
from __future__ import annotations

import ctypes as C

import torch

from . import build
from .cabac.rows import cabac_step_table


def launch_cabac(data, sched, init, n_bins):
    """Launch ``cabac_kernel`` once: R rows of the first ``n_bins`` bins of
    ``sched``.  int32 data [R, n_bytes], sched [R, >= n_bins], init
    [R, n_ctx] on one card, as ``cabac.rows.check_rows`` accepts them, and
    contiguous; returns bins int32 [R, n_bins]."""
    for name, t in (("data", data), ("sched", sched), ("init", init)):
        if not t.is_contiguous():
            raise ValueError(f"cabac_kernel: {name} is not contiguous")
    dev = data.device
    R = data.shape[0]
    bins = torch.empty((R, n_bins), dtype=torch.int32, device=dev)
    if R == 0 or n_bins == 0:
        return bins
    lib = build.load()
    with torch.cuda.device(dev):
        rc = lib.hevc_cabac_launch(
            data.data_ptr(), data.shape[1], sched.data_ptr(), sched.shape[1],
            n_bins, init.data_ptr(), init.shape[1],
            cabac_step_table(dev).data_ptr(), R, bins.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.launches["cabac"] += 1
    build.raise_on(rc, "cabac_kernel")
    return bins


def resident_rows(dev) -> int:
    """Rows ``cabac_kernel`` decodes at once on ``dev``: the one-warp
    blocks the card holds; more rows are walked grid-stride."""
    n = C.c_int(0)
    with torch.cuda.device(dev):
        rc = build.load().hevc_cabac_resident_rows(C.byref(n))
    build.raise_on(rc, "cabac_kernel")
    return n.value


def chain_latencies(dev, iters: int = 4096):
    """(SM clocks of one shared-memory round trip, SM clocks of one
    dependent 32-bit ALU instruction) on ``dev``, from
    ``chain_latency_kernel``: one thread chasing a pointer through shared
    memory, then running a chain of multiply-adds, each ``iters`` long and
    timed with the SM's clock counter; the second of two runs."""
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        for _ in range(2):
            rc = build.load().hevc_chain_latency_launch(
                iters, 3, 1, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
            build.raise_on(rc, "chain_latency_kernel")
    smem, alu, _ = out.tolist()
    return smem / iters, alu / iters
