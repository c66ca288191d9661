"""Wrapper of the Hopper CABAC kernel in ``csrc/cabac.cu``.

``cabac.rows.decode_rows`` calls it for CUDA tensors, after
``cabac.rows.check_rows`` has checked them; CPU tensors take the plain
version there.  Each launch adds one to ``build.launches["cabac"]``;
nothing else touches the count.
"""
from __future__ import annotations

import torch

from . import build
from .cabac.rows import cabac_tables


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
            cabac_tables(dev).data_ptr(), R, bins.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.launches["cabac"] += 1
    build.raise_on(rc, "cabac_kernel")
    return bins
