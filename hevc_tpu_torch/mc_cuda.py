"""Wrappers of the two Hopper kernels in ``csrc/mc.cu``.

For tensors on the CPU the wrappers run the plain versions in ``mc.py``;
for CUDA tensors they launch the kernel or raise.  Each launch of a kernel
adds one to ``build.launches[name]``; nothing else touches the counts.
"""
from __future__ import annotations

import numpy as np
import torch

from . import build
from .mc import MC_COLS, mc_plain, resid_add_plain
from .tables import tables_from_reference

def mc_rows(groups, device):
    """Groups -> the kernel's int32 [N, 22] row table: (is_ch, bi, wp, w,
    h) followed by the 17 production columns."""
    hdr, body = [], []
    for is_ch, bi, wp, _kind, w, h, rows in groups:
        if not (1 <= w <= 64 and 1 <= h <= 64):
            raise ValueError(f"mc: block {w}x{h} outside 1..64")
        if rows.shape[0]:
            hdr.append(np.repeat(np.array([[is_ch, bi, wp, w, h]], np.int32),
                                 rows.shape[0], axis=0))
            body.append(rows.to(device=device, dtype=torch.int32))
    if not body:
        return torch.zeros((0, 5 + MC_COLS), dtype=torch.int32,
                           device=device)
    head = torch.from_numpy(np.concatenate(hdr)).to(device)
    return torch.cat([head, torch.cat(body)], dim=1).contiguous()


def launch_mc(canvas, refs_l, refs_c, rows, bd):
    """Launch ``mc_kernel`` once over the row table of ``mc_rows``."""
    dev = canvas.device
    for name, t, dim in (("canvas", canvas, 2), ("refs_l", refs_l, 3),
                         ("refs_c", refs_c, 3), ("rows", rows, 2)):
        build.check_tensor(name, t, dim, dev)
    if rows.shape[1] != 5 + MC_COLS:
        raise ValueError(f"mc: row table {tuple(rows.shape)}")
    n = rows.shape[0]
    if n == 0:
        return canvas
    tables = tables_from_reference(dev)
    lib = build.load()
    with torch.cuda.device(dev):
        rc = lib.hevc_mc_launch(
            canvas.data_ptr(), *canvas.shape,
            refs_l.data_ptr(), *refs_l.shape,
            refs_c.data_ptr(), *refs_c.shape, rows.data_ptr(), n,
            tables["qpel"].data_ptr(), tables["epel"].data_ptr(), bd,
            torch.cuda.current_stream(dev).cuda_stream)
    build.launches["mc"] += 1
    build.raise_on(rc, "mc_kernel")
    return canvas


def mc(canvas, refs_l, refs_c, groups, bd):
    """Motion compensation of every PU row in ``groups`` (the layout of
    ``pipeline._mc_tile_phase``), in place on the int32 canvas: one kernel
    launch for the whole frame."""
    if canvas.device.type == "cpu":
        return mc_plain(canvas, refs_l, refs_c, groups, bd,
                        tables_from_reference(canvas.device))
    return launch_mc(canvas, refs_l, refs_c, mc_rows(groups, canvas.device),
                     bd)


def launch_resid_add(canvas, rows, pool, bd):
    """Launch ``resid_add_kernel`` once for one size class: rows int32
    [N, 3] = (cy, cx, slot) into pool int32 [Np, s, s]."""
    dev = canvas.device
    for name, t, dim in (("canvas", canvas, 2), ("rows", rows, 2),
                         ("pool", pool, 3)):
        build.check_tensor(name, t, dim, dev)
    s = pool.shape[-1]
    if s not in (4, 8, 16, 32) or pool.shape[1] != s or rows.shape[1] != 3:
        raise ValueError(f"resid_add: rows {tuple(rows.shape)}, pool "
                         f"{tuple(pool.shape)}")
    n = rows.shape[0]
    if n == 0:
        return canvas
    lib = build.load()
    with torch.cuda.device(dev):
        rc = lib.hevc_resid_add_launch(
            canvas.data_ptr(), *canvas.shape, pool.data_ptr(),
            pool.shape[0], rows.data_ptr(), n, s, bd,
            torch.cuda.current_stream(dev).cuda_stream)
    build.launches["resid_add"] += 1
    build.raise_on(rc, "resid_add_kernel")
    return canvas


def resid_add(canvas, fields, pools, bd):
    """Inter residual add (the layout of ``mc.resid_phase``): per size
    class, rows (cy, cx, slot) add ``pools[c][slot]`` to the canvas and
    clip, in place on the int32 canvas; one launch per non-empty class."""
    if canvas.device.type == "cpu":
        return resid_add_plain(canvas, fields, pools, bd)
    for c, f in enumerate(fields):
        if f.shape[0]:
            launch_resid_add(canvas, f.to(torch.int32).contiguous(),
                             pools[c].contiguous(), bd)
    return canvas
