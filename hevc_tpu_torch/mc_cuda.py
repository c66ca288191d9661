"""Wrappers of the two Hopper kernels in ``csrc/mc.cu``.

For tensors on the CPU the wrappers run the plain versions in ``mc.py``;
for CUDA tensors they launch the kernel or raise.  Each launch of a kernel
adds one to ``build.launches[name]``; nothing else touches the counts.

Both kernels run once per picture.  MC takes one row table that the host
builds from the picture's groups (``mc_table``), int16 as the pack writes
the rows; the residual add takes the four class tables and pools as
pointers in one parameter struct.
"""
from __future__ import annotations

import ctypes as C
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .mc import C_CX, C_CY, MC_COLS, mc_plain, resid_add_plain
from .tables import tables_from_reference, upload

SUB = 16          # a PU is filtered in sub-blocks of at most SUB x SUB
MAX_GROUPS = 256  # group table of one launch (McParams in csrc/mc.cu)


class McParams(C.Structure):
    """``McParams`` of ``csrc/mc.cu``, field for field."""
    _fields_ = [(n, C.c_int) for n in (
        "ch", "cw", "nl", "hl", "wl", "nc", "hc", "wc", "bd", "vec_l",
        "vec_c", "vec_out", "win_stride", "warp_smem", "ngroups")] + [
        ("code", C.c_int * MAX_GROUPS),
        ("row_start", C.c_int * (MAX_GROUPS + 1)),
        ("unit_start", C.c_int * (MAX_GROUPS + 1))]


class ResidParams(C.Structure):
    """``ResidParams`` of ``csrc/mc.cu``, field for field."""
    _fields_ = [("rows", C.c_void_p * 4), ("pool", C.c_void_p * 4),
                ("n", C.c_int * 4), ("npool", C.c_int * 4),
                ("seg_start", C.c_int * 5), ("vec_pool", C.c_int * 4),
                ("ch", C.c_int), ("cw", C.c_int), ("bd", C.c_int),
                ("vec_out", C.c_int)]


class McTable(NamedTuple):
    """One picture's MC rows, ordered by block class: ``rows`` int16
    [N, 17] and ``groups`` ((is_ch, bi, wp, w, h, start, count), ...),
    group g holding ``rows[start:start + count]``."""
    rows: np.ndarray
    groups: tuple


def _host_rows(rows):
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return np.asarray(rows).reshape(-1, MC_COLS)


def mc_table(groups, canvas_shape) -> McTable:
    """Groups (the layout of ``pipeline._mc_tile_phase``: (is_ch, bi, wp,
    kind, w, h, rows)) -> the kernel's row table.  Groups of one block
    class (is_ch, bi, wp, w, h) merge whatever their kind (every row is
    exact as kind 3), the classes go in ascending order, and padding rows
    (a block wholly outside the canvas, which writes nothing) drop out.
    Rows are int16, as the pack writes them; a row that does not fit
    raises."""
    ch, cw = canvas_shape
    by_key = {}
    for is_ch, bi, wp, _kind, w, h, rows in groups:
        if not (2 <= w <= 64 and 1 <= h <= 64) or w % 2 \
                or (w % 4 and w > 8):
            raise ValueError(f"mc: block {w}x{h} is not a PU size")
        r = _host_rows(rows)
        cy, cx = r[:, C_CY], r[:, C_CX]
        keep = (cy < ch) & (cx < cw) & (cy > -h) & (cx > -w)
        if not keep.all():
            r = r[keep]
        if r.dtype != np.int16 and r.size and (int(r.min()) < -(1 << 15)
                                               or int(r.max()) >= 1 << 15):
            raise ValueError("mc: a row value does not fit int16")
        if r.shape[0]:
            key = (int(bool(is_ch)), int(bool(bi)), int(bool(wp)), w, h)
            by_key.setdefault(key, []).append(r)
    out, parts, start = [], [], 0
    for key in sorted(by_key):
        n = sum(r.shape[0] for r in by_key[key])
        out.append(key + (start, n))
        parts += by_key[key]
        start += n
    rows = np.zeros((start, MC_COLS), np.int16)
    if parts:
        np.concatenate(parts, out=rows, casting="unsafe")
    return McTable(rows, tuple(out))


def table_groups(table: McTable, rows: torch.Tensor):
    """The table as groups for ``mc_plain``, with ``rows`` the table's
    rows as an int32 tensor."""
    return [(bool(is_ch), bool(bi), bool(wp), 3, w, h, rows[s:s + n])
            for is_ch, bi, wp, w, h, s, n in table.groups]


def mc_params(canvas, refs_l, refs_c, table: McTable, bd) -> McParams:
    """The launch's ``McParams``: geometry, alignment flags, group codes,
    row and work-unit offsets, and the per-warp shared memory of the
    largest window of the table."""
    if len(table.groups) > MAX_GROUPS:
        raise ValueError(f"mc: {len(table.groups)} block classes > "
                         f"{MAX_GROUPS}")
    p = McParams()
    p.ch, p.cw = canvas.shape
    p.nl, p.hl, p.wl = refs_l.shape
    p.nc, p.hc, p.wc = refs_c.shape
    p.bd = bd

    def aligned(t):
        return int(t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0)

    p.vec_l, p.vec_c, p.vec_out = aligned(refs_l), aligned(refs_c), \
        aligned(canvas)
    p.ngroups = len(table.groups)
    nvec, unit = 1, 0
    for g, (is_ch, bi, wp, w, h, start, n) in enumerate(table.groups):
        p.code[g] = is_ch | bi << 1 | wp << 2 | w << 3 | h << 10
        p.row_start[g] = start
        p.unit_start[g] = unit
        unit += n * -(-w // SUB) * -(-h // SUB)
        # a window row of a sub-block: its columns after a shift of up
        # to 3 to the aligned x0, in 16 B vectors
        cols = min(w, SUB) + (3 if is_ch else 7)
        nvec = max(nvec, (cols + 6) // 4)
    p.row_start[p.ngroups] = table.rows.shape[0]
    p.unit_start[p.ngroups] = unit
    p.win_stride = 4 * nvec
    p.warp_smem = (SUB + 7) * (p.win_stride + SUB)
    return p


def launch_mc(canvas, refs_l, refs_c, rows, params: McParams):
    """Launch ``mc_kernel`` once over the table's rows (int16 [N, 17] on
    the canvas's card) with the launch's ``mc_params``."""
    dev = canvas.device
    for name, t, dim in (("canvas", canvas, 2), ("refs_l", refs_l, 3),
                         ("refs_c", refs_c, 3)):
        build.check_tensor(name, t, dim, dev)
    if rows.device != dev or rows.dtype != torch.int16 \
            or not rows.is_contiguous() \
            or rows.shape != (params.row_start[params.ngroups], MC_COLS):
        raise ValueError(f"mc: row table {rows.dtype} {tuple(rows.shape)} "
                         f"on {rows.device}")
    if params.unit_start[params.ngroups] == 0:
        return canvas
    with torch.cuda.device(dev):
        rc = build.load().hevc_mc_launch(
            canvas.data_ptr(), refs_l.data_ptr(), refs_c.data_ptr(),
            rows.data_ptr(), C.byref(params),
            torch.cuda.current_stream(dev).cuda_stream)
    build.launches["mc"] += 1
    build.raise_on(rc, "mc_kernel")
    return canvas


def mc(canvas, refs_l, refs_c, groups, bd):
    """Motion compensation of every PU row in ``groups`` (the layout of
    ``pipeline._mc_tile_phase``; rows as NumPy arrays or tensors), in place
    on the int32 canvas: one kernel launch for the whole picture."""
    table = mc_table(groups, canvas.shape)
    dev = canvas.device
    rows = upload(table.rows, dev)
    if dev.type == "cpu":
        return mc_plain(canvas, refs_l, refs_c,
                        table_groups(table, rows.to(torch.int32)), bd,
                        tables_from_reference(dev))
    return launch_mc(canvas, refs_l, refs_c, rows,
                     mc_params(canvas, refs_l, refs_c, table, bd))


def resid_params(canvas, fields, pools, bd) -> ResidParams:
    """The launch's ``ResidParams``: per class (cy, cx, slot) rows int32
    [N, 3] and pool int32 [Np, s, s] on the canvas's card."""
    dev = canvas.device
    build.check_tensor("canvas", canvas, 2, dev)
    if len(fields) != 4 or len(pools) != 4:
        raise ValueError("resid_add: four classes of rows and pools")
    p = ResidParams()
    p.ch, p.cw = canvas.shape
    p.bd = bd
    p.vec_out = int(p.cw % 4 == 0 and canvas.data_ptr() % 16 == 0)
    seg = 0
    for c, (f, pool) in enumerate(zip(fields, pools)):
        s = 4 << c
        p.seg_start[c] = seg
        n = f.shape[0]
        if n == 0:
            continue
        build.check_tensor(f"rows[{c}]", f, 2, dev)
        build.check_tensor(f"pool[{c}]", pool, 3, dev)
        if f.shape[1] != 3 or pool.shape[1:] != (s, s) or pool.shape[0] < 1:
            raise ValueError(f"resid_add: class {c} rows {tuple(f.shape)}, "
                             f"pool {tuple(pool.shape)}")
        p.rows[c], p.pool[c] = f.data_ptr(), pool.data_ptr()
        p.n[c], p.npool[c] = n, pool.shape[0]
        p.vec_pool[c] = int(pool.data_ptr() % 16 == 0)
        seg += n * s * s // 4
    p.seg_start[4] = seg
    return p


def launch_resid_add(canvas, params: ResidParams):
    """Launch ``resid_add_kernel`` once over the classes of ``params``."""
    if params.seg_start[4] == 0:
        return canvas
    dev = canvas.device
    with torch.cuda.device(dev):
        rc = build.load().hevc_resid_add_launch(
            canvas.data_ptr(), C.byref(params),
            torch.cuda.current_stream(dev).cuda_stream)
    build.launches["resid_add"] += 1
    build.raise_on(rc, "resid_add_kernel")
    return canvas


def resid_add(canvas, fields, pools, bd):
    """Inter residual add (the layout of ``mc.resid_phase``): per size
    class, rows (cy, cx, slot) add ``pools[c][slot]`` to the canvas and
    clip, in place on the int32 canvas; one launch for all classes."""
    if canvas.device.type == "cpu":
        return resid_add_plain(canvas, fields, pools, bd)
    return launch_resid_add(canvas, resid_params(canvas, fields, pools, bd))
