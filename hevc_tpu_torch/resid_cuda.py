"""Wrapper of the residual-stage kernel in ``csrc/resid.cu``.

``residuals`` takes ``recon.residuals``' arguments, with the levels as the
pack uploads them: per class int16 [N, s, s] (int32 is taken too on the
CPU).  For tensors on the CPU it runs the plain version (``residuals_plain``:
``recon.residuals`` on int32 levels); for CUDA tensors it checks every
tensor, launches ``resid_tx_kernel`` once for all four classes and raises
on any refusal: it never falls back.  The kernel reads the levels, the
9-column rows and the scaling banks where they lie and writes the four
pools, slot 0 zeros, into one new buffer; they come back as the plain
version's tuple of int32 [1 + N, s, s] tensors (views of that buffer).  Its
transform matrices are constants of the kernel, so ``tables`` is read only
by the plain version.  The launch adds one to ``build.launches["resid_tx"]``
and to the trace's ``residual_launches`` counter; the call never waits on
the card.
"""
from __future__ import annotations

import ctypes as C

import torch

from . import build, recon, trace

SIZES = (4, 8, 16, 32)
COLS = 9


class ResidClass(C.Structure):
    """``ResidClass`` of ``csrc/resid.cu``, field for field."""
    _fields_ = [("lv", C.c_void_p), ("rm", C.c_void_p), ("bank", C.c_void_p),
                ("out", C.c_void_p), ("n", C.c_int), ("unit0", C.c_int)]


class ResidParams(C.Structure):
    """``ResidParams`` of ``csrc/resid.cu``, field for field."""
    _fields_ = [("cls", ResidClass * 4), ("bd", C.c_int),
                ("units", C.c_int)]


def residuals_plain(levels, rmeta, bit_depth, scale_bank, tables):
    """``residuals``' plain version on any device: ``recon.residuals`` on
    the levels as int32."""
    return recon.residuals([lv.to(torch.int32) for lv in levels], rmeta,
                           bit_depth, scale_bank, tables)


def resid_params(levels, rmeta, bit_depth, scale_bank):
    """The launch's ``ResidParams`` and the four pools it writes (views of
    one new buffer), after checking each tensor's device, type, shape and
    contiguity against the kernel's layout."""
    if len(levels) != 4 or len(rmeta) != 4 or len(scale_bank) != 4:
        raise ValueError("residuals: four classes of levels, rows and banks")
    if not 8 <= bit_depth <= 16:
        raise ValueError(f"residuals: bit depth {bit_depth}")
    dev = rmeta[0].device
    p = ResidParams()
    p.bd = bit_depth
    units, total = 0, 0
    for c, s in enumerate(SIZES):
        lv, rm, bank = levels[c], rmeta[c], scale_bank[c]
        build.check_tensor(f"rmeta[{c}]", rm, 2, dev)
        build.check_tensor(f"scale_bank[{c}]", bank, 3, dev)
        if (lv.device != dev or lv.dtype != torch.int16 or lv.dim() != 3
                or not lv.is_contiguous()):
            raise ValueError(f"levels[{c}]: expected a contiguous int16 3-D "
                             f"tensor on {dev}, got {lv.dtype} "
                             f"{tuple(lv.shape)} on {lv.device}")
        n = rm.shape[0]
        if (rm.shape[1] != COLS or tuple(lv.shape) != (n, s, s)
                or tuple(bank.shape) != (7, s, s)):
            raise ValueError(f"residuals: class {c} levels "
                             f"{tuple(lv.shape)}, rows {tuple(rm.shape)}, "
                             f"bank {tuple(bank.shape)}")
        q = p.cls[c]
        q.lv, q.rm, q.bank = lv.data_ptr(), rm.data_ptr(), bank.data_ptr()
        q.n, q.unit0 = n, units
        units += -(-(n + 1) * s // 32)
        total += (n + 1) * s * s
    p.units = units
    flat = rmeta[0].new_empty(total)
    pools, off = [], 0
    for c, s in enumerate(SIZES):
        n = p.cls[c].n
        pool = flat[off:off + (n + 1) * s * s].view(n + 1, s, s)
        off += (n + 1) * s * s
        p.cls[c].out = pool.data_ptr()
        pools.append(pool)
    return p, tuple(pools)


def residuals(levels, rmeta, bit_depth, scale_bank, tables):
    """Per-class residual pools with a zeros slot prepended
    (``recon.residuals``' result): the plain version on the CPU, one launch
    on the card.

    levels: per class int16 [N, s, s]; rmeta: per class int32 [N, 9] (qp,
    dst, ts, raw, mtx + 1, rot, rdpcm, ccp_alpha, ccp_slot); scale_bank:
    per class int32 [7, s, s]."""
    if rmeta[0].device.type == "cpu":
        return residuals_plain(levels, rmeta, bit_depth, scale_bank, tables)
    params, pools = resid_params(levels, rmeta, bit_depth, scale_bank)
    dev = rmeta[0].device
    rc = build.launch(dev, build.load().hevc_resid_tx_launch,
                      C.byref(params), build.stream(dev))
    build.raise_on(rc, "resid_tx_kernel")
    build.launches["resid_tx"] += 1
    trace.count("residual_launches", 1)
    return pools
