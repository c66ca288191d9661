"""Batched dequantisation and inverse transforms (8.6.2-8.6.4), bit-exact.

Port of ``hevc_tpu/tpu/transforms.py``: all TUs of one size class are
batched into [N, S, S] int32 tensors.  CUDA has no int32 matmul, so the
two transform passes run as float64 matmuls, which are exact here: every
partial sum is an integer with |acc| <= 32 * 90 * 32768 < 2^53.  This is
the plain version: the CPU's path (``resid_cuda.residuals`` on CPU
tensors) and the reference the residual kernel (``csrc/resid.cu``), which
the frame program runs on the card, is held to bit for bit.
"""
from __future__ import annotations

import torch

I32 = torch.int32


def _shl(v, s):
    return torch.bitwise_left_shift(v, s)


def dequant_batch(levels, qp, log2_size, bit_depth, tables, scale_m=None):
    """Scaling process (8.6.3).

    levels: int32 [N, S, S]; qp: int32 [N] (QpBdOffset included);
    scale_m: optional int32 [N, S, S] scaling matrices (None = flat 16).
    Returns int32 [N, S, S] clipped to 16 bit; same refactoring of the
    64-bit product as ``tpu/transforms.py:dequant_batch``."""
    sh = bit_depth + log2_size - 5
    ls = tables["level_scale"][torch.remainder(qp, 6).long()]
    if scale_m is None:
        lsm = (ls * 16)[:, None, None]
    else:
        lsm = ls[:, None, None] * scale_m
    num = levels * lsm
    sh2 = (sh - torch.div(qp, 6, rounding_mode="floor"))[:, None, None]
    sh2p = sh2.clamp(min=1)
    d_pos = (num + _shl(torch.ones_like(sh2p), sh2p - 1)) >> sh2p
    d_neg = _shl(num.clamp(-(1 << 24), 1 << 24), (-sh2).clamp(min=0))
    d = torch.where(sh2 > 0, d_pos, d_neg)
    return d.clamp(-32768, 32767)


def _matmul_exact(a, b):
    """int32 matmul through float64 (exact for |acc| < 2^53)."""
    return torch.matmul(a.double(), b.double()).to(I32)


def inverse_transform_batch(d, bit_depth, dst_mask, tables):
    """Inverse 2-D transform (8.6.4) for a batch of same-size blocks.

    d: int32 [N, S, S]; dst_mask: bool [N], True selects DST-VII (only
    for S == 4).  Returns the int32 residual [N, S, S]."""
    n = d.shape[-1]
    T = tables[f"dct{n}"]
    if n == 4:
        T = torch.where(dst_mask[:, None, None], tables["dst4"][None],
                        T[None])
    e = _matmul_exact(T.transpose(-2, -1), d)
    e = ((e + 64) >> 7).clamp(-32768, 32767)
    sh2 = 20 - bit_depth
    r = _matmul_exact(e, T)
    return ((r + (1 << (sh2 - 1))) >> sh2).clamp(-32768, 32767)


def transform_skip_batch(d, bit_depth):
    """Transform skip with the size-dependent shift 15 - bd - log2."""
    log2 = int(d.shape[-1]).bit_length() - 1
    sh = 15 - bit_depth - log2
    r = (d + (1 << (sh - 1))) >> sh if sh > 0 else d << -sh
    return r.clamp(-32768, 32767)


def residual_batch(levels, qp, dst_mask, ts_mask, log2_size, bit_depth,
                   tables, scale_m=None):
    """Levels -> spatial residual for one TU size class; ts_mask selects
    the transform-skip path per block."""
    d = dequant_batch(levels, qp, log2_size, bit_depth, tables, scale_m)
    it = inverse_transform_batch(d, bit_depth, dst_mask, tables)
    ts = transform_skip_batch(d, bit_depth)
    return torch.where(ts_mask[:, None, None], ts, it)
