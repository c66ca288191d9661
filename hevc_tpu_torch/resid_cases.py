"""Seeded random inputs of the residual stage (``resid_cuda.residuals``),
for holding its kernel against the plain version bit for bit.

The CPU tests, the card tests and ``chip_smoke.py`` share them.  A case is
what ``pipeline.frame_program`` hands the stage for one picture: per size
class (4x4 to 32x32) the int16 levels [N, s, s], the 9-column rows [N, 9]
(qp, dst, ts, raw, mtx + 1, rot, rdpcm, ccp_alpha, ccp_slot) with the
pack's all-zero padding rows at the end, and the scaling bank [7, s, s]
(slot 0 flat 16, 1..6 matrices of 1..255), with the bit depth.  ``CASES``
spans bit depths 8 to 16 (a negative transform-skip shift from 14 bits at
4x4), QPs on both sides of the dequantisation's shift sign, DCT and
DST-VII, transform skip, bypass, levels at the int16 limits (every clip),
the 4x4 rotation, RDPCM in both directions, cross-component prediction
(source slot 0 among them) and empty classes.
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import tables_from_reference

SIZES = (4, 8, 16, 32)

# name -> bit depth, records per class (padding rows after them), share of
# levels at the int16 limits, range-extension tools, scaling matrices
CASES = {
    "main_8bit": (8, (37, 21, 11, 5), 0.0, False, True),
    "main_10bit_flat": (10, (23, 17, 9, 6), 0.0, False, False),
    "limits_8bit": (8, (19, 13, 7, 4), 0.3, False, True),
    "limits_12bit": (12, (17, 11, 6, 3), 0.3, True, True),
    "rext_10bit": (10, (45, 19, 9, 4), 0.02, True, True),
    "rext_16bit": (16, (29, 15, 7, 3), 0.05, True, True),
    "rext_14bit_flat": (14, (31, 12, 5, 2), 0.0, True, False),
    "empty_classes": (10, (0, 9, 0, 3), 0.0, True, True),
    "only_32x32": (8, (0, 0, 0, 7), 0.1, True, True),
}

# the pictures of the benchmark's banks (``benchmark/data/<bank>``) the
# kernel is held on: bank -> (access units of its first segment decoded,
# the (kind, layer) of each picture taken)
BANK_PICTURES = {"main1080/ra": (5, (("I", 0), ("P", 0), ("B", 0))),
                 "main1080/intra": (1, (("I", 0),)),
                 "shvc1080_x1.5/ldp": (2, (("I", 0), ("P", 1))),
                 "main10_2160/ra": (5, (("I", 0), ("P", 0), ("B", 0)))}


def _levels(rng, n, s, limits):
    """[n, s, s] int16 levels: sparse small values, a few large ones and,
    with ``limits``, that share at -32768 or 32767."""
    lv = rng.integers(-6, 7, (n, s, s)) * (rng.random((n, s, s)) < 0.4)
    big = rng.random((n, s, s)) < 0.03
    lv = np.where(big, rng.integers(-3000, 3001, (n, s, s)), lv)
    at = rng.random((n, s, s)) < limits
    lv = np.where(at, rng.choice([-32768, 32767], (n, s, s)), lv)
    return lv.astype(np.int16)


def make(name, seed=0):
    """Case ``name`` drawn from ``seed``: {"bd", "levels", "rmeta",
    "bank"}, NumPy arrays per class, and "live", the records of each class
    before its padding rows."""
    bd, counts, limits, rext, matrices = CASES[name]
    rng = np.random.default_rng([seed, sum(map(ord, name))])
    qp_hi = 51 + 6 * (bd - 8)
    levels, rmeta, bank = [], [], []
    for c, s in enumerate(SIZES):
        live = counts[c]
        n = live + (rng.integers(1, 5) if live else 0)  # padding rows
        lv = _levels(rng, n, s, limits)
        lv[live:] = 0
        m = np.zeros((n, 9), np.int32)
        m[:live, 0] = rng.integers(0, qp_hi + 1, live)
        m[:live, 1] = (rng.random(live) < 0.5) if s == 4 else 0
        m[:live, 2] = rng.random(live) < 0.25
        m[:live, 3] = rng.random(live) < 0.15
        m[:live, 4] = rng.integers(0, 7, live) if matrices else 0
        if rext:
            m[:live, 5] = rng.random(live) < 0.3
            m[:live, 6] = rng.integers(0, 3, live)
            alpha = rng.choice([-8, -4, -2, -1, 1, 2, 4, 8], live)
            m[:live, 7] = np.where(rng.random(live) < 0.4, alpha, 0)
            m[:live, 8] = rng.integers(0, n + 1, live)
            if live:  # a chroma record whose source is the zero slot
                m[0, 7:9] = (4, 0)
        b = np.full((7, s, s), 16, np.int32)
        if matrices:
            b[1:] = rng.integers(1, 256, (6, s, s))
        levels.append(lv)
        rmeta.append(m)
        bank.append(b)
    return {"bd": bd, "levels": levels, "rmeta": rmeta, "bank": bank,
            "live": counts}


def tensors(case, dev):
    """``resid_cuda.residuals``' arguments of ``case`` on ``dev``."""
    def t(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    return (t(case["levels"]), t(case["rmeta"]), case["bd"],
            t(case["bank"]), tables_from_reference(dev))
