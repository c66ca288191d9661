"""Seeded random inputs of the intra wavefront, for holding the kernel
(``intra_cuda``) against its plain version (``intra``) and the plain
version against the JAX package's, bit for bit.

NumPy only: the CPU tests, the card tests and ``chip_smoke.py`` share it.
A case is a canvas of CELL x CELL cells and a chunk table in the pack's
layout (``intra.reconstruct_wavefront``'s arguments).  Each chunk puts at
most one record in a cell, whole inside it with its L-shaped band, so no
record reads what another record of its chunk writes, while later chunks
read what earlier ones wrote.  Every case holds every mode of every size
(``MODES``) in a shuffled order; ``filt``, ``strong`` and ``edge`` are
drawn at random; availability is full, empty, a run from either end or
random bits.  Some cells start nearly flat (a level plus 0 or 1), and the
first chunk puts a 32x32 record under strong smoothing with every
neighbour available on each (up to the slots it has): there the bilinear
ramps replace the [1 2 1] filter, which keeps the noise.  Residual
slots include 0 and one past the pool (clamped); every class has padding
slots (``cy == cx == DUMP``) spread among its records, and some chunks
hold no record.  The shapes are fixed, so every case of one bit depth is
one JAX compile.
"""
from __future__ import annotations

import numpy as np

from .intra import SIZES
from .pack import DUMP

CELL = 72                 # 2n + 1 < CELL for n = 32
GRID = (5, 5)             # cells
N_CHUNKS = 10
EMPTY_CHUNKS = (3, 9)     # chunks that hold no record
B = (8, 8, 8, 6)          # slots a chunk, per class (one at least padding)
N_POOL = 6                # residual blocks a class (slot 0 zeros)
MODES = [(c, m) for c in range(4) for m in range(35)]


def _avail(rng, n):
    """(left [64], top [64], corner) availability of one record: full,
    none, a run from the near end, a run from the far end, or random."""
    kind = rng.integers(0, 5)
    left = np.zeros(64, bool)
    top = np.zeros(64, bool)
    corner = bool(rng.integers(0, 2))
    if kind == 0:
        left[:2 * n] = top[:2 * n] = corner = True
    elif kind == 1:
        corner = False
    elif kind in (2, 3):
        kl, kt = rng.integers(0, 2 * n + 1, 2)
        if kind == 2:
            left[:kl] = top[:kt] = True
        else:
            left[2 * n - kl:2 * n] = top[2 * n - kt:2 * n] = True
    else:
        left[:2 * n] = rng.integers(0, 2, 2 * n).astype(bool)
        top[:2 * n] = rng.integers(0, 2, 2 * n).astype(bool)
    return left, top, corner


def random_case(seed):
    """(canvas int32 [ch, cw], scal [4] int32 [N_CHUNKS, B_c, 8], avail [4]
    bool [N_CHUNKS, B_c, 128], resids [4] int32 [N_POOL, n, n], bd): the
    wavefront inputs of one seeded case, bit depth 8 for an even seed and
    10 for an odd one, as NumPy arrays."""
    rng = np.random.default_rng(seed)
    bd = (8, 10)[seed % 2]
    gy, gx = GRID
    canvas = rng.integers(0, 1 << bd, (gy * CELL, gx * CELL)).astype(
        np.int32)
    flat = [k for k in range(gy * gx) if rng.integers(0, 3) == 0]
    for k in flat:
        y, x = divmod(k, gx)
        canvas[y * CELL:(y + 1) * CELL, x * CELL:(x + 1) * CELL] = \
            rng.integers(0, (1 << bd) - 1) + rng.integers(0, 2, (CELL, CELL))
    resids = []
    for n in SIZES:
        pool = rng.integers(-300, 300, (N_POOL, n, n)).astype(np.int32)
        pool[0] = 0
        resids.append(pool)
    live = [k for k in range(N_CHUNKS) if k not in EMPTY_CHUNKS]
    recs = [[[] for _ in range(4)] for _ in range(N_CHUNKS)]
    cells = [set() for _ in range(N_CHUNKS)]

    def place(k, c, mode, cell, strong_flat):
        n = SIZES[c]
        y, x = divmod(cell, gx)
        ry, rx = rng.integers(0, CELL - 2 * n, 2)
        if strong_flat:
            left, top, corner = np.ones(64, bool), np.ones(64, bool), True
            filt = strong = 1
        else:
            left, top, corner = _avail(rng, n)
            filt, strong = rng.integers(0, 2, 2)
        slot = int(rng.choice([0, 1, 2, N_POOL - 1, N_POOL]))
        row = (y * CELL + 1 + ry, x * CELL + 1 + rx, mode, slot, filt,
               strong, rng.integers(0, 2), int(corner))
        recs[k][c].append((row, np.concatenate([left, top])))
        cells[k].add(cell)

    for cell in flat[:B[3] - 1]:
        place(live[0], 3, int(rng.integers(0, 35)), cell, True)
    for i in rng.permutation(len(MODES)):
        c, mode = MODES[i]
        fits = [k for k in live if len(recs[k][c]) < B[c] - 1
                and len(cells[k]) < gy * gx]
        k = fits[rng.integers(0, len(fits))]
        free = [j for j in range(gy * gx) if j not in cells[k]]
        place(k, c, mode, free[rng.integers(0, len(free))], False)

    scal = [np.zeros((N_CHUNKS, b, 8), np.int32) for b in B]
    avail = [np.zeros((N_CHUNKS, b, 128), bool) for b in B]
    for c, s in enumerate(scal):
        s[:, :, 0] = s[:, :, 1] = DUMP
        s[:, :, 2] = 1
        for k in range(N_CHUNKS):
            slots = rng.permutation(B[c])[:len(recs[k][c])]
            for j, (row, bits) in zip(slots, recs[k][c]):
                s[k, j] = row
                avail[c][k, j] = bits
    return canvas, scal, avail, resids, bd


def modes_of(scal):
    """The (class, mode) of every record of a case."""
    return {(c, int(m)) for c, s in enumerate(scal)
            for m in s[..., 2][s[..., 0] != DUMP]}
