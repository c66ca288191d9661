"""The comparison that decides ``correct``: every plane of every picture
the timed decodes delivered against the plain reference's, bit for bit.

The guarantee of every configuration is that each output picture is
bit-exact, so each number compared has the limit 0.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

LIMITS = {"planes_wrong": 0, "pictures_missing": 0}


def plane_digests(planes: Sequence[np.ndarray], bit_depth: int) -> List[str]:
    """One MD5 per plane over its shape and its samples (one byte each up
    to 8 bits, two little-endian bytes above)."""
    dtype = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    out = []
    for p in planes:
        a = np.ascontiguousarray(p, dtype=dtype)
        h = hashlib.md5(repr(a.shape).encode())
        h.update(a.data)
        out.append(h.hexdigest())
    return out


def judge(fed: List[Tuple[int, int]], delivered: Dict[int, List[List[str]]],
          reference: Dict[int, List[List[str]]]) -> Tuple[Dict[str, int],
                                                          int]:
    """``fed``: (segment, access unit) of each access unit handed in, its
    position the pts it was handed in with; ``delivered``: pts -> the plane
    digests of each picture delivered with that pts (more than one is a
    fault); ``reference``: segment -> the reference's plane digests of each
    access unit's picture.

    ``planes_wrong`` counts the planes of delivered pictures that differ
    from the reference's (a plane too many or too few counts);
    ``pictures_missing`` the access units handed in whose picture never
    came, and the pictures that came with a pts never handed in or twice.
    Returns those two numbers and the count of pictures that failed
    (wrong or missing).
    """
    wrong = missing = bad_pictures = 0
    for pts, pics in delivered.items():
        if not 0 <= pts < len(fed):
            missing += len(pics)
            continue
        seg, au = fed[pts]
        want = reference[seg][au]
        missing += len(pics) - 1
        for got in pics:
            n = sum(a != b for a, b in zip(got, want)) \
                + abs(len(got) - len(want))
            wrong += n
            bad_pictures += n > 0
    missing += sum(1 for pts in range(len(fed)) if pts not in delivered)
    return ({"planes_wrong": wrong, "pictures_missing": missing},
            bad_pictures + missing)


def is_correct(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
