"""Constant tables and reference planes of the frame program.

Every table is rebuilt from the NumPy oracles (``ops/``, copies of the JAX
package's), exactly as ``hevc_tpu/tpu/{mc,transforms,filters,intra}.py``
build theirs, so the two packages share one definition of the codec's
constants.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import trace
from .ops import deblock as D
from .ops import mc as M
from .ops import reference as R
from .pack import PAD_REF


def _numpy_tables():
    # unified tap tables: row 0 = unit (full-pel), as hevc_tpu/tpu/mc.py
    qpel = np.zeros((4, 8), np.int32)
    qpel[0, 3] = 64
    for f in (1, 2, 3):
        qpel[f] = M.QPEL_FILTERS[f]
    epel = np.zeros((8, 4), np.int32)
    epel[0, 1] = 64
    for f in range(1, 8):
        epel[f] = M.EPEL_FILTERS[f]
    # chroma QP mapping for 4:2:0 (8.6.1 Table 8-10), as tpu/filters.py
    qpc = np.arange(58, dtype=np.int32)
    for q in range(58):
        if 30 <= q <= 43:
            qpc[q] = (29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36,
                      37, 37)[q - 30]
        elif q > 43:
            qpc[q] = q - 6
    angle = np.zeros(35, np.int32)
    angle[2:] = np.asarray(R.INTRA_PRED_ANGLE, np.int32)
    invangle = np.zeros(35, np.int32)
    invangle[11:26] = np.asarray(R.INV_ANGLE, np.int32)
    out = {
        "qpel": qpel, "epel": epel,
        "level_scale": np.asarray(R.LEVEL_SCALE, np.int32),
        "dst4": np.asarray(R.DST4, np.int32),
        "beta": np.asarray(D.BETA_TABLE, np.int32),
        "tc": np.asarray(D.TC_TABLE, np.int32),
        "qpc": qpc, "angle": angle, "invangle": invangle,
    }
    for n in (4, 8, 16, 32):
        out[f"dct{n}"] = np.asarray(R.dct_matrix(n), np.int32)
    return out


@lru_cache(maxsize=None)
def _tables(device_str):
    return {k: torch.from_numpy(v).to(device_str)
            for k, v in _numpy_tables().items()}


def tables_from_reference(device) -> dict:
    """All constant int32 tables on ``device``: ``qpel`` [4, 8] and
    ``epel`` [8, 4] taps (row 0 = unit tap), ``dct4..dct32``, ``dst4``,
    ``level_scale``, ``beta``, ``tc``, ``qpc`` and the intra ``angle`` /
    ``invangle`` tables.  Cached per device; treat as read-only."""
    return _tables(str(torch.device(device)))


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Replication padding of a 2-D integer tensor (``np.pad`` mode
    ``edge``); ``torch.nn.functional.pad`` replicates only float inputs."""
    h, w = x.shape
    dev = x.device
    rows = torch.arange(-top, h + bottom, device=dev).clamp_(0, h - 1)
    cols = torch.arange(-left, w + right, device=dev).clamp_(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


def pad_ref(plane: torch.Tensor) -> torch.Tensor:
    """A decoded plane as a PAD_REF replication-padded int32 reference."""
    return edge_pad(plane.to(torch.int32), PAD_REF, PAD_REF, PAD_REF,
                    PAD_REF)


def pad_refs(planes) -> tuple:
    """Planes (tensors) -> the port's three PAD_REF-padded int32 reference
    planes on their device; a single (monochrome) plane is aliased into
    all three slots."""
    pads = tuple(pad_ref(p) for p in planes)
    if len(pads) == 1:
        pads = (pads[0], pads[0], pads[0])
    return pads


def upload(a, device) -> torch.Tensor:
    """A host array copied to ``device``, its bytes counted as
    ``h2d_bytes``."""
    a = np.ascontiguousarray(a)
    trace.count("h2d_bytes", a.nbytes)
    return torch.from_numpy(a).to(device)


def dpb_from_numpy(planes, device) -> tuple:
    """Host planes -> the port's reference planes on ``device`` (the mirror
    of ``pipeline._pad_np`` with ``aligned=False``; ``pipeline.pad_dev_refs``
    is its device-to-device twin)."""
    return pad_refs([upload(np.asarray(p, np.int32), device)
                     for p in planes])
