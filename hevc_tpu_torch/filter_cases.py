"""Seeded random pictures for the loop filter kernels (``filters_cuda``),
for holding them against their plain versions bit for bit.

The CPU tests, the card tests and ``chip_smoke.py`` share them.  A case is
one picture's planes inside a canvas, as the frame program's are (views
whose rows lie apart, with other samples around them that no filter may
touch), and the maps ``pipeline.frame_program`` hands ``deblock_planes``
and ``sao_planes``: per-4x4 QP and boundary strengths, the beta/tc offsets
as per-4x4 maps (several slices) or one each, the Cb/Cr QP offsets,
per-CTB SAO parameters with, for several slices, the SAO edge flags, and
the per-4x4 PCM/TQB ``nf`` map.  ``CASES`` spans the formats (4:0:0,
4:2:0, 4:2:2, 4:4:4), bit depths 8 to 16, deblocking alone, SAO alone,
and sizes that are not multiples of 8 in chroma or of the CTB.  The
content is blocks of 8 with a little noise, so that the strong and weak
luma filters both engage, plus a ramp, so that every SAO category occurs.
"""
from __future__ import annotations

import numpy as np
import torch

from .tables import tables_from_reference

SUB = {0: (1, 1), 1: (2, 2), 2: (2, 1), 3: (1, 1)}  # format -> sub_w, sub_h

# the pictures of the benchmark's banks (``benchmark/data/<bank>``) the
# kernels are held on: bank -> (access units of its first segment decoded,
# the kinds of picture taken, the luma plane's (height, width))
BANK_PICTURES = {"main1080/ra": (5, "IPB", (1080, 1920)),
                 "main1080/intra": (1, "I", (1080, 1920)),
                 "main10_2160/ra": (5, "IPB", (2160, 3840))}

# name -> format, bit depth, luma height and width, log2 CTB, several
# slices (offset maps, SAO edge flags), nf map, deblocking, SAO
CASES = {
    "420_8bit": (1, 8, 64, 96, 4, False, False, True, True),
    "420_10bit_slices_nf": (1, 10, 72, 120, 4, True, True, True, True),
    "400_8bit_slices_nf": (0, 8, 64, 88, 4, True, True, True, True),
    "400_10bit": (0, 10, 48, 56, 5, False, False, True, True),
    "422_8bit_slices": (2, 8, 56, 104, 4, True, False, True, True),
    "422_10bit_nf": (2, 10, 40, 56, 3, False, True, True, True),
    "444_8bit_nf": (3, 8, 48, 72, 5, False, True, True, True),
    "444_10bit_slices_nf": (3, 10, 64, 80, 4, True, True, True, True),
    "420_8bit_deblock_only": (1, 8, 64, 80, 4, True, True, True, False),
    "420_10bit_sao_only": (1, 10, 56, 72, 4, True, True, False, True),
    "422_12bit_slices_nf": (2, 12, 48, 64, 4, True, True, True, True),
    "420_16bit_slices": (1, 16, 40, 48, 3, True, False, True, True),
}


def make(name, seed=0):
    """Case ``name`` drawn from ``seed``: a dict of NumPy arrays and the
    flags (``tensors`` puts it on a device)."""
    cf, bd, h, w, lg, per_slice, nf, do_db, do_sao = CASES[name]
    rng = np.random.default_rng([seed, sum(map(ord, name))])
    sub_w, sub_h = SUB[cf]
    maxv = (1 << bd) - 1
    shapes = [(h, w)] if cf == 0 else [(h, w)] + 2 * [(h // sub_h,
                                                        w // sub_w)]

    def content(ph, pw):
        base = rng.integers(0, 1 << bd, (ph // 8 + 1, pw // 8 + 1))
        ramp = np.arange(pw)[None, :] * max(1, maxv // (4 * pw))
        p = np.repeat(np.repeat(base, 8, 0), 8, 1)[:ph, :pw] // 4 + ramp
        p += rng.integers(-3, 4, (ph, pw)) << max(0, bd - 8)
        return np.clip(p, 0, maxv)

    # the planes in a canvas, each with a margin of other samples around it
    hc, wc = shapes[-1]
    ch, cw = h + hc + 9, max(w, 2 * wc + 3) + 7
    canvas = rng.integers(0, maxv + 1, (ch, cw))
    regions = [(2, 3, h, w), (h + 5, 2, hc, wc), (h + 5, wc + 5, hc, wc)]
    for (oy, ox, ph, pw), _ in zip(regions, shapes):
        canvas[oy:oy + ph, ox:ox + pw] = content(ph, pw)
    h4, w4 = h // 4, w // 4
    cth, ctw = -(-h >> lg), -(-w >> lg)
    lo = -6 * (bd - 8)
    draw = rng.integers
    case = dict(
        name=name, format=cf, bd=bd, ctb_log2=lg, sub_w=sub_w, sub_h=sub_h,
        deblock=do_db, sao=do_sao, canvas=canvas,
        regions=regions[:len(shapes)],
        qp4=draw(lo, 52, (h4, w4)), bs_v=draw(0, 3, (h4, w4)),
        bs_h=draw(0, 3, (h4, w4)),
        beta_off=draw(-12, 13, (h4, w4) if per_slice else ()),
        tc_off=draw(-12, 13, (h4, w4) if per_slice else ()),
        qp_offs=draw(-12, 13, 2),
        sao_t=draw(0, 3, (3, cth, ctw)), sao_b=draw(0, 32, (3, cth, ctw)),
        sao_e=draw(0, 4, (3, cth, ctw)),
        sao_o=draw(-(1 << (min(bd, 10) - 5)) + 1, 1 << (min(bd, 10) - 5),
                 (3, cth, ctw, 4)),
        edge_flags=draw(0, 256, (cth, ctw)) if per_slice else None,
        nf4=(rng.random((h4, w4)) < 0.2).astype(np.int32) if nf else None)
    return case


def tensors(case, dev):
    """Case ``case`` on ``dev``: (canvas, planes as views of it,
    ``deblock_planes``' arguments after the planes, ``sao_planes``'
    arguments after the planes)."""
    def t(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(dev)

    canvas = t(case["canvas"])
    planes = [canvas[oy:oy + h, ox:ox + w]
              for oy, ox, h, w in case["regions"]]
    qp_offs = t(case["qp_offs"])
    deblock = (t(case["qp4"]), t(case["bs_v"]), t(case["bs_h"]),
               t(case["beta_off"]), t(case["tc_off"]),
               (qp_offs[0], qp_offs[1]), tables_from_reference(dev),
               case["bd"], case["sub_w"], case["sub_h"], t(case["nf4"]))
    sao = (t(case["sao_t"]), t(case["sao_b"]), t(case["sao_o"]),
           t(case["sao_e"]), case["ctb_log2"], case["bd"], case["sub_w"],
           case["sub_h"], t(case["edge_flags"]), t(case["nf4"]))
    return canvas, planes, deblock, sao


def run(case, dev, deblock, sao):
    """The case's loop filter through ``deblock`` and ``sao`` (the wrappers,
    their plain versions or stand-ins with their signatures), each only
    where the case turns it on.  Returns (canvas, output planes)."""
    canvas, planes, d_args, s_args = tensors(case, dev)
    if case["deblock"]:
        planes = deblock(planes, *d_args)
    if case["sao"]:
        planes = sao(planes, *s_args)
    return canvas, planes


def outside(case):
    """A mask of the canvas samples outside the case's planes."""
    m = np.ones(case["canvas"].shape, bool)
    for oy, ox, h, w in case["regions"]:
        m[oy:oy + h, ox:ox + w] = False
    return m


def kernel_errors(case, dev):
    """(largest |kernel - plain| over the planes, launches, whether every
    canvas sample outside the planes kept its value): the case through
    ``filters_cuda``'s wrappers on ``dev`` against their plain versions
    there."""
    from . import build, filters_cuda
    before = build.launches["deblock"] + build.launches["sao"]
    canvas, got = run(case, dev, filters_cuda.deblock_planes,
                      filters_cuda.sao_planes)
    launches = build.launches["deblock"] + build.launches["sao"] - before
    _c, want = run(case, dev, filters_cuda.deblock_plain,
                   filters_cuda.sao_plain)
    err = max(int((g - w).abs().max()) for g, w in zip(got, want))
    m = outside(case)
    return err, launches, bool(np.array_equal(canvas.cpu().numpy()[m],
                                              case["canvas"][m]))
