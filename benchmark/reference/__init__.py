"""The benchmark's plain reference decoder.

A frozen copy of the program's host decoder (``hevc_tpu_torch`` at
ee5ffe9: bitstream, CABAC, syntax, and the NumPy reconstruction, filters
and SHVC inter-layer build of ``Decoder(recon_backend="inline")``), with
its native C++ paths taken out: every slice is parsed in Python and every
sample is made in NumPy.  It imports nothing of the program, of JAX or of
the JAX package.
"""
from __future__ import annotations

from typing import Iterable, List

import numpy as np

from . import log
from .bitstream import nal as nalmod
from .decoder.core import Decoder


def decode(aus: Iterable[bytes], target_layer: int, check_sei: bool = True):
    """Decode a closed GOP given as access units in decode order; yield
    (access unit index, cropped planes, bit depth) of each picture of
    ``target_layer``, in output order.  With ``check_sei`` every picture
    must carry a decoded-picture-hash SEI that its planes match."""
    log.set_log_level(log.OH_LOG_WARNING)
    dec = Decoder(check_md5=check_sei, recon_backend="inline",
                  target_layer=target_layer)

    def collect():
        frames, dec.frames = dec.frames, []
        for f in frames:
            if f.layer != target_layer:
                continue
            if check_sei and f.md5_ok is not True:
                raise ValueError(f"access unit {f.pts}: the reference's "
                                 f"picture does not match its SEI MD5 "
                                 f"({f.md5_ok})")
            yield f.pts, [np.asarray(p) for p in f.planes], f.bit_depth

    for i, au in enumerate(aus):
        dec.next_pts = i
        for n in nalmod.split_annexb(au):
            dec.decode_nal(n)
        yield from collect()
    dec.flush()
    yield from collect()
