"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place with one guarantee broken, which
must come out as not correct.

No precision is stated below the exact one, so the control is the
shortcut a faster decoder is tempted by: skipping the deblocking filter,
as ``ffmpeg -skip_loop_filter all`` does.  Every other stage is the
reference's.

    python -m benchmark.control --workload main1080.ra --seed N --seconds S

runs the harness with the control as the program (on the host's CPU: it
is NumPy) and prints the result line, whose ``correct`` has to be false.
"""
from __future__ import annotations

import sys
from contextlib import contextmanager
from typing import List

from .program import Picture


@contextmanager
def _no_deblocking():
    from .reference.ops import deblock
    keep = deblock.deblock_frame
    deblock.deblock_frame = lambda *a, **kw: None
    try:
        yield
    finally:
        deblock.deblock_frame = keep


class ControlProgram:
    """The reference decoder, deblocking skipped, behind ``Program``'s
    interface."""

    warm_up = False  # nothing of it is built or cached

    def __init__(self, layers: int, device=None):
        from .reference.decoder.core import Decoder
        self.layer = layers - 1
        self.dec = Decoder(check_md5=False, recon_backend="inline",
                           target_layer=self.layer)

    def _collect(self) -> List[Picture]:
        import numpy as np
        frames, self.dec.frames = self.dec.frames, []
        return [(f.pts, [np.asarray(p) for p in f.planes], f.bit_depth)
                for f in frames if f.layer == self.layer]

    def decode(self, au: bytes, pts: int) -> List[Picture]:
        from .reference.bitstream import nal as nalmod
        self.dec.next_pts = pts
        with _no_deblocking():
            for n in nalmod.split_annexb(au):
                self.dec.decode_nal(n)
        return self._collect()

    def close(self) -> List[Picture]:
        with _no_deblocking():
            self.dec.flush()
        return self._collect()


def main(argv=None) -> int:
    from . import run
    return run.main(argv, program=ControlProgram)


if __name__ == "__main__":
    sys.exit(main())
