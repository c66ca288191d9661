"""The system under test: ``hevc_tpu_torch`` through its libopenhevc-style
API (``hevc_tpu_torch.api``), as a player or transcoder calls it.

This is the only module of the benchmark that imports the program.  A
``Program`` is one decode handle: ``oh_init`` (or ``oh_init_lhvc`` with
``select_active_layer`` on the top layer for SHVC), the SEI checksum off,
the log at warnings, ``start``; then ``decode`` one access unit at a time
and ``close``.  Every picture it returns is copied to host memory
(``OHFrame.planes``) before ``decode`` returns it.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

Picture = Tuple[int, List[np.ndarray], int]  # (pts, host planes, bit depth)


def _host(frame) -> Picture:
    return (frame.info.pts, [np.asarray(p) for p in frame.planes],
            frame.info.bit_depth)


class Program:
    def __init__(self, layers: int, device):
        from hevc_tpu_torch import api
        h = api.oh_init_lhvc(device=device) if layers > 1 \
            else api.oh_init(device=device)
        if layers > 1:
            h.select_active_layer(layers - 1)
        h.enable_sei_checksum(False)
        h.set_log_level(24)  # warnings and worse, as a player keeps it
        h.start()
        self.handle = h

    def decode(self, au: bytes, pts: int) -> List[Picture]:
        got, frame = self.handle.decode(au, pts)
        return [_host(frame)] if got else []

    def close(self) -> List[Picture]:
        return [_host(f) for f in self.handle.close()]


def spans_reset() -> None:
    from hevc_tpu_torch import trace
    trace.reset()


def spans() -> dict:
    """The program's span accumulators: name -> {"calls", "total_s"}."""
    from hevc_tpu_torch import trace
    return trace.report()
