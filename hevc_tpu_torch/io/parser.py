"""Annex-B stream parser: access-unit boundary detection.

The analogue of the reference's AVCodecParser (reference:
libavcodec/hevc_parser.c:458 hevc_parse, :590 ff_hevc_parser): scan the
byte stream for NAL start codes and group NALs into access units so a
caller can feed the decoder one AU at a time instead of a whole file.

AU boundary rule (7.4.2.4.4): a new AU starts at the first VCL NAL
whose first_slice_segment_in_pic_flag is 1; non-VCL NALs that prefix a
picture (AUD, VPS/SPS/PPS, prefix SEI) attach to the FOLLOWING AU once
the current one holds at least one slice.

Copied from ``hevc_tpu/io/parser.py`` at e99b487.
"""
from __future__ import annotations

from typing import Iterator, List, Optional

from ..bitstream import nal as nalmod

_AUD = 35


def _nal_positions(data: bytes):
    """(offset, nal_type, first_slice_flag) for every NAL start code.

    first_slice_flag reads the first payload bit after the 2-byte NAL
    header (7.3.6.1 first_slice_segment_in_pic_flag) — valid only for
    slice NAL types."""
    out = []
    i = 0
    n = len(data)
    while i + 3 < n:
        if data[i] == 0 and data[i + 1] == 0:
            k = None
            if data[i + 2] == 1:
                k = i + 3
            elif i + 4 < n and data[i + 2] == 0 and data[i + 3] == 1:
                k = i + 4
            if k is not None and k + 2 < n:
                nal_type = (data[k] >> 1) & 0x3F
                first = bool(data[k + 2] & 0x80) \
                    if nal_type <= 31 and k + 2 < n else False
                out.append((i, nal_type, first))
                i = k
                continue
        i += 1
    return out


def split_access_units(data: bytes) -> List[bytes]:
    """Split an Annex-B elementary stream into access units (bytes)."""
    return list(iter_access_units(data))


def iter_access_units(data: bytes) -> Iterator[bytes]:
    nals = _nal_positions(data)
    if not nals:
        return
    bounds = []  # byte offsets where a new AU starts
    au_has_slice = False
    au_start_mark: Optional[int] = None  # earliest prefix NAL offset
    for off, t, first in nals:
        if nalmod.is_slice_nal(t):
            if first and au_has_slice:
                # new picture: the AU starts at its prefix NALs if any
                bounds.append(au_start_mark if au_start_mark is not None
                              else off)
            au_has_slice = True
            au_start_mark = None
        elif t == _AUD or t in (nalmod.NAL_VPS, nalmod.NAL_SPS,
                                nalmod.NAL_PPS) or t == 39:  # prefix SEI
            # candidate start of the next AU (only once a slice exists)
            if au_has_slice and au_start_mark is None:
                au_start_mark = off
        else:
            # suffix NALs stay with the current AU
            au_start_mark = None
    starts = [nals[0][0]] + bounds
    for a, b in zip(starts, starts[1:] + [len(data)]):
        yield data[a:b]


class AnnexBParser:
    """Incremental AU framing over arbitrary byte chunks.

    feed(chunk) returns the list of COMPLETE access units discovered so
    far; flush() returns the trailing AU.  The analogue of
    av_parser_parse2 over the reference's hevc parser."""

    def __init__(self):
        self._buf = bytearray()

    def feed(self, chunk: bytes) -> List[bytes]:
        self._buf += chunk
        aus = split_access_units(bytes(self._buf))
        if len(aus) <= 1:
            return []
        # all but the last AU are complete (the last may still grow)
        done = aus[:-1]
        keep = sum(len(a) for a in done)
        del self._buf[:keep]
        return done

    def flush(self) -> List[bytes]:
        aus = split_access_units(bytes(self._buf))
        self._buf.clear()
        return aus
