"""Input format probe + unified open — the analogue of
avformat_open_input with the raw Annex-B / MOV / MPEG-TS probes
(reference: libavformat/hevcdec.c:27 hevc_probe, mov.c mov_probe,
mpegts.c mpegts_probe).

Copied from ``hevc_tpu/io/probe.py`` at e99b487.
"""
from __future__ import annotations

from .mp4 import Mp4Reader
from .mpegts import TS_SIZE, SYNC, TsReader


def probe_format(data: bytes) -> str:
    """Return 'mp4' | 'mpegts' | 'annexb'."""
    if len(data) >= 12 and data[4:8] in (b"ftyp", b"moov", b"styp"):
        return "mp4"
    # TS: sync byte repeating at 188-byte period
    if len(data) >= TS_SIZE * 3 and all(
            data[i * TS_SIZE] == SYNC for i in range(3)):
        return "mpegts"
    return "annexb"


def open_input(source) -> bytes:
    """Accepts a path or bytes; returns the Annex-B elementary stream."""
    data = source if isinstance(source, bytes) else open(source, "rb").read()
    fmt = probe_format(data)
    if fmt == "mp4":
        return Mp4Reader(data).annexb_stream()
    if fmt == "mpegts":
        return TsReader(data).annexb_stream()
    return data
