"""Container / format layer — the analogue of the reference's libavformat
subset (SURVEY.md §2.5): raw Annex-B, MP4/MOV (hvcC), and MPEG-TS.

`open_input(path_or_bytes)` probes the format (the analogue of
avformat_open_input + the raw-video probe, reference:
libavformat/hevcdec.c:27, mov.c, mpegts.c) and returns a Demuxer yielding
Annex-B access-unit byte strings suitable for Decoder.decode_bytes.

Copied from ``hevc_tpu/io/__init__.py`` at e99b487.
"""
from .probe import open_input, probe_format  # noqa: F401
from .mp4 import Mp4Reader, Mp4Writer, parse_hvcc, build_hvcc  # noqa: F401
from .mpegts import TsReader, TsWriter  # noqa: F401
