"""Copied from ``hevc_tpu/bitstream/__init__.py`` at e99b487."""
from .bits import BitReader, BitWriter
from .nal import NalUnit, split_annexb, write_annexb, remove_epb, insert_epb
