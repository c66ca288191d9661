"""Frozen copy of ``hevc_tpu_torch/bitstream/__init__.py`` at ee5ffe9."""
from .bits import BitReader, BitWriter
from .nal import NalUnit, split_annexb, write_annexb, remove_epb, insert_epb
