"""Copied from ``hevc_tpu/encoder/__init__.py`` at e99b487."""
from .core import EncoderConfig, IntraEncoder  # noqa: F401
