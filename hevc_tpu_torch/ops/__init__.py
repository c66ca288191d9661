"""Copied from ``hevc_tpu/ops/__init__.py`` at e99b487."""
