"""Frozen copy of ``hevc_tpu_torch/ops/__init__.py`` at ee5ffe9."""
