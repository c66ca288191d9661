"""hevc_tpu_torch — the decoder's stage B on PyTorch and CUDA.

A port of ``hevc_tpu``'s device path (``hevc_tpu/tpu``) to PyTorch, with
the two inter kernels of the frame program (motion compensation and the
inter residual add) written by hand in CUDA C++ for Hopper (``csrc/``).
The bitstream, CABAC and syntax layers, the native C++ stage A and the
host pack helpers are imported from ``hevc_tpu``, which stays the
bit-exact reference.  This package never imports JAX.

Entry points: ``TorchDecoder`` (``decoder.py``) and
``python -m hevc_tpu_torch.cli``.  Beside the decoder, ``cabac.py`` ports
the on-device CABAC engine (``hevc_tpu/tpu/cabac_pallas.py``) and
``probes.py`` the Mosaic probes of ``tools/``, each with its Hopper kernel
in ``csrc/``.
"""
from .device import resolve_device

__all__ = ["resolve_device", "TorchDecoder"]


def __getattr__(name):
    if name == "TorchDecoder":
        from .decoder import TorchDecoder
        return TorchDecoder
    raise AttributeError(name)
