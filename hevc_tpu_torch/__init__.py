"""hevc_tpu_torch — the HEVC decoder with its stage B on PyTorch and CUDA.

A port of ``hevc_tpu`` to PyTorch that imports nothing of it and never
imports JAX.  The host side is a copy of ``hevc_tpu``'s, at the same
paths (``bitstream/``, ``cabac/``, ``coding/``, ``ops/``, ``io/``,
``encoder/``, ``log``, ``trace``, and ``native/`` with its C++ stage A,
built with ``g++`` into ``build/``).  ``decoder/core.py`` is the stream
decoder with the port's stage B behind ``recon_backend="torch"``: the
host pack (``pack.py``) and the frame program (``pipeline.py``) on a
torch device, six stages of which (the residual transform, motion
compensation, the inter residual add, the intra wavefront, deblocking and
SAO) are kernels written by hand in CUDA C++ for Hopper (``csrc/``).
``hevc_tpu`` stays the bit-exact reference.

Entry points: ``TorchDecoder`` (``Decoder(recon_backend="torch")``) and
``python -m hevc_tpu_torch.cli``.  Several devices: ``band.py`` and
``sharded.py`` decode a tile-coded stream in column bands with halo
exchange (``python -m hevc_tpu_torch.dist_worker`` across processes),
``pgop_frame.py`` the pictures of a dependency batch side by side.
``python3 -m benchmark.run`` measures the port through ``api.py``;
``bounds.py`` holds the stages' work counts and ``capture.py`` the stage
captures, replays and timings of ``chip_smoke.py``.  Beside the decoder,
``cabac/rows.py`` ports the on-device CABAC engine
(``hevc_tpu/tpu/cabac_pallas.py``; ``python -m hevc_tpu_torch.cabac.rows``)
and ``probes.py`` the Mosaic probes of ``tools/``, each with its Hopper
kernel in ``csrc/``.
"""
from .device import resolve_device

__all__ = ["resolve_device", "TorchDecoder"]


def __getattr__(name):
    if name == "TorchDecoder":
        from .decoder import TorchDecoder
        return TorchDecoder
    raise AttributeError(name)
