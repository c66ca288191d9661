"""Copied from ``hevc_tpu/decoder/__init__.py`` at e99b487.

``TorchDecoder`` is ``Decoder(recon_backend="torch")``, the port's stage B,
under the name the port's callers use."""
from .core import Decoder  # noqa: F401


def TorchDecoder(check_md5: bool = True, device=None, target_layer: int = 63,
                 temporal_layer: int = 7) -> Decoder:
    """A ``Decoder`` whose stage B is the port's frame program on
    ``device`` (``None`` = the current CUDA device, ``"cpu"`` the plain
    versions of the kernels)."""
    return Decoder(check_md5=check_md5, recon_backend="torch",
                   target_layer=target_layer, temporal_layer=temporal_layer,
                   device=device)
