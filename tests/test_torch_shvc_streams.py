"""Two-layer SHVC streams through the port: ``TorchDecoder(device="cpu")``
against ``Decoder(recon_backend="jax")``, bit-exact on every plane of both
layers, with every SEI MD5 correct, on the configurations of
tests/test_shvc.py (x2, x1.5, an arbitrary ratio, SNR, loop filters on
both layers, TMVP with the collocated picture the previous EL picture or
the inter-layer reference, 8 -> 10 bit) and tests/test_cgs.py (CGS colour
mapping, spatial and SNR).  Every picture of both layers runs the port's
frame program, and no reference, the inter-layer one included, comes from
the host."""
from functools import lru_cache

import numpy as np
import pytest

from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from hevc_tpu_torch import pipeline as PP
from hevc_tpu_torch.decoder import TorchDecoder
from torch_streams import SHVC, assert_same, planes_of, shvc_stream

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


@lru_cache(maxsize=None)
def stream(name):
    return shvc_stream(name)


def _decode_port(data):
    """(planes_of the frames, their layers, pictures through the frame
    program, references resolved from the host)."""
    n = [0]
    orig = PP.finish_frame

    def finish(*args):
        n[0] += 1
        return orig(*args)

    PP.finish_frame = finish
    PP.host_refs["count"] = 0
    try:
        frames = TorchDecoder(check_md5=True, device="cpu").decode_bytes(data)
    finally:
        PP.finish_frame = orig
    return (planes_of(frames), [f.layer for f in frames], n[0],
            PP.host_refs["count"])


@pytest.mark.parametrize("name", sorted(SHVC))
def test_torch_decoder_matches_jax_on_shvc(name):
    data = stream(name)
    want = Decoder(check_md5=True, recon_backend="jax").decode_bytes(data)
    got, layers, n_prog, host = _decode_port(data)
    assert layers == [f.layer for f in want] and set(layers) == {0, 1}
    assert_same(planes_of(want), got, name)
    assert n_prog == len(got)        # both layers ran the frame program
    assert host == 0, f"{name}: {host} references resolved from the host"


def test_shvc_without_the_async_pack_worker(monkeypatch):
    """The IL build runs inline when the pack worker is off, in the same
    order: after the BL picture, before the EL picture."""
    monkeypatch.setenv("HEVC_TPU_ASYNC_PACK", "0")
    data = stream("tmvp_col1")
    want = planes_of(Decoder(check_md5=True, recon_backend="inline")
                     .decode_bytes(data))
    got, _layers, n_prog, host = _decode_port(data)
    assert_same(want, got, "tmvp_col1, inline pack")
    assert n_prog == len(got) and host == 0


def test_base_layer_only_decode_of_an_shvc_stream():
    """target_layer 0 drops the EL NALs: the BL decodes alone."""
    data = stream("x2")
    want = [f for f in Decoder(check_md5=True, recon_backend="jax")
            .decode_bytes(data) if f.layer == 0]
    got = TorchDecoder(check_md5=True, device="cpu",
                       target_layer=0).decode_bytes(data)
    assert [f.layer for f in got] == [0] * len(want)
    assert_same(planes_of(want), planes_of(got), "x2, layer 0")
    assert all(np.asarray(f.planes[0]).shape == (64, 64) for f in got)
