"""The port's parallel native stage A (``hevc_tpu_torch/native/
stage_a_mt.h``: WPP rows, WPP inside tiles) against its sequential walk.

Each row waits on the row above at the 2-CTU lag; with more threads than
the wavefront keeps busy, rows wait all through a picture.  Every thread
count must decode the same pictures as one thread, each matching its SEI
MD5.
"""
import os
from functools import lru_cache

import numpy as np
import pytest

from hevc_tpu_torch import native
from hevc_tpu_torch.decoder.core import Decoder
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from torch_gate import native_ready

pytestmark = pytest.mark.skipif(not native_ready(native),
                                reason="native toolchain unavailable")

CONFIGS = {
    # 8 CTB rows of 8 CTBs: deep enough a wavefront for rows to wait
    "wpp_ipp": dict(width=256, height=256, qp=30, log2_ctb_size=5,
                    log2_cu_size=5, gop="ipp", wpp=True, deblocking=True,
                    sao=True, search_range=3),
    # one unit a tile row of each tile, the lag tile-relative
    "wpp_in_tiles": dict(width=288, height=128, qp=30, log2_ctb_size=5,
                         log2_cu_size=5, wpp=True, tiles=(3, 1), gop="ipp",
                         search_range=2, deblocking=True),
}


@lru_cache(maxsize=None)
def _stream(name):
    cfg = EncoderConfig(seed=2, **CONFIGS[name])
    enc = IntraEncoder(cfg)
    return b"".join(enc.encode_frame(synth_frame("noise", cfg.width,
                                                 cfg.height, t, seed=3))
                    for t in range(3))


def _decode(name, n_threads):
    """(SEI MD5 verdict, planes) of each picture."""
    os.environ["HEVC_TPU_STAGEA_THREADS"] = str(n_threads)
    try:
        frames = Decoder(recon_backend="plan").decode_bytes(_stream(name))
    finally:
        os.environ.pop("HEVC_TPU_STAGEA_THREADS", None)
    return [(f.md5_ok, [np.asarray(p) for p in f.planes]) for f in frames]


_sequential = lru_cache(maxsize=None)(lambda name: _decode(name, 1))


@pytest.mark.parametrize("n_threads", [2, 4, 7])
@pytest.mark.parametrize("name", CONFIGS)
def test_parallel_stage_a_decodes_as_one_thread(name, n_threads):
    seq = _sequential(name)
    par = _decode(name, n_threads)
    assert len(seq) == len(par) == 3
    for (ok_a, a), (ok_b, b) in zip(seq, par):
        assert ok_a and ok_b
        for p in range(3):
            assert np.array_equal(a[p], b[p])
