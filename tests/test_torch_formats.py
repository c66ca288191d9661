"""Every single-layer format of the JAX device path through the port:
``TorchDecoder(device="cpu")`` against ``Decoder(recon_backend="jax")``,
bit-exact on every plane, with every SEI MD5 correct, on the streams of
tests/test_multislice.py (per-slice filter maps, tiles without
cross-tile filtering, dependent segments with WPP and tiles),
tests/test_monochrome.py (4:0:0) and tests/test_pipeline.py CONFIGS
``pcm`` and ``tiles``.  Each picture goes through the port's frame
program, its stage A with native records or through the Python syntax
layer (``native.plan_to_records``), 4:0:0 without native records
included.  tests/test_torch_formats_rext.py holds
the dependent-slice and range-extension CASES.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from hevc_tpu_torch import native as port_native
from hevc_tpu_torch.decoder import TorchDecoder
from hevc_tpu_torch.pipeline import LazyPlanes
from torch_streams import (FORMATS, assert_same, decode_port, planes_of)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")
NAMES = [k for k in FORMATS if not k.startswith(("dep_", "rext_"))]


@lru_cache(maxsize=None)
def stream(name):
    return FORMATS[name]()


def jax_frames(name):
    return planes_of(Decoder(check_md5=True, recon_backend="jax")
                     .decode_bytes(stream(name)))


@pytest.mark.parametrize("name", NAMES)
def test_torch_decoder_matches_jax(name):
    got, n_prog = decode_port(stream(name), "cpu")
    assert_same(jax_frames(name), got, name)
    # no quiet fallback: every picture ran the frame program
    assert n_prog == len(got)
    if name.startswith("mono"):
        assert all(len(planes) == 1 for planes, _m, _p in got)


def test_monochrome_without_native_records_runs_the_frame_program():
    """4:0:0 pictures whose stage A ran in the Python syntax layer go
    through plan_to_records and the frame program like every other picture
    (the reference sends them to its NumPy executor instead)."""
    from torch_streams import _mono
    data = _mono(deblocking=True, sao=True, dependent_slices=1)
    want = planes_of(Decoder(check_md5=True, recon_backend="jax")
                     .decode_bytes(data))
    got, n_prog = decode_port(data, "cpu")
    assert_same(want, got, "mono_dependent")
    assert n_prog == len(got)
    assert all(len(planes) == 1 for planes, _m, _p in got)


@pytest.mark.parametrize("name", ["inter_gop", "pcm"])
def test_plan_to_records_inverts_records_to_plan(name, monkeypatch):
    """The native record stream of every picture -> BlockRecords -> the
    record stream again: the rows the packer reads and the level pool
    they point at come back (padding columns are not read)."""
    chunks = []
    from hevc_tpu_torch import pipeline as PP
    orig = PP.finish_frame

    def finish(pic, *rest):
        chunks.append(port_native._concat_chunks(pic.native_chunks))
        return orig(pic, *rest)

    monkeypatch.setattr(PP, "finish_frame", finish)
    TorchDecoder(check_md5=True, device="cpu").decode_bytes(stream(name))
    assert chunks
    for rec, lvl in chunks:
        rec, lvl = np.array(rec), np.array(lvl)
        plan = []
        port_native.records_to_plan(rec, lvl, plan)
        got, glvl = port_native.plan_to_records(plan)
        assert got.shape == rec.shape
        N = port_native
        for col in (N.REC_KIND, N.REC_PLANE, N.REC_X, N.REC_Y, N.REC_W,
                    N.REC_FLAGS, N.REC_CCP):
            assert np.array_equal(got[:, col], rec[:, col]), col
        mc = rec[:, N.REC_KIND] == N.KIND_MC
        assert np.array_equal(got[mc, N.REC_H], rec[mc, N.REC_H])
        assert np.array_equal(got[mc, N.REC_MVX0:N.REC_LOG2WD + 1],
                              rec[mc, N.REC_MVX0:N.REC_LOG2WD + 1])
        tu = ~mc & (rec[:, N.REC_KIND] != N.KIND_PCM)
        for col in (N.REC_MODE, N.REC_QP, N.REC_MTX):
            assert np.array_equal(got[tu, col], rec[tu, col]), col
        # each record's levels (a TU's block, a PCM block's samples)
        for r, g in zip(rec, got):
            n = r[N.REC_W] * (r[N.REC_H] if r[N.REC_KIND] == N.KIND_PCM
                              else r[N.REC_W])
            if r[N.REC_KIND] == N.KIND_MC or r[N.REC_LVL] < 0:
                assert r[N.REC_KIND] == N.KIND_MC or g[N.REC_LVL] < 0
                continue
            assert np.array_equal(glvl[g[N.REC_LVL]:g[N.REC_LVL] + n],
                                  lvl[r[N.REC_LVL]:r[N.REC_LVL] + n])


def test_lazy_planes_return_one_plane_for_monochrome():
    flat = torch.arange(12, dtype=torch.uint8)
    lp = LazyPlanes((flat, ((3, 4),)))
    assert len(lp) == 1
    assert np.array_equal(lp[0], np.arange(12, dtype=np.uint8)
                          .reshape(3, 4))
