"""The port's CABAC engine (hevc_tpu_torch/cabac/rows.py) against the JAX
package's Pallas kernel in interpret mode and against the Python engine's
bins, bit for bit (tolerance 0): on random encoder rows, on rows of unequal
length, and on every substream captured from a small WPP IPP stream."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder  # noqa: E402
from hevc_tpu.encoder.generate import synth_frame  # noqa: E402
from hevc_tpu.tpu.cabac_pallas import (BYPASS, TERMINATE,  # noqa: E402
                                       decode_rows_pallas)
from hevc_tpu_torch.cabac import rows as cabac  # noqa: E402
from hevc_tpu_torch.decoder import core  # noqa: E402


def _jax(data, sched, init):
    return np.asarray(decode_rows_pallas(
        data.numpy(), sched.numpy(), init.numpy(), n_bins=sched.shape[1],
        n_ctx=init.shape[1], n_bytes=data.shape[1], interpret=True))


def _stream(w=256, h=128, frames=2, **kw):
    enc = IntraEncoder(EncoderConfig(
        width=w, height=h, qp=30, log2_ctb_size=5, log2_cu_size=5,
        deblocking=True, sao=True, seed=1, gop="ipp", search_range=3,
        wpp=True, **kw))
    base = synth_frame("gradient", w, h, 0, seed=9)
    return b"".join(enc.encode_frame(
        [np.roll(p, (t * 2, t * 3), (0, 1)) for p in base])
        for t in range(frames))


@pytest.fixture(scope="module")
def captured():
    return cabac.capture_substreams(_stream())


def test_constants_match_the_jax_package():
    assert (cabac.BYPASS, cabac.TERMINATE) == (BYPASS, TERMINATE)
    assert cabac.N_CTX == 178


def test_random_rows_plain_equals_jax_and_encoder():
    rng = np.random.default_rng(11)
    rows = cabac.random_rows(rng, 4, 400, init_types=(0, 1, 2))
    data, sched, init, lens = cabac.pack_rows(rows)
    assert lens.tolist() == [400] * 4
    got = cabac.decode_rows_plain(data, sched, init)
    assert got.dtype == torch.int32 and got.shape == (4, 400)
    for k, r in enumerate(rows):
        assert got[k].tolist() == r.bins, f"row {k} != encoder bins"
    assert np.array_equal(got.numpy(), _jax(data, sched, init))
    assert torch.equal(cabac.decode_rows(data, sched, init), got)


def test_unequal_rows_padded_plain_equals_jax():
    rng = np.random.default_rng(3)
    rows = [cabac.random_rows(rng, 1, n, init_types=(t,))[0]
            for n, t in ((50, 0), (400, 1), (173, 2), (1, 1))]
    data, sched, init, lens = cabac.pack_rows(rows)
    assert sched.shape == (4, 400) and lens.tolist() == [50, 400, 173, 1]
    assert (sched[0, 50:] == BYPASS).all() and (data[3, 2:] == 0).all()
    got = cabac.decode_rows_plain(data, sched, init)
    for k, r in enumerate(rows):
        assert got[k, :len(r.bins)].tolist() == r.bins, f"row {k}"
    # the padding's bins follow the same semantics in both
    assert np.array_equal(got.numpy(), _jax(data, sched, init))


def test_plain_n_bins_decodes_a_prefix():
    rows = cabac.random_rows(np.random.default_rng(1), 3, 120)
    data, sched, init, _ = cabac.pack_rows(rows)
    full = cabac.decode_rows_plain(data, sched, init)
    assert torch.equal(cabac.decode_rows_plain(data, sched, init, 37),
                       full[:, :37])


@pytest.mark.parametrize("bad", [-3, cabac.N_CTX])
def test_schedule_entries_are_checked(bad):
    data, sched, init, _ = cabac.pack_rows(
        cabac.random_rows(np.random.default_rng(2), 2, 30))
    sched[1, 7] = bad
    with pytest.raises(ValueError, match="schedule entry"):
        cabac.decode_rows(data, sched, init)


def test_capture_rows_are_the_wpp_substreams(captured):
    # 128 / 32 = 4 CTB rows per frame, one engine each, 2 frames
    assert len(captured) == 8
    for r in captured:
        assert r.sched[-1] == TERMINATE and r.bins[-1] == 1
        assert len(r.init) == cabac.N_CTX and len(r.sched) == len(r.bins)
        assert set(r.sched) - set(range(cabac.N_CTX)) <= {BYPASS, TERMINATE}


def test_capture_plain_reproduces_every_substream(captured):
    data, sched, init, lens = cabac.pack_rows(captured)
    got = cabac.decode_rows_plain(data, sched, init)
    for k, r in enumerate(captured):
        assert got[k, :lens[k]].tolist() == r.bins, f"substream {k}"
    assert np.array_equal(got.numpy(), _jax(data, sched, init))


def test_capture_restores_the_decoder_even_when_it_raises(monkeypatch):
    before = (core.CabacDecoder, core._NATIVE_SLICE, core._NATIVE_RESIDUAL)
    seen = []

    def boom(self, data):
        seen.append((core.CabacDecoder, core._NATIVE_SLICE,
                     core._NATIVE_RESIDUAL))
        raise ValueError("decode failed")

    monkeypatch.setattr(core.Decoder, "decode_bytes", boom)
    with pytest.raises(ValueError, match="decode failed"):
        cabac.capture_substreams(b"")
    rec, nat_slice, nat_resid = seen[0]
    assert issubclass(rec, before[0]) and rec is not before[0]
    assert nat_slice is False and nat_resid is False
    assert (core.CabacDecoder, core._NATIVE_SLICE,
            core._NATIVE_RESIDUAL) == before


def test_capture_refuses_pcm():
    before = (core.CabacDecoder, core._NATIVE_SLICE, core._NATIVE_RESIDUAL)
    with pytest.raises(RuntimeError, match="PCM"):
        cabac.capture_substreams(_stream(64, 64, 1, pcm="all"))
    assert (core.CabacDecoder, core._NATIVE_SLICE,
            core._NATIVE_RESIDUAL) == before
