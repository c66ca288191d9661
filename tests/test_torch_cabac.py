"""The port's CABAC engine (hevc_tpu_torch/cabac/rows.py) against the JAX
package's Pallas kernel in interpret mode and against the Python engine's
bins, bit for bit (tolerance 0): on random encoder rows, on rows of one bin
kind, on the shape grid the card tests hold the CUDA kernel to, on rows of
unequal length, and on every substream captured from a small WPP IPP
stream; the kernel's step table against the engine's three tables, and the
chain bound's terms."""
import os
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from hevc_tpu.encoder.core import EncoderConfig, IntraEncoder  # noqa: E402
from hevc_tpu.encoder.generate import synth_frame  # noqa: E402
from hevc_tpu.tpu.cabac_pallas import (BYPASS, TERMINATE,  # noqa: E402
                                       decode_rows_pallas)
from hevc_tpu_torch.cabac import rows as cabac  # noqa: E402
from hevc_tpu_torch.cabac.engine import (RANGE_TAB_LPS,  # noqa: E402
                                         TRANS_IDX_LPS, TRANS_IDX_MPS)
from hevc_tpu_torch.decoder import core  # noqa: E402

CPU = torch.device("cpu")


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


@pytest.mark.parametrize("q", range(4))
def test_step_table_unpacks_to_the_engines_tables(q):
    """One word a bin: rangeTabLps, the state after an LPS (valMps flipped
    at pStateIdx 0), the state after an MPS and the renormalisation shift
    after an LPS, for all 128 states of one range quarter; then the
    pseudo-states of terminate and bypass bins."""
    tab = cabac.cabac_step_table(CPU)
    assert tab.dtype == torch.int32 and tab.shape == (132 * 4,)
    for s in range(128):
        w, p, mps = int(tab[s * 4 + q]), s >> 1, s & 1
        rlps = w & 0xFF
        assert rlps == RANGE_TAB_LPS[p][q]
        lps, nxt = (w >> 8) & 0xFF, (w >> 16) & 0xFF
        assert lps >> 1 == TRANS_IDX_LPS[p] and nxt >> 1 == TRANS_IDX_MPS[p]
        assert lps & 1 == (1 - mps if p == 0 else mps) and nxt & 1 == mps
        assert 256 <= rlps << (w >> 24) < 512
    for s, rlps in ((cabac.TERMINATE_STATE, 2), (cabac.BYPASS_STATE, 0)):
        assert s >= 128 and s % 2 == 0
        assert int(tab[s * 4 + q]) == rlps | s << 8 | s << 16
    assert int(tab[129 * 4 + q]) == int(tab[131 * 4 + q]) == 0
    # the slots of the pseudo-states lie past every context slot
    assert cabac.BYPASS & 255 == 255 and cabac.TERMINATE & 255 == 254
    assert cabac.N_CTX <= cabac.MAX_CTX == 254


def test_kernel_constants_mirror_the_cuda_source():
    path = os.path.join(os.path.dirname(cabac.__file__), os.pardir, "csrc",
                        "cabac.cu")
    src = open(path).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kChunk"]) == cabac.CHUNK
    assert int(consts["kBlocksPerSm"]) == cabac.BLOCKS_PER_SM
    assert int(consts["kMaxCtx"]) == cabac.MAX_CTX + 2
    assert int(consts["kTerminateState"]) == cabac.TERMINATE_STATE
    assert int(consts["kBypassState"]) == cabac.BYPASS_STATE
    assert int(re.search(r"kStepWords = (\d+) \* 4;", src).group(1)) * 4 \
        == cabac.cabac_step_table(CPU).numel()


def _all_three_agree(rows, data, sched, init):
    got = cabac.decode_rows_plain(data, sched, init)
    for k, r in enumerate(rows):
        assert got[k, :len(r.bins)].tolist() == r.bins, f"row {k}"
    assert np.array_equal(got.numpy(), _jax(data, sched, init))
    assert torch.equal(cabac.decode_rows(data, sched, init), got)


@pytest.mark.parametrize("name,mix,kinds", [
    ("context", (1.0, 0.0), {0}), ("bypass", (0.0, 1.0), {BYPASS}),
    ("terminates", (0.4, 0.4), {0, BYPASS, TERMINATE}),
    ("mixed", (0.70, 0.25), {0, BYPASS, TERMINATE})])
def test_rows_of_one_kind_plain_equals_jax_and_encoder(name, mix, kinds):
    rng = np.random.default_rng(len(name))
    rows = cabac.random_rows(rng, 3, 150, init_types=(0, 1, 2), mix=mix)
    data, sched, init, _ = cabac.pack_rows(rows)
    assert {min(int(v), 0) for v in sched.unique()} == kinds
    if name == "terminates":
        assert int((sched == TERMINATE).sum()) > 3 * 150 // 10
    _all_three_agree(rows, data, sched, init)


@pytest.mark.parametrize("R,n_bins", cabac.SHAPE_GRID)
def test_shape_grid_plain_equals_jax_and_encoder(R, n_bins):
    """The grid tests/test_torch_cuda.py holds the CUDA kernel to, so that
    its oracle, the plain version, is itself held to the JAX kernel."""
    rows, data, sched, init, lens = cabac.ragged_rows(R, n_bins)
    assert sched.shape == (R, n_bins) and data.shape[1] % 16 == 1
    assert R < 3 or int(lens.min()) < n_bins
    _all_three_agree(rows, data, sched, init)


def test_chain_bound_counts_the_longest_rows_bins():
    sched = torch.tensor([[0, 5, BYPASS, TERMINATE],
                          [3, 3, 3, BYPASS],
                          [BYPASS, BYPASS, BYPASS, BYPASS]], dtype=torch.int32)
    b = cabac.chain_bound(sched, smem_clocks=30.0, alu_clocks=5.0,
                          clock_mhz=2000.0, resident_rows=4)
    # a context bin: 1 round trip and 9 instructions; bypass 3; terminate 6
    assert cabac.CHAIN == {"context": (1, 9), "bypass": (0, 3),
                           "terminate": (0, 6)}
    assert b["bins"] == (3, 1, 0) and b["waves"] == 1
    assert b["clocks"] == 3 * (30 + 9 * 5) + 3 * 5
    assert b["ms"] == pytest.approx(b["clocks"] / 2000.0e3, rel=1e-12)


@pytest.mark.parametrize("R,resident,waves", [(4, 4, 1), (5, 4, 2),
                                              (9, 4, 3)])
def test_chain_bound_takes_a_wave_per_resident_set(R, resident, waves):
    sched = torch.full((R, 7), BYPASS, dtype=torch.int32)
    b = cabac.chain_bound(sched, 30.0, 5.0, 1000.0, resident)
    assert b["waves"] == waves and b["bins"] == (0, 7, 0)
    assert b["ms"] == pytest.approx(waves * 7 * 15 / 1000.0e3, rel=1e-12)


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
