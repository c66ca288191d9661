"""The native records pass's wavefront level map, one cell per cell of each
plane's minimum block grid, against a per-sample oracle (``pack_host``):

- made-up pictures in every chroma format, at sizes that are multiples of
  8 and not of 64, mixed, with no intra record and all intra: the same
  imeta columns 1-2 (level, fill index) and the same chunk count;
- the records of the port's own decode of 4:2:0 with PCM, 4:2:2, 4:4:4
  and 4:0:0 streams, likewise;
- the cells the pass reports (``pack_map_cells``): the planes with records
  times h4 x w4 where a picture has an intra record, else 0, also through
  ``pack.pack_frame``'s counter;
- threads that pack pictures of two sizes at once get the serial results;
- a record off the grid is refused.
"""
import sys
import threading

import numpy as np
import pytest

from hevc_tpu_torch import native as N
from hevc_tpu_torch import pipeline as PP
from hevc_tpu_torch import trace
from hevc_tpu_torch.decoder import TorchDecoder
from hevc_tpu_torch.native import KIND_INTRA, KIND_MC, REC_KIND, REC_PLANE
from pack_host import SUB, native_pass, oracle_levels, synth_records
from torch_streams import FORMATS, INLINE_ONLY, encode_config

SIZES = ((72, 40), (200, 104))
MIXES = ("mixed", "no_intra", "all_intra")


def expected_cells(rec, width, height):
    """What the pass reports: one h4 x w4 map a plane with records, where
    the picture has an intra record."""
    if not (rec[:, REC_KIND] == KIND_INTRA).any():
        return 0
    return np.unique(rec[:, REC_PLANE]).size * (height // 4) * (width // 4)


def assert_oracle_levels(rec, width, height, fmt, what):
    im, counts = native_pass(rec, width, height, fmt)
    want, chunks = oracle_levels(rec, width, height, *SUB[fmt])
    assert np.array_equal(im[:, 1:3], want), f"{what}: levels"
    assert counts[5] == chunks, f"{what}: chunks"
    assert counts[6] == expected_cells(rec, width, height), f"{what}: cells"


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("fmt", (1, 2, 3, 0),
                         ids=("420", "422", "444", "400"))
def test_block_grid_map_gives_the_per_sample_levels(fmt, mix, size):
    w, h = size
    for seed in range(6):
        rng = np.random.default_rng([fmt, MIXES.index(mix), w, seed])
        rec = synth_records(rng, w, h, fmt, mix)
        kinds = rec[:, REC_KIND]
        if mix == "no_intra":
            assert not (kinds == KIND_INTRA).any()
        if mix == "all_intra":
            assert (kinds == KIND_INTRA).all()
        assert_oracle_levels(rec, w, h, fmt, f"seed {seed}")


def test_made_up_pictures_hold_every_block_shape():
    """Mixed 4:2:0 pictures hold 8x4 and 4x8 PUs (2-sample chroma blocks),
    PCM, and intra blocks of 4 to 32 in luma and chroma."""
    rec = np.concatenate([synth_records(np.random.default_rng([1, s]), 200,
                                        104, 1) for s in range(6)])
    mc = rec[rec[:, REC_KIND] == KIND_MC]
    shapes = {(int(w), int(h)) for w, h in mc[mc[:, REC_PLANE] > 0, 4:6]}
    assert {(2, 4), (4, 2)} <= shapes
    assert (rec[:, REC_KIND] == N.KIND_PCM).any()
    intra = rec[rec[:, REC_KIND] == KIND_INTRA]
    for p in (0, 1):
        sizes = set(intra[(intra[:, REC_PLANE] > 0) == p, 4].tolist())
        assert sizes == {4, 8, 16, 32} if p == 0 else {4, 8, 16}


STREAMS = {
    "pcm_420": FORMATS["pcm"],
    "main10_422": lambda: encode_config(*INLINE_ONLY["main10_422"]),
    "ccp_444": FORMATS["rext_ccp"],
    "mono_inter": FORMATS["mono_inter_sao"],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decoded_records_give_the_per_sample_levels(name):
    """The records of every picture of the port's own CPU decode."""
    pics = []
    orig = PP.finish_frame

    def finish(pic, *args):
        rec, _lvl = N._concat_chunks(pic.native_chunks)
        pics.append((np.array(rec), pic.sps))
        return orig(pic, *args)

    PP.finish_frame = finish
    try:
        frames = TorchDecoder(check_md5=True,
                              device="cpu").decode_bytes(STREAMS[name]())
    finally:
        PP.finish_frame = orig
    assert frames and all(f.md5_ok for f in frames)
    assert pics
    for k, (rec, sps) in enumerate(pics):
        assert_oracle_levels(rec, sps.width, sps.height,
                             sps.chroma_format_idc, f"{name} picture {k}")


def test_pack_frame_counts_the_map_cells():
    """``pack_frame`` adds each picture's cells to ``pack_map_cells``: 0
    for a P picture with no intra record."""
    seen = []
    orig = PP.pack_frame

    def pack(pic):
        before = trace.report().get("pack_map_cells", {"total": 0})["total"]
        out = orig(pic)
        after = trace.report()["pack_map_cells"]["total"]
        rec, _lvl = N._concat_chunks(pic.native_chunks)
        seen.append((after - before,
                     expected_cells(rec, pic.sps.width, pic.sps.height)))
        return out

    PP.pack_frame = pack
    try:
        frames = TorchDecoder(check_md5=True, device="cpu").decode_bytes(
            encode_config(*INLINE_ONLY["tmvp"]))
    finally:
        PP.pack_frame = orig
    assert frames and all(f.md5_ok for f in frames)
    assert [got for got, _ in seen] == [want for _, want in seen]
    assert seen[0][0] == 3 * (64 // 4) * (64 // 4)  # the I picture
    assert any(got == 0 for got, _ in seen)


def test_concurrent_packs_get_the_serial_results():
    """Threads, more than the cores, pack a 1080p and a 720p picture in
    turn: each keeps its own map, reset for each picture."""
    pics = [(synth_records(np.random.default_rng([7, w]), w, h, 1), w, h)
            for w, h in ((1920, 1080), (1280, 720))]
    serial = [native_pass(rec, w, h, 1) for rec, w, h in pics]
    for (rec, w, h), (im, counts) in zip(pics, serial):
        assert counts[6] == 3 * (h // 4) * (w // 4)
    bad, done = [], []

    def work(k):
        for i in range(12):
            j = (k + i) % 2
            rec, w, h = pics[j]
            im, counts = native_pass(rec, w, h, 1)
            if not (np.array_equal(im, serial[j][0])
                    and np.array_equal(counts, serial[j][1])):
                bad.append((k, i))
        done.append(k)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(12)) and not bad


def test_a_record_off_the_block_grid_is_refused():
    rec = synth_records(np.random.default_rng(3), 72, 40, 1, "all_intra")
    native_pass(rec, 72, 40, 1)
    rec[0, N.REC_X] += 2  # luma: 4-sample grid
    with pytest.raises(RuntimeError, match="rc=-6"):
        native_pass(rec, 72, 40, 1)
