"""The benchmark's configuration ``main10_2160`` (HEVC Main 10, 4:2:0,
64x64 CTBs, WPP, deblocking and SAO, an 8-bit source coded at 10 bits)
under the ``ra`` traffic mix, cut only in width and height: 256x144 has a
partial CTB row.  ``make_bank`` takes the configuration; the port decodes
it through its API on the CPU as the benchmark's plain reference does,
plane for plane; the ``d2h_bytes`` counter reads the bytes of the
planes fetched; and the cell ``main2160.ra`` on that bank is correct in a
traced run, which reads the bytes fetched, and not correct under the
control."""
import dataclasses

import numpy as np
import pytest

from benchmark import bank, check, make_bank, refcache, run
from benchmark.control import ControlProgram
from benchmark.program import Program
from hevc_tpu_torch import trace

SIZE = {"width": 256, "height": 144}
PICTURES = 8


def _cfg_mix(config, size, pictures):
    cfg = bank.config(config)
    cfg["encoder"].update(size)
    mix = dict(bank.traffic("ra"), segments=1, pictures=pictures)
    return cfg, mix


@pytest.fixture(scope="module")
def main10_bank(tmp_path_factory):
    """One segment of the configuration at 256x144 through ``make_bank``,
    which checks every picture against its SEI MD5 in the reference (its
    digests kept apart from the checkout's)."""
    cfg, mix = _cfg_mix("main10_2160", SIZE, PICTURES)
    out = str(tmp_path_factory.mktemp("bank"))
    build, bank.BUILD = bank.BUILD, str(tmp_path_factory.mktemp("build"))
    try:
        meta = make_bank.make("main10_2160", "ra", "test", 1, cfg=cfg,
                              mix=mix, out=out)
    finally:
        bank.BUILD = build
    return meta, bank.load_bank("main10_2160", "ra", out)[0]


def _decode(aus):
    prog = Program(1, "cpu")
    pics = []
    for pts, au in enumerate(aus):
        pics += prog.decode(au, pts)
    return pics + prog.close()


def test_the_bank_path_takes_the_configuration(main10_bank):
    meta, seg = main10_bank
    enc = meta["segments"][0]["encoder"][0]
    assert (enc["bit_depth"], enc["source_bit_depth"]) == (10, 8)
    assert (enc["width"], enc["height"]) == (256, 144)
    assert enc["gop"] == "ra" and enc["wpp"] and enc["log2_ctb_size"] == 6
    assert len(seg.aus) == PICTURES


def test_the_port_decodes_the_configuration_as_the_reference(main10_bank):
    _, seg = main10_bank
    pics = _decode(seg.aus)
    assert {bd for _, _, bd in pics} == {10}
    luma = np.concatenate([p[0].ravel() for _, p, _ in pics])
    assert luma.dtype == np.uint16 and luma.max() > 255
    assert (luma % 4).any()  # decoded values past the shifted source's
    delivered = {}
    for pts, planes, bd in pics:
        assert [p.shape for p in planes] == [(144, 256), (72, 128),
                                             (72, 128)]
        delivered.setdefault(pts, []).append(check.plane_digests(planes, bd))
    ref = {0: refcache.segment_digests(list(seg.aus), 0)}
    numbers, _ = check.judge([(0, i) for i in range(PICTURES)], delivered,
                             ref)
    assert numbers == {"planes_wrong": 0, "pictures_missing": 0}


@pytest.fixture(scope="module")
def main_aus():
    cfg, mix = _cfg_mix("main1080", {"width": 128, "height": 64}, 6)
    return make_bank.encode_segment(cfg, mix, 0)


@pytest.mark.parametrize("depth", [8, 10])
def test_d2h_bytes_counts_the_planes_fetched(depth, main10_bank, main_aus):
    aus = main10_bank[1].aus if depth == 10 else main_aus
    trace.reset()
    pics = _decode(aus)
    got = trace.report()["d2h_bytes"]
    fetched = sum(p.nbytes for _, planes, _ in pics for p in planes)
    assert len(pics) == len(aus)
    samples = sum(p.size for _, planes, _ in pics for p in planes)
    assert got["total"] == fetched == samples * (1 if depth == 8 else 2)
    assert got["calls"] == len(pics)


@pytest.fixture
def cell(main10_bank, tmp_path, monkeypatch):
    """``main2160.ra`` on the bank's one segment, the reference's digests
    kept apart from the checkout's."""
    monkeypatch.setattr(bank, "BUILD", str(tmp_path))
    _, mix = _cfg_mix("main10_2160", SIZE, PICTURES)
    return dataclasses.replace(
        run.load_cell("main2160.ra"), segments=[main10_bank[1]], mix=mix,
        out_bytes=SIZE["width"] * SIZE["height"] * 3)


def test_a_traced_run_is_correct_and_reads_the_fetched_bytes(cell):
    r = run.run_cell(cell, 2 ** 31 + 2161, 2.0, True, device="cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    d2h = r["metrics"]["d2h_bytes_per_picture"]
    assert d2h["unit"] == "bytes/picture"
    # at most a 2-byte picture for each access unit handed in: the reorder
    # delay and the pack worker hold some back when the spans are read
    assert 0 < d2h["value"] <= SIZE["width"] * SIZE["height"] * 3
    # the intra kernel runs only on the card
    assert "intra_launches_per_picture" not in r["metrics"]


def test_the_control_is_not_correct(cell):
    r = run.run_cell(cell, 2 ** 31 + 2162, 2.0, False, device="cpu",
                     make_program=ControlProgram)
    assert not r["correct"]
    assert r["checks"]["planes_wrong"]["value"] > 0
