"""The bank matches its SHA-256s, and the seed draws the order of its
segments: the same seed the same order, two seeds two orders, every seed
the same work."""
import glob
import os
import shutil

import pytest

from benchmark import bank

CELLS = [(w["config"], w["traffic"]) for w in bank.manifest()["workloads"]]
# every bank of data/, also one whose cell is out of BENCHMARK.json
BANKS = sorted(tuple(os.path.relpath(os.path.dirname(p), os.path.join(
    bank.HERE, "data")).split(os.sep)) for p in glob.glob(os.path.join(
        bank.HERE, "data", "*", "*", "bank.json")))


def test_every_cell_has_a_bank():
    assert set(CELLS) <= set(BANKS)


@pytest.mark.parametrize("cfg,mix", BANKS)
def test_bank_matches_its_sha256(cfg, mix):
    segs = bank.load_bank(cfg, mix)
    t = bank.traffic(mix)
    assert len(segs) == t["segments"]
    for s in segs:
        assert len(s.aus) == t["pictures"]
        assert s.aus[0][:4] in (b"\x00\x00\x00\x01", b"\x00\x00\x01\x40")


def test_a_changed_byte_fails_the_sha256(tmp_path):
    cfg, mix = CELLS[0]
    d = tmp_path / "bank"
    shutil.copytree(bank.bank_dir(cfg, mix), d)
    p = d / "seg0.hevc"
    data = bytearray(p.read_bytes())
    data[len(data) // 2] ^= 1
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="SHA-256"):
        bank.load_bank(cfg, mix, str(d))


@pytest.mark.parametrize("mix", sorted({m for _, m in CELLS}))
def test_the_seed_draws_the_order(mix):
    t = bank.traffic(mix)
    n = t["segments"]
    big = 2 ** 31 + 12345
    a = bank.draw_sequence(t, n, big)
    assert a == bank.draw_sequence(t, n, big)
    assert a != bank.draw_sequence(t, n, big + 1)
    for seed in (0, 1, big, -7, 2 ** 40):
        seq = bank.draw_sequence(t, n, seed)
        assert sorted(seq) == sorted(a)  # the same work on every seed
        assert len(seq) == n * t["composition"]["rounds"]


def test_feed_loops_over_the_sequence():
    cfg, mix = CELLS[0]
    segs = bank.load_bank(cfg, mix)
    seq = [1, 0]
    it = bank.feed(segs, seq)
    n = sum(len(segs[k].aus) for k in seq)
    got = [next(it) for _ in range(n + 1)]
    assert got[0][:2] == (1, 0) and got[n][:2] == (1, 0)
    assert got[len(segs[1].aus)][:2] == (0, 0)
    assert all(os.path.exists(s.path) for s in segs)
