"""The encoder's ``source_bit_depth``: an 8-bit source coded at 10 bits is
the same stream as the source shifted up by hand; the variance rule splits
it as it splits the 8-bit source; and at its default the option leaves
every stream's bytes as they were."""
import hashlib

import numpy as np
import pytest
from torch_streams import CONFIGS, INLINE_ONLY, encode_config

from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder, RaEncoder
from hevc_tpu_torch.encoder.generate import synth_frame


def _frames(w, h, n, kind="noise"):
    return [synth_frame(kind, w, h, t, seed=5) for t in range(n)]


def _encode(frames, **kw):
    cfg = EncoderConfig(**kw)
    if cfg.gop == "ra":
        return bytes(RaEncoder(cfg).encode(frames))
    enc = IntraEncoder(cfg)
    return b"".join(enc.encode_frame(f) for f in frames)


@pytest.mark.parametrize("kw,n", [
    (dict(width=64, height=48, gop="all_intra"), 2),
    (dict(width=64, height=48, gop="ra", deblocking=True, sao=True,
          search_range=2), 6),
    (dict(width=64, height=64, gop="ipp", chroma_format_idc=2, wpp=True,
          log2_ctb_size=5), 3),
], ids=["intra", "ra_filters", "ipp_422_wpp"])
def test_an_8_bit_source_codes_as_the_same_planes_shifted_by_hand(kw, n):
    frames = _frames(kw["width"], kw["height"], n)
    shifted = [[p.astype(np.int32) << 2 for p in f] for f in frames]
    got = _encode(frames, qp=30, bit_depth=10, source_bit_depth=8, **kw)
    want = _encode(shifted, qp=30, bit_depth=10, **kw)
    assert got == want


def _splits(frames, **kw):
    """The CU split decisions of an intra encode, in coding order."""
    got = []
    enc = IntraEncoder(EncoderConfig(split_policy="variance", **kw))
    orig = enc._want_cu_split

    def record(*a):
        got.append(orig(*a))
        return got[-1]

    enc._want_cu_split = record
    for f in frames:
        enc.encode_frame(f)
    return got


def test_the_variance_rule_splits_a_shifted_source_as_at_its_own_depth():
    kw = dict(width=128, height=64, qp=32, log2_ctb_size=6, log2_cu_size=6)
    frames = _frames(128, 64, 1, "gradient")
    at_8 = _splits(frames, **kw)
    assert True in at_8 and False in at_8
    assert _splits(frames, bit_depth=10, source_bit_depth=8, **kw) == at_8
    # the rule measures in the coded depth's units without the option
    shifted = [[p.astype(np.int32) << 2 for p in f] for f in frames]
    assert _splits(shifted, bit_depth=10, **kw) != at_8


# the parent encoder's bytes of three test streams (two at 8 bits, one at
# 10 bits from planes shifted by hand) and of main1080's settings at 128x64
PINNED = {
    "ipp_wpp":
        "db53974a6ce6f0752063795d83a42a2e1d33e94b428932b19983dff463dd0e02",
    "main10_422_filters":
        "351b3d97c23175cdf68b87eece7e146335b8409f848c27fd8615e5f753862c13",
    "ra_filters":
        "bff23802773f3256dd84f36ef075b8f01c9f207431c19e6716ed12483326b9c2",
}


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_default_leaves_a_test_stream_unchanged(name):
    kw, n = {**CONFIGS, **INLINE_ONLY}[name]
    assert EncoderConfig(**kw).source_bit_depth == 0
    assert hashlib.sha256(encode_config(kw, n)).hexdigest() == PINNED[name]


def test_the_default_leaves_the_main1080_variance_stream_unchanged():
    from benchmark import bank, make_bank
    cfg = bank.config("main1080")
    cfg["encoder"].update(width=128, height=64)
    mix = dict(bank.traffic("ra"), pictures=6)
    data = b"".join(make_bank.encode_segment(cfg, mix, 1))
    assert hashlib.sha256(data).hexdigest() == (
        "407fa2486050449297ecd6cc7119b8896ce5a1bee7a51fabb0c31bd26ea2c27a")
