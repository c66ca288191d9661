"""The CUDA kernels (hevc_tpu_torch/csrc/*.cu) against their plain PyTorch
versions on the card, bit for bit, on the parametrisation of
tests/test_mc_pallas.py plus padding rows, and one launch each for a
picture's mixed MC groups and all four residual classes; whole streams,
SHVC, the CABAC and probe kernels; the banded decode (a multi-slice PCM
stream among them), the frame axis and the banded decode across processes
over NCCL on every card; the sparse (COO) level upload; the intra
wavefront kernel on the seeded random cases of hevc_tpu_torch.intra_cases;
the loop filter kernels on the cases of hevc_tpu_torch.filter_cases and on
1080p pictures of the benchmark's banks; the residual-stage kernel on the
cases of hevc_tpu_torch.resid_cases and on pictures of the banks, one
launch a frame program.
Needs a card (marker `cuda`); skips without one.  This file imports only
the port (no JAX, no hevc_tpu), so it runs on a machine that has only
torch.  Run it with JAX kept off the card:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cuda.py

(tests/conftest.py asks JAX for its devices, which starts every backend
JAX finds: without JAX_PLATFORMS=cpu a JAX CUDA client may take most of
the card; the ``card`` fixture fails then.)

The NumPy case generators here are shared with tests/test_torch_mc.py."""
import os

import numpy as np
import pytest
import torch

from hevc_tpu_torch import (build, filter_cases, filters, intra, intra_cuda,
                            mc_cuda, pipeline, recon, resid_cases, trace)
from hevc_tpu_torch.intra_cases import random_case
from hevc_tpu_torch.mc import mc_plain, resid_add_plain
from hevc_tpu_torch.pack import DUMP, DUMP16, PAD_REF
from hevc_tpu_torch.tables import tables_from_reference

CPU = torch.device("cpu")
RH, RW, CH, CW, NREF = 96, 160, 160, 260, 2

MC_CASES = [  # is_ch, bi, w, h, bd, wp
    (False, False, 16, 8, 8, False),
    (False, True, 8, 16, 8, False),
    (False, False, 4, 4, 10, False),
    (True, False, 8, 4, 8, False),
    (True, True, 4, 8, 10, False),
    (False, True, 32, 24, 8, False),
    (False, False, 16, 8, 8, True),
    (False, True, 8, 8, 8, True),
    (True, False, 8, 4, 10, True),
    (True, True, 4, 8, 8, True),
]


def _refs(rng, bd):
    return rng.integers(0, (1 << bd) - 1,
                        (NREF, RH + 2 * PAD_REF, RW + 2 * PAD_REF),
                        dtype=np.int64).astype(np.int32)


def _prod_rows(rng, n_blk, bi, w, h, ntaps, wp, bd, fracs=None):
    """Random non-overlapping production rows [N, 17] (pipeline layout)."""
    cols = max(1, CW // (w + 8))
    nfrac = 4 if ntaps == 8 else 8
    rows = np.zeros((n_blk, 17), np.int32)
    for i in range(n_blk):
        for p in range(2 if bi else 1):
            fx, fy = fracs if fracs is not None else rng.integers(0, nfrac, 2)
            rows[i, 5 * p:5 * p + 5] = (
                rng.integers(0, NREF),
                rng.integers(0, RH + 2 * PAD_REF - h - ntaps),
                rng.integers(0, RW + 2 * PAD_REF - w - ntaps), fx, fy)
        rows[i, 10] = 8 + (i // cols) * (h + 8)
        rows[i, 11] = 8 + (i % cols) * (w + 8)
        if wp:
            lwd = 6 + 14 - bd
            rows[i, 12:17] = (rng.integers(50, 80),
                              int(rng.integers(-8, 8)) << (bd - 8),
                              rng.integers(50, 80),
                              int(rng.integers(-8, 8)) << (bd - 8), lwd)
    return rows


def _legacy_fields(rows, bi, wp):
    """Production rows -> tpu/mc.py fields [N, 7|12 (+5 wp)]."""
    npred = 10 if bi else 5
    cols = list(range(npred)) + [10, 11] + (list(range(12, 17)) if wp
                                             else [])
    return rows[:, cols]


def _resid_case(cls, bd, n_pad=0):
    rng = np.random.default_rng(cls * 17 + bd)
    s = 4 << cls
    ch, cw = 160, 220
    n_blk = 6
    pool = rng.integers(-200, 200, (n_blk + 2, s, s),
                        dtype=np.int64).astype(np.int32)
    pool[0] = 0
    canvas = rng.integers(0, (1 << bd) - 1, (ch, cw),
                          dtype=np.int64).astype(np.int32)
    cols = max(1, cw // (s + 8))
    rows = [(8 + (i // cols) * (s + 8), 8 + (i % cols) * (s + 8),
             int(rng.integers(0, n_blk + 2))) for i in range(n_blk)]
    rows += [(DUMP, DUMP, 0)] * n_pad
    fields = [np.zeros((0, 3), np.int32) for _ in range(4)]
    fields[cls] = np.asarray(rows, np.int32)
    pools = [np.zeros((1, 4 << c, 4 << c), np.int32) for c in range(4)]
    pools[cls] = pool
    return canvas, fields, pools


def _mixed_mc(rng, bd=8):
    """(canvas, refs, groups, bd): groups as the JAX pack hands them to
    ``_mc_tile_phase`` (a kind's fractions are the kind's: 0 full-pel, 1
    horizontal, 2 vertical) — one block class split over two kinds, luma and
    chroma, uni and bi, odd chroma widths, padding rows (cy = cx =
    DUMP16) in every group, and blocks that straddle the canvas edges.
    Blocks of all groups are pixel-disjoint."""
    shapes = [  # is_ch, bi, wp, kind, w, h
        (False, False, False, 1, 16, 16), (False, False, False, 3, 16, 16),
        (False, True, False, 3, 8, 8), (False, True, True, 0, 32, 24),
        (False, False, False, 3, 64, 16), (True, False, False, 2, 2, 4),
        (True, True, False, 3, 6, 16), (True, False, True, 3, 8, 4)]
    refs = _refs(rng, bd)
    canvas = rng.integers(0, 1 << bd, (CH, CW)).astype(np.int32)
    groups, y = [], 0
    for k, (is_ch, bi, wp, kind, w, h) in enumerate(shapes):
        rows = _prod_rows(rng, 3, bi, w, h, 4 if is_ch else 8, wp, bd,
                          fracs=((0, 0), (1, 0), (0, 3), None)[kind])
        rows[0, 10:12] = (y, -3 if k == 0 else 0)      # left edge
        rows[1, 10:12] = (y, CW - w + 1)               # right edge
        rows[2, 10:12] = (CH - h + 2 if k == len(shapes) - 1 else y,
                          100)                         # bottom edge
        y += h + 2
        pad = np.zeros((2, 17), np.int32)
        pad[:, 10] = pad[:, 11] = DUMP16
        groups.append((is_ch, bi, wp, kind, w, h,
                       np.concatenate([rows, pad])))
    return canvas, refs, groups, bd


def _mixed_resid(bd, top_left=False):
    """(canvas, fields, pools): TUs of all four classes, disjoint, with
    padding rows (DUMP) in every class and TUs that straddle the canvas
    edge (read from their clamped origin): a 4x4 two rows past the bottom
    edge, an 8x8 one row past the bottom and a 16x16 one column past the
    right edge (the last two read pixels they also write).  ``top_left``
    adds a 4x4 one row and column before the top-left corner: there JAX's
    ``.at[]`` wraps the negative indices around (NumPy style) where the
    port drops them, so only the kernel-vs-plain test takes it."""
    rng = np.random.default_rng(bd)
    ch, cw = 160, 220
    canvas = rng.integers(0, (1 << bd) - 1, (ch, cw),
                          dtype=np.int64).astype(np.int32)
    fields, pools, x = [], [], 0
    for c in range(4):
        s = 4 << c
        pool = rng.integers(-200, 200, (5, s, s),
                            dtype=np.int64).astype(np.int32)
        pool[0] = 0
        rows = [(8, x, 1), (8 + s, x, int(rng.integers(0, 5)))]
        x += s + 4
        rows += [(DUMP, DUMP, 0)] * 2
        fields.append(np.asarray(rows, np.int32))
        pools.append(pool)
    edge = [(0, (ch - 2, cw - 12, 3)), (1, (ch - 7, 100, 4)),
            (2, (100, cw - 15, 1))] + ([(0, (-1, -1, 2))] if top_left else [])
    for c, row in edge:
        fields[c] = np.concatenate([fields[c], np.asarray([row], np.int32)])
    return canvas, fields, pools


def _port_mc(canvas, refs, groups, bd):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    r = t(refs)
    tg = [g[:6] + (t(g[6]),) for g in groups]
    return mc_plain(t(canvas).clone(), r, r, tg, bd,
                    tables_from_reference(CPU)).numpy()


def _port_resid(canvas, fields, pools, bd):
    t = torch.from_numpy
    return resid_add_plain(t(canvas).clone(), [t(f) for f in fields],
                           [t(p) for p in pools], bd).numpy()


@pytest.fixture(scope="session")
def card_memory():
    """(free, total, bytes torch holds) of card 0 when the session's first
    card test starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    free, total = torch.cuda.mem_get_info(0)
    return free, total, torch.cuda.memory_reserved(0)


@pytest.fixture
def card(card_memory):
    """Card 0, once it is clear that no other CUDA client of this process
    (JAX's, started by tests/conftest.py without JAX_PLATFORMS=cpu) holds
    most of it: under half the card free while torch holds nothing fails
    every card test."""
    free, total, held = card_memory
    if held == 0 and free < total / 2:
        pytest.fail(f"another CUDA client holds the card: {free / 2**30:.2f} "
                    f"of {total / 2**30:.2f} GiB free before torch allocated "
                    "anything; run with JAX_PLATFORMS=cpu")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_card_is_not_shared_with_another_cuda_client(card, card_memory):
    free, total, held = card_memory
    print(f"card 0 at the first card test: {free} of {total} bytes free "
          f"({free / total:.3f}), {held} held by torch")
    assert free >= total / 2


@pytest.mark.cuda
@pytest.mark.parametrize("is_ch,bi,w,h,bd,wp", MC_CASES)
def test_mc_kernel_matches_plain_on_card(card, is_ch, bi, w, h, bd, wp):
    rng = np.random.default_rng(hash((is_ch, bi, w, h, bd, wp)) % 2**32)
    rows = _prod_rows(rng, 7, bi, w, h, 4 if is_ch else 8, wp, bd)
    pad = np.zeros((2, 17), np.int32)
    pad[:, 10] = pad[:, 11] = DUMP16
    rows = np.concatenate([rows, pad])
    refs = _refs(rng, bd)
    canvas = rng.integers(0, 1 << bd, (CH, CW)).astype(np.int32)
    r = torch.from_numpy(refs).to(card)
    groups = [(is_ch, bi, wp, 3, w, h, torch.from_numpy(rows).to(card))]
    before = build.launches["mc"]
    got = mc_cuda.mc(torch.from_numpy(canvas).to(card), r, r, groups, bd)
    torch.cuda.synchronize()
    assert build.launches["mc"] == before + 1
    want = _port_mc(canvas, refs, [(is_ch, bi, wp, 3, w, h, rows)], bd)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("cls", [0, 1, 2, 3])
def test_resid_kernel_matches_plain_on_card(card, cls, bd):
    canvas, fields, pools = _resid_case(cls, bd, n_pad=2)
    t = lambda a: torch.from_numpy(a).to(card)  # noqa: E731
    before = build.launches["resid_add"]
    got = mc_cuda.resid_add(t(canvas), [t(f) for f in fields],
                            [t(p) for p in pools], bd)
    torch.cuda.synchronize()
    assert build.launches["resid_add"] == before + 1
    assert np.array_equal(got.cpu().numpy(),
                          _port_resid(canvas, fields, pools, bd))


@pytest.mark.cuda
def test_mc_kernel_one_launch_for_mixed_groups_on_card(card):
    canvas, refs, groups, bd = _mixed_mc(np.random.default_rng(4))
    r = torch.from_numpy(refs).to(card)
    before = build.launches["mc"]
    got = mc_cuda.mc(torch.from_numpy(canvas).to(card), r, r,
                     [g[:6] + (torch.from_numpy(g[6]).to(card),)
                      for g in groups], bd)
    torch.cuda.synchronize()
    assert build.launches["mc"] == before + 1
    assert np.array_equal(got.cpu().numpy(),
                          _port_mc(canvas, refs, groups, bd))


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
def test_resid_kernel_one_launch_for_all_classes_on_card(card, bd):
    canvas, fields, pools = _mixed_resid(bd, top_left=True)
    t = lambda a: torch.from_numpy(a).to(card)  # noqa: E731
    before = build.launches["resid_add"]
    got = mc_cuda.resid_add(t(canvas), [t(f) for f in fields],
                            [t(p) for p in pools], bd)
    torch.cuda.synchronize()
    assert build.launches["resid_add"] == before + 1
    assert np.array_equal(got.cpu().numpy(),
                          _port_resid(canvas, fields, pools, bd))


@pytest.mark.cuda
def test_decoder_launches_each_inter_kernel_once_per_picture_on_card(card):
    """An I, P, P stream through the port's own encoder and decoder: MC
    launches once per P picture, the residual add at most once."""
    from hevc_tpu_torch.decoder import TorchDecoder
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=96, height=80, qp=30, gop="ipp", wpp=True, deblocking=True,
        sao=True, log2_ctb_size=5, log2_cu_size=5, search_range=3, seed=1))
    data = b"".join(enc.encode_frame(synth_frame("noise", 96, 80, t, seed=3))
                    for t in range(3))
    before = dict(build.launches)
    frames = TorchDecoder(check_md5=True, device=card).decode_bytes(data)
    assert [f.md5_ok for f in frames] == [True] * 3
    n = {k: build.launches[k] - before[k] for k in ("mc", "resid_add")}
    assert n["mc"] == 2 and 1 <= n["resid_add"] <= 2, n


# ---------------------------------------------------------------------------
# the loop filter kernels (csrc/filters.cu) against their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(filter_cases.CASES))
def test_loop_filter_kernels_match_plain_on_card(card, name, seed):
    case = filter_cases.make(name, seed)
    err, launches, kept = filter_cases.kernel_errors(case, card)
    torch.cuda.synchronize()
    assert err == 0 and kept, (name, err, kept)
    assert launches == 2 * case["deblock"] + case["sao"]


BANKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "data", "main1080")


@pytest.mark.cuda
@pytest.mark.parametrize("bank", sorted(filter_cases.BANK_PICTURES))
def test_loop_filter_kernels_match_plain_on_bank_pictures_on_card(card,
                                                                  bank):
    """The first access units of each bank's first segment decoded on the
    card with the loop filters' inputs captured: the kernels against the
    plain versions on an IDR, a P and a leaf B (RA, 1080p 8-bit and
    2160p 10-bit) or an IDR (intra)."""
    from hevc_tpu_torch.capture import (bank_prefix, captured_filters,
                                        loop_filter_errors, pick_picture)
    n_aus, kinds, shape = filter_cases.BANK_PICTURES[bank]
    calls = captured_filters(bank_prefix(os.path.join(
        os.path.dirname(BANKS), bank), n_aus), card)
    assert len(calls) == n_aus
    for kind in kinds:
        call = pick_picture(calls, kind)
        assert call["deblock_planes"][0][0][0].shape == shape
        errs = loop_filter_errors(call)
        assert errs == {"deblock_planes": 0, "sao_planes": 0}, (kind, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ipp_wpp", "slices_pcm", "mono",
                                  "main10_422_filters"])
def test_no_picture_reaches_the_plain_filters_on_card(card, monkeypatch,
                                                      name):
    """A stream decoded on the card: three loop filter launches a picture
    that deblocks and applies SAO, and never a plain filter."""
    from torch_streams import CONFIGS, INLINE_ONLY, decode_port, encode_config

    def refused(*_a, **_k):
        raise AssertionError("a plain filter ran on the card's path")

    for fn in ("deblock", "deblock_luma", "sao_plane"):
        monkeypatch.setattr(filters, fn, refused)
    on = {"deblock": 0, "sao": 0}

    def pack(pic):
        out = orig_pack(pic)
        spec = dict(out[6])
        on["deblock"] += 2 * bool(spec["do_deblock"])
        on["sao"] += bool(spec["do_sao"])
        return out

    orig_pack = pipeline.pack_frame
    monkeypatch.setattr(pipeline, "pack_frame", pack)
    build.reset_launches()
    trace.reset()
    frames, n = decode_port(encode_config(*{**CONFIGS, **INLINE_ONLY}[name]),
                            card)
    assert all(md5 is True for _p, md5, _poc in frames) and n == len(frames)
    assert {k: build.launches[k] for k in on} == on and on["deblock"] == 2 * n
    assert trace.report()["loop_filter_launches"]["total"] == \
        on["deblock"] + on["sao"]


# ---------------------------------------------------------------------------
# the residual-stage kernel (csrc/resid.cu) against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(resid_cases.CASES))
def test_residual_kernel_matches_plain_on_card(card, name, seed):
    from hevc_tpu_torch.capture import residual_errors
    err, launches = residual_errors(
        resid_cases.tensors(resid_cases.make(name, seed), card)[:4])
    torch.cuda.synchronize()
    assert (err, launches) == (0, 1), (name, err, launches)


@pytest.mark.cuda
@pytest.mark.parametrize("bank", sorted(resid_cases.BANK_PICTURES))
def test_residual_kernel_matches_plain_on_bank_pictures_on_card(card, bank):
    """The first access units of a bank's first segment decoded on the card
    with the residual stage's inputs captured: the kernel against the plain
    version on an IDR, a P and a leaf B (RA), an IDR (intra), the base
    layer's IDR and an enhancement-layer P (SHVC)."""
    from hevc_tpu_torch.capture import (bank_prefix, captured_residuals,
                                        pick_picture, residual_errors)
    n_aus, picks = resid_cases.BANK_PICTURES[bank]
    calls = captured_residuals(bank_prefix(os.path.join(
        os.path.dirname(BANKS), bank), n_aus), card)
    for kind, layer in picks:
        call = pick_picture([c for c in calls if c["at"][0] == layer], kind)
        assert call["args"][0][0].dtype == torch.int16
        assert residual_errors(call["args"]) == (0, 1), (bank, call["at"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ipp_wpp", "mono", "main10_422_filters",
                                  "rext_ccp", "rext_explicit_rdpcm"])
def test_no_picture_reaches_the_plain_residual_stage_on_card(
        card, monkeypatch, name):
    """A stream decoded on the card: one residual launch a frame program,
    counted by the trace too, and never the plain transforms."""
    from torch_streams import (CONFIGS, FORMATS, INLINE_ONLY, decode_port,
                               encode_config)

    def refused(*_a, **_k):
        raise AssertionError("the plain residual stage ran on the card")

    monkeypatch.setattr(recon, "residual_batch", refused)
    data = FORMATS[name]() if name in FORMATS else \
        encode_config(*{**CONFIGS, **INLINE_ONLY}[name])
    build.reset_launches()
    trace.reset()
    frames, n = decode_port(data, card)
    assert all(md5 is True for _p, md5, _poc in frames) and n == len(frames)
    assert build.launches["resid_tx"] == n
    assert trace.report()["residual_launches"]["total"] == n


# ---------------------------------------------------------------------------
# whole streams of every single-layer format on the card, against the
# port's inline NumPy decoder and the SEI MD5 (tests/torch_streams.py,
# tests/torch_fuzz.py: the CPU tests' streams, made by the port's encoder)
# ---------------------------------------------------------------------------

def _decode_on_card(card, data, name):
    from torch_streams import assert_same, decode_inline, decode_port
    before = dict(build.launches)
    got, n_prog = decode_port(data, card)
    assert_same(decode_inline(data), got, name)
    # every picture ran the frame program on the card
    assert n_prog == len(got), (n_prog, name)
    return {k: build.launches[k] - before[k] for k in ("mc", "resid_add")}


def _stream_cases():
    from torch_streams import CONFIGS, FORMATS, INLINE_ONLY
    return sorted(CONFIGS) + sorted(INLINE_ONLY) + sorted(FORMATS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _stream_cases())
def test_stream_decodes_on_card(card, name):
    from torch_streams import CONFIGS, FORMATS, INLINE_ONLY, encode_config
    if name in FORMATS:
        data = FORMATS[name]()
    else:
        data = encode_config(*{**CONFIGS, **INLINE_ONLY}[name])
    n = _decode_on_card(card, data, name)
    if name in ("ipp_wpp", "inter_gop", "main10_422_filters",
                "mono_inter_sao", "mono_dependent_ipp", "dep_two_dep_ipp"):
        assert n["mc"] > 0 and n["resid_add"] > 0, n


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(56))
def test_fuzz_config_decodes_on_card(card, seed):
    from torch_fuzz import fuzz_stream
    cfg, data = fuzz_stream(seed)
    _decode_on_card(card, data, f"fuzz seed {seed}: {cfg}")


@pytest.mark.cuda
def test_main10_2160_configuration_decodes_on_card(card):
    """The benchmark's ``main10_2160`` settings under its ``ra`` mix, cut
    to 256x144 (4 CTB columns, a partial third CTB row) and 8 pictures:
    the hand kernels at 10 bits, 4:2:0, 64x64 CTBs, WPP, deblocking and
    SAO, bit for bit the inline decoder, every picture through the frame
    program and the intra kernel's counter at its launches."""
    from benchmark import bank, make_bank
    cfg = bank.config("main10_2160")
    cfg["encoder"].update(width=256, height=144)
    mix = dict(bank.traffic("ra"), pictures=8)
    data = b"".join(make_bank.encode_segment(cfg, mix, 0))
    trace.reset()
    before = build.launches["intra"]
    n = _decode_on_card(card, data, "main10_2160 at 256x144")
    assert n["mc"] > 0 and n["resid_add"] > 0, n
    launched = build.launches["intra"] - before
    assert launched > 0
    assert trace.report()["intra_launches"]["total"] == launched


def _shvc_cases():
    from torch_streams import SHVC
    return sorted(SHVC)


@pytest.mark.cuda
@pytest.mark.parametrize("name", _shvc_cases())
def test_shvc_stream_decodes_on_card(card, name):
    """Both layers of a two-layer stream (tests/test_shvc.py and
    tests/test_cgs.py configurations) on the card: equal to the inline
    decoder, every MD5 correct, every picture through the frame program,
    the inter-layer reference built on the card (no reference from the
    host), MC launched at least once per access unit (every EL picture
    is a P picture)."""
    from hevc_tpu_torch import pipeline as PP
    from torch_streams import SHVC, shvc_stream
    PP.host_refs["count"] = 0
    n = _decode_on_card(card, shvc_stream(name), name)
    assert PP.host_refs["count"] == 0, name
    assert n["mc"] >= SHVC[name]()[1], n


# ---------------------------------------------------------------------------
# the CABAC kernel (csrc/cabac.cu) and the probe kernels (csrc/probes.cu)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("R,lengths", [(200, None), (5, (1, 700, 64, 333, 2))])
def test_cabac_kernel_matches_plain_on_card(card, R, lengths):
    from hevc_tpu_torch.cabac import rows as cabac
    rng = np.random.default_rng(R)
    if lengths is None:
        rows = cabac.random_rows(rng, R, 300, init_types=(0, 1, 2))
    else:
        rows = [cabac.random_rows(rng, 1, n, init_types=(k % 3,))[0]
                for k, n in enumerate(lengths)]
    data, sched, init, lens = (t.to(card) for t in cabac.pack_rows(rows))
    before = build.launches["cabac"]
    got = cabac.decode_rows(data, sched, init)
    torch.cuda.synchronize()
    assert build.launches["cabac"] == before + 1
    assert torch.equal(got, cabac.decode_rows_plain(data, sched, init))
    for k, r in enumerate(rows):
        assert got[k, :len(r.bins)].tolist() == r.bins, f"row {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("R,n_bins", [(1, 1), (3, 127), (5, 129), (33, 259)])
def test_cabac_kernel_matches_plain_on_the_shape_grid_on_card(card, R,
                                                              n_bins):
    """Around the kernel's chunk of 128 bins, with rows that start and end
    off every 16-byte boundary, the padding included; and a prefix of the
    schedule (a row stride that is not the bin count)."""
    from hevc_tpu_torch.cabac import rows as cabac
    assert (R, n_bins) in cabac.SHAPE_GRID
    rows, data, sched, init, lens = cabac.ragged_rows(R, n_bins)
    data, sched, init = data.to(card), sched.to(card), init.to(card)
    got = cabac.decode_rows(data, sched, init)
    torch.cuda.synchronize()
    want = cabac.decode_rows_plain(data, sched, init)
    assert torch.equal(got, want)
    for k, r in enumerate(rows):
        assert got[k, :len(r.bins)].tolist() == r.bins, f"row {k}"
    n = max(1, n_bins - 2)
    assert torch.equal(cabac.decode_rows(data, sched, init, n), want[:, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("context_share", [1.0, 0.6])
def test_cabac_kernel_matches_plain_on_arbitrary_input_on_card(
        card, context_share):
    """Random bytes under a random schedule, which no encoder wrote: the
    range leaves [256, 510], a bin eats up to 8 bits (the bitstream ring
    at its fastest), terminate bins of 1 come mid-row and the offset wraps
    through 2^31.  The plain version defines the bins there too."""
    from hevc_tpu_torch.cabac import rows as cabac
    rng = np.random.default_rng(int(context_share * 10))
    R, n_bins, n_bytes = 6, 3001, 2999
    kind = rng.random((R, n_bins))
    sched = np.where(kind < context_share,
                     rng.integers(0, cabac.N_CTX, (R, n_bins)),
                     np.where(kind < 0.9, cabac.BYPASS, cabac.TERMINATE))
    data = rng.integers(0, 256, (R, n_bytes))
    init = rng.integers(0, 126, (R, cabac.N_CTX))
    data, sched, init = (torch.from_numpy(a.astype(np.int32)).to(card)
                         for a in (data, sched, init))
    got = cabac.decode_rows(data, sched, init)
    torch.cuda.synchronize()
    assert torch.equal(got, cabac.decode_rows_plain(data, sched, init))


@pytest.mark.cuda
def test_cabac_kernel_walks_more_rows_than_the_card_holds_on_card(card):
    """One row more than the resident blocks: the grid-stride loop."""
    from hevc_tpu_torch import cabac_cuda
    from hevc_tpu_torch.cabac import rows as cabac
    rows = cabac.random_rows(np.random.default_rng(8), 97, 150,
                             init_types=(0, 1, 2))
    R = cabac_cuda.resident_rows(card) + 1
    assert R == 132 * cabac.BLOCKS_PER_SM + 1 or \
        torch.cuda.get_device_properties(card).multi_processor_count != 132
    rows = [rows[k % 97] for k in range(R)]
    data, sched, init, _ = (t.to(card) for t in cabac.pack_rows(rows))
    got = cabac.decode_rows(data, sched, init)
    torch.cuda.synchronize()
    assert torch.equal(got, cabac.decode_rows_plain(data, sched, init))
    assert got[R - 1].tolist() == rows[R - 1].bins


@pytest.mark.cuda
def test_tma_window_encodes_once_per_plane_and_box_on_card(card):
    from hevc_tpu_torch import probes
    plane = torch.arange(512 * 1408, dtype=torch.int32,
                         device=card).reshape(512, 1408)
    other = plane.clone()
    probes.clear_tensor_maps()
    before = dict(build.launches)
    for oy, ox in ((16, 256), (13, 37), (0, 0), (504, 1280), (16, 256)):
        got = probes.tma_window(plane, (8, 128), (oy, ox), False)
        assert torch.equal(got, plane[oy:oy + 8, ox:ox + 128])
    n = {k: build.launches[k] - before[k] for k in ("tma_window",
                                                     "tma_encode")}
    # the window's box, and the boxes of its plans: bands of 4 rows, of
    # 132 columns at the odd offset
    assert {probes.window_plan((8, 128), o).box for o in
            ((16, 256), (13, 37), (0, 0), (504, 1280))} == {(4, 128),
                                                           (4, 132)}
    assert n == {"tma_window": 5, "tma_encode": 3}
    probes.tma_window(plane, (16, 32), (13, 37), False)   # two more boxes
    probes.tma_window(other, (8, 128), (16, 256), False)  # another plane
    torch.cuda.synchronize()
    assert build.launches["tma_encode"] - before["tma_encode"] == 7


@pytest.mark.cuda
def test_a_refused_box_raises_and_is_not_cached_on_card(card):
    from hevc_tpu_torch import probes
    plane = torch.zeros((512, 1408), dtype=torch.int32, device=card)
    probes.clear_tensor_maps()
    before = dict(build.launches)
    for _ in range(2):      # refused again: the refusal was not kept
        with pytest.raises(probes.TmaRejected, match="CUresult 1"):
            probes.tma_window(plane, (40, 39), (13, 37), False)
    assert probes.tensor_map_key(plane, (40, 39)) not in probes._TENSOR_MAPS
    assert {k: build.launches[k] - before[k]
            for k in ("tma_window", "tma_encode")} == {"tma_window": 0,
                                                       "tma_encode": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("shift", [(3, 37), (-5, 300)])
def test_tile_shift_kernel_matches_plain_on_card(card, mode, shift):
    from hevc_tpu_torch import probes
    x = torch.arange(48 * 256, dtype=torch.int32, device=card).reshape(48, 256)
    s = torch.tensor(shift, dtype=torch.int32, device=card)
    got = probes.tile_shift(x, s, mode)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.tile_shift_plain(x, s, mode))


TILE_SHAPES = [(48, 256), (1, 4), (7, 13), (1088, 1920), (4320, 7680)]


def _tile_shifts(h, w):
    return [(3, 37), (-5, -300), (0, 0), (h, w), (2 * h + 1, 3 * w + 2),
            (-h - 1, w + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", TILE_SHAPES)
def test_tile_shift_kernel_matches_plain_at_every_shape_on_card(card, h, w):
    """Each roll, and each slice where the window fits, at shifts below,
    at and past the tile's size; the last two tiles are over the 227 KB
    the kernel used to stage, the last one over L2."""
    from hevc_tpu_torch import probes
    x = torch.randint(-2**31, 2**31 - 1, (h, w), dtype=torch.int32,
                      device=card)
    sh, sw = probes.SLICE_SHAPE
    modes = [0, 1] if h >= sh and w >= sw else [0]
    for mode in modes:
        for shift in _tile_shifts(h, w):
            s = torch.tensor(shift, dtype=torch.int32, device=card)
            before = build.launches["tile_shift"]
            got = probes.tile_shift(x, s, mode)
            assert build.launches["tile_shift"] == before + 1
            torch.cuda.synchronize()
            assert torch.equal(got, probes.tile_shift_plain(x, s, mode)), \
                (mode, shift)


def _window_grid(seed, n=40):
    """(shape, origin) of seeded windows on the probe's plane: widths a
    multiple of 4 up to 256 (the ones a box takes), half at an aligned and
    half at an odd inner offset, and the widest at both."""
    from hevc_tpu_torch import probes
    H, W = probes.PLANE
    rng = np.random.default_rng(seed)
    out = [((256, 256), (H - 256, W - 256)), ((256, 256), (0, 3)),
           ((8, 256), (5, W - 257)), ((3, 4), (H - 3, 1)), ((1, 4), (0, 0))]
    for k in range(n):
        wh, ww = int(rng.integers(1, 257)), 4 * int(rng.integers(1, 65))
        oy = int(rng.integers(0, H - wh + 1))
        ox = int(rng.integers(0, W - ww + 1))
        ox = ox & ~3 if k % 2 else max(ox - (ox & 3) + 1 + k % 3, 1)
        out.append(((wh, ww), (oy, min(ox, W - ww))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("write", [False, True])
def test_tma_window_matches_plain_on_a_seeded_grid_on_card(card, write):
    from hevc_tpu_torch import probes
    plane = torch.randint(-2**31, 2**31 - 1, probes.PLANE,
                          dtype=torch.int32, device=card)
    refused = []
    for shape, origin in _window_grid(11 + write):
        src = plane.clone()
        want = probes.window_plain(plane.clone(), shape, origin, write)
        plan = probes.window_plan(shape, origin)
        tmap = probes.tensor_map(src, plan.box)  # the plan's box is taken
        try:
            got = probes.tma_window(src, shape, origin, write)
        except probes.TmaRejected:
            # the encoder refused the window's own box (the probe's
            # question); the plan's box moves the window all the same
            refused.append(shape)
            out = src if write else torch.empty_like(want)
            got = probes.launch_tma_window(tmap, plan, write, out)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (shape, origin)
    # what the encoder refuses is a rule of the box, not of the plane
    for shape in refused:
        with pytest.raises(probes.TmaRejected):
            probes.tensor_map(plane, shape)
    print(f"window boxes the encoder refused: {sorted(set(refused))}")


@pytest.mark.cuda
def test_tma_window_outcomes_on_card(card):
    from hevc_tpu_torch import probes
    outcomes = probes.run_probes(card, log=lambda *a: None)
    for c in probes.WINDOW_CASES:
        got = outcomes["tma_window"][c.name]
        if c.name == "rows8, lanes39":
            assert got == ("rejected at encode (CUresult 1 "
                           "CUDA_ERROR_INVALID_VALUE)")
        elif c.origin[1] % 4:
            assert got == ("OK as two aligned boxes; one box: fault, CUDA "
                           "error 715 (an illegal instruction was "
                           "encountered)"), c.name
        else:
            assert got == "OK", c.name
    assert set(outcomes["tile_shift"].values()) == {0}
    assert outcomes["tma_pipe"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4])
def test_one_tma_box_at_an_unaligned_offset_faults_on_card(card, k):
    """The fact the window probe exists to find, in a child process: one
    TMA box at x = 37 int32 (148 B) is an illegal instruction."""
    from hevc_tpu_torch import probes
    assert probes.WINDOW_CASES[k].origin[1] % 4
    assert probes.one_box_outcome(k).startswith("fault, CUDA error 715")


@pytest.mark.cuda
def test_copy_rates_on_card(card):
    """A graph of device copies is exact and gives a rate for every buffer;
    the copies that stay in L2 are faster than the one that does not."""
    from hevc_tpu_torch import probes
    rates = probes.copy_rates(card)
    assert set(rates) == set(probes.L2_BUFFERS) | {probes.HBM_BUFFER}
    assert all(r > 0 for r in rates.values())
    assert max(rates[n] for n in probes.L2_BUFFERS) > rates[probes.HBM_BUFFER]


@pytest.mark.cuda
def test_tma_pipe_kernel_matches_plain_on_card(card):
    from hevc_tpu_torch import probes
    x = torch.randint(-2**31, 2**31 - 1, (1024, 1536), dtype=torch.int32,
                      device=card)
    org = probes.pipe_origins(500, seed=3).to(card)
    got = probes.tma_pipe(x, org)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.pipe_plain(x, org))


# ---------------------------------------------------------------------------
# several devices: the banded decode (sharded.py), the frame axis
# (pgop_frame.py) and the banded decode across processes over NCCL
# ---------------------------------------------------------------------------

def _tile_stream(w, h, n_bands, n_frames, kind, qp, **extra):
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=w, height=h, qp=qp, gop="ipp", deblocking=True, sao=True,
        search_range=3, log2_ctb_size=6, log2_cu_size=6, seed=2,
        tiles=(n_bands, 1), **extra))
    return b"".join(enc.encode_frame(synth_frame(kind, w, h, t, seed=4))
                    for t in range(n_frames))


def _banded_on_cards(data, n_bands):
    """The stream in n_bands bands spread over every card: equal to the
    sequential host decode (every MD5 correct), no reference from the
    host, MC launched once per band of every P picture.  Returns the
    launch counts."""
    from hevc_tpu_torch import band, pipeline, sharded
    frames, ref, halo = band.prepare_gop_banded(data, n_bands)
    assert all(f["md5_ok"] for f in frames)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    layout = sharded.BandLayout.over(n_bands, cards)
    pipeline.host_refs["count"] = 0
    before = dict(build.launches)
    outs = sharded.decode_gop_banded(layout, frames, *halo)
    n = {k: build.launches[k] - before[k] for k in ("mc", "resid_add")}
    assert pipeline.host_refs["count"] == 0
    for i, (out, want) in enumerate(zip(outs, ref)):
        for p, (g, w) in enumerate(zip(sharded.stitch(out), want)):
            bad = np.argwhere(g != w)
            assert not bad.size, (i, p, tuple(bad[0]))
    n_inter = sum(bool(f["ref_pocs_l0"]) for f in frames)
    assert n["mc"] == n_bands * n_inter and n["resid_add"] > 0, n
    return n


@pytest.mark.cuda
def test_banded_1080p_three_bands_on_card(card):
    """The smoke's banded stream: 1920x1080, three column tiles of 640, I P
    P, loop filtering across the tiles."""
    _banded_on_cards(_tile_stream(1920, 1080, 3, 3, "gradient", 30,
                                  lf_across_tiles=True), 3)


@pytest.mark.cuda
def test_banded_2048x1088_eight_bands_on_card(card):
    """tests/test_band_pipeline.py's 1080p-class case: 2048x1088 in eight
    bands of 256 columns, QP 34."""
    _banded_on_cards(_tile_stream(2048, 1088, 8, 3, "gradient", 34), 8)


@pytest.mark.cuda
def test_banded_multislice_1080p_on_card(card):
    """The smoke's formats stream A in 2 bands, one a tile column: 1920x1080,
    4 slices over 2x2 tiles with their own filter offsets (one without
    deblocking, one without loop filtering across its edges), no loop
    filtering across tiles, PCM exempt from the filters; I P P."""
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=1920, height=1080, qp=30, gop="ipp", deblocking=True,
        sao=True, search_range=3, log2_ctb_size=6, log2_cu_size=5, seed=1,
        tiles=(2, 2), slices=4, lf_across_tiles=False,
        slice_filter_params=(dict(beta_offset=2, tc_offset=-2),
                             dict(disable=True), dict(lf_across=False),
                             dict(beta_offset=-4, tc_offset=4)),
        pcm=0.05, pcm_loop_filter_disabled=True))
    data = b"".join(enc.encode_frame(synth_frame("gradient", 1920, 1080, t,
                                                 seed=4)) for t in range(3))
    _banded_on_cards(data, 2)


@pytest.mark.cuda
def test_coo_picture_on_card(card):
    """A 256x192 smooth IPP pair whose level pools ship as (idx, val)
    pairs: ``TorchDecoder`` on the card with every MD5 correct, and each
    picture's frame program on the pairs == on its dense pool."""
    from hevc_tpu_torch import pipeline
    from hevc_tpu_torch.decoder import TorchDecoder
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=256, height=192, qp=30, gop="ipp", deblocking=True, sao=True,
        log2_ctb_size=5, log2_cu_size=5, search_range=2, seed=1))
    data = b"".join(enc.encode_frame(synth_frame("gradient", 256, 192, t,
                                                 seed=3)) for t in range(2))
    calls = []
    orig = pipeline.frame_program

    def program(*args):
        out = orig(*args)
        refs = tuple([r.clone() for r in args[i]] for i in (7, 8, 9))
        calls.append((args[:7] + refs + args[10:], out))
        return out

    pipeline.frame_program = program
    try:
        frames = TorchDecoder(check_md5=True, device=card).decode_bytes(data)
    finally:
        pipeline.frame_program = orig
    assert [f.md5_ok for f in frames] == [True, True]
    assert len(calls) == 2
    for args, out in calls:
        spec = dict(args[10])
        coo_n, total = spec["coo"]
        assert coo_n > 0
        idx, val = args[4]
        pool = np.zeros(total, np.int16)
        keep = idx < total
        pool[idx[keep]] = val[keep]
        dense_spec = tuple((k, (0, total) if k == "coo" else v)
                           for k, v in args[10])
        dense = orig(*args[:4], pool, *args[5:10], dense_spec, card)
        for a, b in zip(out, dense):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_frame_axis_on_card(card):
    """A parallel-B GOP (I0, P5, B1-B4) at 416x240 over every card: the
    four B pictures in one batch, each picture's MD5 correct, no reference
    from the host."""
    from hevc_tpu_torch import pipeline
    from hevc_tpu_torch.bitstream.sei import picture_md5
    from hevc_tpu_torch.decoder import Decoder
    from hevc_tpu_torch.pgop_frame import decode_bframes_frame_axis
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    pipeline.host_refs["count"] = 0
    stream, got, batches = decode_bframes_frame_axis(cards, n_b=4,
                                                     width=416, height=240)
    assert pipeline.host_refs["count"] == 0
    assert batches == [[0], [5], [1, 2, 3, 4]]
    want = {f.poc: f for f in Decoder(recon_backend="inline")
            .decode_bytes(stream)}
    for poc, planes in got.items():
        host = [p.cpu().numpy() for p in planes]
        assert picture_md5(host, 8) == want[poc].sei_hash.md5, poc
        # the output pictures are cropped at the right and the bottom
        assert all(np.array_equal(a[:b.shape[0], :b.shape[1]], b)
                   for a, b in zip(host, map(np.asarray,
                                             want[poc].planes))), poc


@pytest.mark.cuda
def test_dist_worker_over_nccl_on_card(card, tmp_path):
    """python -m hevc_tpu_torch.dist_worker, one process and one band a card
    over NCCL, on a 1920x1080 stream with 64x64 CTBs in as many column
    tiles as ranks (three with three cards or more, else two): the ranks
    exchange 1088-row halos."""
    import os
    import socket
    import subprocess
    import sys
    world = min(torch.cuda.device_count(), 3)
    if world < 2:
        pytest.skip("the banded decode across processes needs two cards or "
                    "more")
    path = tmp_path / "tiles.265"
    path.write_bytes(_tile_stream(1920, 1080, world, 3, "gradient", 30,
                                  lf_across_tiles=True))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hevc_tpu_torch.dist_worker", str(port),
         str(r), str(world), "1", "--stream", str(path), "--backend",
         "nccl"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"worker {r} OK" in out, out[-3000:]
        print(f"{world} ranks over NCCL, 1920x1080: "
              f"{out.strip().splitlines()[-1]}")


@pytest.mark.cuda
def test_stage_timings_720p_on_card(card, tmp_path):
    """The root ``bench.py``'s 1280x720 QP 30 stream without WPP (3
    frames) through ``capture.stage_timings``: both inter kernels equal to
    their plain versions on the captured P picture, every stage timed
    beside its bound, the replays timed and then traced."""
    from hevc_tpu_torch.capture import stage_timings
    from hevc_tpu_torch.encoder.generate import synth_stream
    path = synth_stream(str(tmp_path / "v2ipp_1280x720_qp30_ctb64_filt.265"),
                        1280, 720, 30, 3, False)
    rep, out = stage_timings(path, card, 16, "720p")
    assert out["kernel_max_abs_err"] == {"mc": 0, "resid_add": 0}
    stages = {f"{k}_720p" for k in ("dequant_idct", "mc", "resid_add",
                                    "intra_wavefront", "deblock", "sao")}
    assert set(out["kernel_us"]) == stages
    assert set(out["kernel_gbps"]) == stages | {"roofline_elementwise"}
    assert set(out["kernel_bound_us"]) == stages
    assert out["stageB_replay_fps_720p"] > 0
    busy, idle = rep.profiled(16)
    assert busy > 0 and idle < 1
    assert rep.count == out["stageB_replays_720p"] + 16 + 1 == 2 * (16 + 1)


# ---------------------------------------------------------------------------
# the intra wavefront kernel (csrc/intra.cu)
# ---------------------------------------------------------------------------

def _on(case, dev):
    canvas, scal, avail, resids, bd = case
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    return (t(canvas), [t(s) for s in scal], [t(a) for a in avail],
            [t(r) for r in resids], bd)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_intra_kernel_matches_plain_on_random_cases_on_card(card, seed):
    """The seeded random cases (every mode of every size, filters on and
    off, bit depths 8 and 10, partial availability, padding records, empty
    chunks): one launch per live chunk, bit for bit the plain version."""
    case = random_case(seed)
    counts = intra.chunk_counts(case[1])
    canvas, scal, avail, resids, bd = _on(case, card)
    tabs = tables_from_reference(card)
    before = build.launches["intra"]
    got = intra_cuda.reconstruct_wavefront(canvas.clone(), scal, avail,
                                           resids, bd, tabs, counts)
    torch.cuda.synchronize()
    assert build.launches["intra"] - before == intra_cuda.live_chunks(counts)
    want = intra.reconstruct_wavefront(canvas.clone(), scal, avail, resids,
                                       bd, tabs, counts)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_intra_launches_counter_is_the_live_chunks_on_card(card, seed):
    """The ``intra_launches`` counter adds one a launch: the live chunks of
    the picture's counts."""
    case = random_case(seed)
    counts = intra.chunk_counts(case[1])
    canvas, scal, avail, resids, bd = _on(case, card)
    trace.reset()
    intra_cuda.reconstruct_wavefront(canvas, scal, avail, resids, bd,
                                     tables_from_reference(card), counts)
    torch.cuda.synchronize()
    got = trace.report()["intra_launches"]
    assert got["total"] == intra_cuda.live_chunks(counts) > 0
    assert got["calls"] == 1


@pytest.mark.cuda
def test_intra_wrapper_raises_when_the_build_fails_on_card(card,
                                                           monkeypatch):
    def failed():
        raise RuntimeError("nvcc failed (1)")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(build, "load", failed)
    monkeypatch.setattr(intra, "reconstruct_wavefront", plain)
    case = random_case(0)
    canvas, scal, avail, resids, bd = _on(case, card)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        intra_cuda.reconstruct_wavefront(
            canvas, scal, avail, resids, bd, tables_from_reference(card),
            intra.chunk_counts(case[1]))


@pytest.mark.cuda
def test_decoder_launches_intra_once_per_live_chunk_on_card(card):
    """An I, P, P stream through ``TorchDecoder``: the intra kernel
    launches once per live chunk of every picture's pack, every MD5
    correct."""
    from hevc_tpu_torch import pipeline
    from hevc_tpu_torch.decoder import TorchDecoder
    from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
    from hevc_tpu_torch.encoder.generate import synth_frame
    enc = IntraEncoder(EncoderConfig(
        width=192, height=128, qp=30, gop="ipp", wpp=True, deblocking=True,
        sao=True, log2_ctb_size=5, log2_cu_size=5, search_range=3, seed=1))
    data = b"".join(enc.encode_frame(synth_frame("gradient", 192, 128, t,
                                                 seed=3)) for t in range(3))
    live = []
    orig = pipeline.frame_program

    def program(meta, meta16, *rest):
        S = dict(rest[-2])
        scal = pipeline.host_views(np.asarray(meta, np.int32), meta16, S)[0]
        live.append(intra_cuda.live_chunks(intra.chunk_counts(scal)))
        return orig(meta, meta16, *rest)

    pipeline.frame_program = program
    before = build.launches["intra"]
    try:
        frames = TorchDecoder(check_md5=True, device=card).decode_bytes(data)
    finally:
        pipeline.frame_program = orig
    assert [f.md5_ok for f in frames] == [True] * 3
    assert live[0] > 0
    assert build.launches["intra"] - before == sum(live), live
