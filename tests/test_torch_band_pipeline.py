"""The port's banded stage B against the JAX package's and the sequential
decode, bit for bit (tolerance 0), on the CPU.

- ``pack.pack_frame_plan`` and ``band.pack_frame_bands`` against the JAX
  ``pack_frame`` / ``pack_frame_bands`` field by field (the JAX pack pads
  each class's batch per chunk to a power of two; those lanes are checked
  to be padding and stripped);
- ``band.mc_rows`` + ``mc.mc_plain`` (and the ``mc_cuda.mc`` wrapper)
  against ``hevc_tpu.tpu.mc.mc_phase`` on the band windows of the JAX pack,
  an interior band included;
- the cases of tests/test_band_pipeline.py (IPP over 4 and 8 bands, no
  filters, low-delay B with bi-prediction across seams, explicit weighted
  prediction, the streaming decode with its halo widened mid-GOP) against
  the sequential host decode (every MD5 correct) and the JAX package's
  ``decode_gop_banded`` on the 8-device CPU mesh, with no reference read
  from the host;
- the device DPB: it keeps only what the RPS keeps, and a reference that
  is not in it is an error naming the POC; the streaming stage A stops
  when its consumer does;
- a tile stream without loop filtering across tiles decodes equal to the
  sequential decode, where the JAX banded decode differs from it;
- the refusals: tile columns that are not the bands (no tiles; 2 tile
  columns in 4 bands), the pictures the JAX banded decode raises on too
  (4:2:2 with deblocking or SAO, 4:0:0 with references or with both
  deblocking and SAO: the JAX error is named, and raised), and a halo
  narrower than the MV bound.
The other stream kinds of the banded decode (several slices, PCM, 4:0:0
and 4:2:2) are in tests/test_torch_band_formats.py.
"""
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hevc_tpu.decoder.core as jax_dcore
from hevc_tpu.tpu import band as JB
from hevc_tpu.tpu.mc import mc_phase
from hevc_tpu.tpu.pack import pack_frame as jax_pack_frame
from hevc_tpu.tpu.sharded import decode_gop_banded as jax_decode_gop_banded
from hevc_tpu_torch import band as B
from hevc_tpu_torch import mc_cuda, pipeline
from hevc_tpu_torch.decoder import core as dcore
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.mc import mc_plain
from hevc_tpu_torch.pack import DUMP, pack_frame_plan
from hevc_tpu_torch.sharded import (BandLayout, decode_gop_banded,
                                    decode_stream_banded, stitch)
from hevc_tpu_torch.tables import tables_from_reference

BASE = dict(log2_ctb_size=5, log2_cu_size=5, seed=2, qp=30)
CASES = {  # name: (encoder settings, bands, pictures)
    "ipp4": (dict(width=128, height=96, gop="ipp", deblocking=True,
                  sao=True, search_range=3), 4, 3),
    "ipp8": (dict(width=256, height=96, gop="ipp", deblocking=True,
                  sao=True, search_range=3), 8, 3),
    "ipp_no_filters": (dict(width=128, height=64, gop="ipp",
                            search_range=2), 4, 3),
    "lowb": (dict(width=128, height=64, gop="lowb", deblocking=True,
                  search_range=2), 4, 4),
    "wp": (dict(width=128, height=64, gop="lowb", weighted_pred=True,
                deblocking=True, sao=True, search_range=2), 4, 4),
}


def _encode(kw, n_bands, n_frames, **extra):
    cfg = EncoderConfig(**dict(BASE, tiles=(n_bands, 1), **kw, **extra))
    enc = IntraEncoder(cfg)
    return b"".join(enc.encode_frame(synth_frame("noise", cfg.width,
                                                 cfg.height, t, seed=4))
                    for t in range(n_frames))


def _captured(mod, stream):
    """[(pic, plan)] of the plan decoder of ``mod`` (either package's
    decoder core), decode order."""
    out = []
    orig = mod.execute_plan_numpy

    def capture(pic, plan):
        out.append((pic, list(plan)))
        orig(pic, plan)

    mod.execute_plan_numpy = capture
    try:
        mod.Decoder(recon_backend="plan").decode_bytes(stream)
    finally:
        mod.execute_plan_numpy = orig
    return out


def _mesh(n):
    return Mesh(np.asarray(jax.devices("cpu")[:n]), ("tile",))


def _assert_planes(got, want, what):
    for p, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, p, g.shape, w.shape)
        bad = np.argwhere(g != w)
        assert not bad.size, (
            f"{what} plane {p}: {len(bad)} samples differ, first (y, x) "
            f"{tuple(bad[0])}: {g[tuple(bad[0])]} != {w[tuple(bad[0])]}")


def _same_pack(got, want):
    """The port's PackedFrame against the JAX pack's, field by field."""
    assert (got.n_chunks, got.region, got.bit_depth) == \
        (want.n_chunks, want.region, want.bit_depth)
    np.testing.assert_array_equal(got.canvas, want.canvas)
    for c in range(4):
        b = got.scal[c].shape[1]
        np.testing.assert_array_equal(got.scal[c], want.scal[c][:, :b])
        np.testing.assert_array_equal(got.avail[c], want.avail[c][:, :b])
        pad = want.scal[c][:, b:]     # the JAX pack's power-of-two lanes
        assert (pad[..., :2] == DUMP).all() and (pad[..., 2] == 1).all() \
            and (pad[..., 3:] == 0).all()
        assert not want.avail[c][:, b:].any()
        if b:
            assert (got.scal[c][..., 0] >= 0).sum(axis=1).max() == b
        np.testing.assert_array_equal(got.levels[c], want.levels[c])
        np.testing.assert_array_equal(got.rmeta[c], want.rmeta[c])
        np.testing.assert_array_equal(got.resid_groups[c],
                                      want.resid_groups[c])
        np.testing.assert_array_equal(got.scale_bank[c], want.scale_bank[c])
    assert [g[:5] for g in got.mc_groups] == [g[:5] for g in want.mc_groups]
    for g, w in zip(got.mc_groups, want.mc_groups):
        np.testing.assert_array_equal(g[5], w[5])
    assert got.refs_l is None and got.refs_c is None


@pytest.mark.parametrize("name", ["lowb", "wp"])
def test_pack_matches_jax_pack_field_by_field(name):
    kw, n_bands, n_frames = CASES[name]
    stream = _encode(kw, n_bands, n_frames)
    ours, theirs = _captured(dcore, stream), _captured(jax_dcore, stream)
    assert len(ours) == len(theirs) == n_frames
    hl, hc = B.required_halo([p for _pic, p in ours], ours[0][0].sps,
                             n_bands)
    assert (hl, hc) == JB.required_halo([p for _pic, p in theirs],
                                        theirs[0][0].sps, n_bands)
    n_mc = 0
    for (pic, plan), (jpic, jplan) in zip(ours, theirs):
        _same_pack(pack_frame_plan(pic, plan), jax_pack_frame(jpic, jplan))
        got, bw = B.pack_frame_bands(pic, plan, n_bands, hl, hc)
        want, jbw = JB.pack_frame_bands(jpic, jplan, n_bands, hl, hc)
        assert bw == jbw and sorted(got) == list(range(n_bands))
        for k in range(n_bands):
            _same_pack(got[k], want[k])
            n_mc += len(got[k].mc_groups)
    assert n_mc


@pytest.mark.parametrize("name", ["lowb", "wp"])
def test_mc_rows_and_mc_plain_match_jax_mc_phase(name):
    kw, n_bands, n_frames = CASES[name]
    stream = _encode(kw, n_bands, n_frames)
    theirs = _captured(jax_dcore, stream)
    ours = _captured(dcore, stream)
    hl, hc = JB.required_halo([p for _pic, p in theirs], theirs[0][0].sps,
                              n_bands)
    jpic, jplan = theirs[-1]          # a B picture
    pic, plan = ours[-1]
    want, _ = JB.pack_frame_bands(jpic, jplan, n_bands, hl, hc)
    got, _ = B.pack_frame_bands(pic, plan, n_bands, hl, hc)
    tabs = tables_from_reference("cpu")
    for k in (0, 1):                  # an edge band and an interior one
        jpf, pf = want[k], got[k]
        assert pf.mc_groups
        bd = pf.bit_depth
        canvas = np.random.default_rng(k).integers(
            0, 1 << bd, pf.canvas.shape).astype(np.int32)
        ref = np.asarray(mc_phase(jax.numpy.asarray(canvas), jpf.refs_l,
                                  jpf.refs_c, jpf.mc_groups, bd))
        refs_l, refs_c = torch.from_numpy(jpf.refs_l), \
            torch.from_numpy(jpf.refs_c)
        groups = [g[:6] + (torch.from_numpy(g[6]),)
                  for g in B.mc_rows(pf.mc_groups)]
        plain = mc_plain(torch.from_numpy(canvas.copy()), refs_l, refs_c,
                         groups, bd, tabs)
        np.testing.assert_array_equal(plain.numpy(), ref)
        wrapped = mc_cuda.mc(torch.from_numpy(canvas.copy()), refs_l, refs_c,
                             B.mc_rows(pf.mc_groups), bd)
        np.testing.assert_array_equal(wrapped.numpy(), ref)
        assert (plain.numpy() != canvas).any()


def test_mc_rows_layout():
    """Uni rows move (cy, cx) to columns 10-11 and the weights to 12-16;
    bi rows keep their columns."""
    uni = np.arange(12, dtype=np.int32)[None]
    bi = np.arange(100, 112, dtype=np.int32)[None]
    (g_uni, g_bi) = B.mc_rows(((False, False, 8, 8, True, uni),
                               (True, True, 4, 4, False, bi)))
    assert g_uni[:6] == (False, False, True, 3, 8, 8)
    assert g_uni[6][0].tolist() == [0, 1, 2, 3, 4, 0, 0, 0, 0, 0, 5, 6, 7, 8,
                                    9, 10, 11]
    assert g_bi[:6] == (True, True, False, 3, 4, 4)
    assert g_bi[6][0].tolist() == list(range(100, 112)) + [0] * 5


@pytest.mark.parametrize("name", sorted(CASES))
def test_banded_decode_matches_sequential_and_jax(name):
    kw, n_bands, n_frames = CASES[name]
    stream = _encode(kw, n_bands, n_frames)
    frames, ref, (hl, hc) = B.prepare_gop_banded(stream, n_bands)
    assert all(f["md5_ok"] for f in frames)
    assert any(pf.mc_groups for f in frames for pf in f["bands"].values())
    pipeline.host_refs["count"] = 0
    outs = decode_gop_banded(BandLayout(["cpu"] * n_bands), frames, hl, hc)
    assert pipeline.host_refs["count"] == 0
    jframes, jref, jhalo = JB.prepare_gop_banded(stream, n_bands)
    assert jhalo == (hl, hc)
    jouts = jax_decode_gop_banded(_mesh(n_bands), jframes, halo_l=hl,
                                  halo_c=hc)
    assert len(outs) == len(ref) == len(jouts) == n_frames
    for i, (out, want, jout) in enumerate(zip(outs, ref, jouts)):
        got = stitch(out)
        _assert_planes(got, want, f"{name} picture {i} vs sequential")
        _assert_planes(got, jout, f"{name} picture {i} vs JAX")
    groups = [g for f in frames for pf in f["bands"].values()
              for g in pf.mc_groups]
    if name in ("lowb", "wp"):
        assert any(g[1] for g in groups), "no bi-predicted group"
    if name == "wp":
        assert any(g[4] for g in groups), "no weighted group"


def test_a_gop_without_its_anchor_raises_naming_the_poc():
    """Decoding from a P picture on (the I picture's windows never made on
    the device) is an error: no reference comes from the host."""
    kw, n_bands, n_frames = CASES["ipp4"]
    stream = _encode(kw, n_bands, n_frames)
    frames, _ref, (hl, hc) = B.prepare_gop_banded(stream, n_bands)
    assert frames[1]["ref_pocs_l0"] == [0]
    with pytest.raises(KeyError, match=r"POC 1: reference POC\(s\) \[0\]"):
        decode_gop_banded(BandLayout(["cpu"] * n_bands), frames[1:], hl, hc)


def test_the_device_dpb_keeps_only_what_the_rps_keeps():
    """Over an IPP GOP longer than its reference count, the device DPB
    holds after each picture only that picture and the POCs its RPS keeps;
    every picture stays bit-exact."""
    kw, n_bands, _n = CASES["ipp4"]
    n_frames = 6
    stream = _encode(kw, n_bands, n_frames)
    frames, ref, (hl, hc) = B.prepare_gop_banded(stream, n_bands)
    layout = BandLayout(["cpu"] * n_bands)
    dpb, sizes = {}, []
    for fb, want in zip(frames, ref):
        (out,) = decode_gop_banded(layout, [fb], hl, hc, dpb=dpb)
        _assert_planes(stitch(out), want, f"picture {fb['poc']}")
        assert set(dpb) <= set(fb["dpb_pocs"]) | {fb["poc"]}
        sizes.append(len(dpb))
    assert max(sizes) < n_frames - 1, sizes
    assert max(len(f["dpb_pocs"]) for f in frames) + 1 >= max(sizes)


def _no_tile_stream(n_frames):
    cfg = EncoderConfig(**dict(BASE, width=128, height=64, gop="ipp",
                               deblocking=True, search_range=2))
    enc = IntraEncoder(cfg)
    return b"".join(enc.encode_frame(synth_frame("noise", 128, 64, t,
                                                 seed=4))
                    for t in range(n_frames))


@pytest.mark.parametrize("tiles", [None, 2], ids=["no_tiles", "2_of_4"])
def test_refuses_tile_columns_that_are_not_the_bands(tiles):
    """Without tiles, or with 2 tile columns in 4 bands, intra prediction
    at a band edge would read a neighbour the band does not hold: both the
    whole-GOP and the streaming stage A refuse the stream."""
    stream = _no_tile_stream(2) if tiles is None else _encode(
        dict(width=128, height=64, gop="ipp", deblocking=True,
             search_range=2), tiles, 2)
    with pytest.raises(ValueError, match="tile columns"):
        B.prepare_gop_banded(stream, 4)
    with pytest.raises(ValueError, match="tile columns"):
        next(B.iter_gop_banded(stream, 4))


def test_the_streaming_stage_a_stops_with_its_consumer():
    """A consumer that takes one bundle and stops ends the stage-A worker
    thread, which would otherwise block on its full queue."""
    kw, n_bands, _n = CASES["ipp4"]
    stream = _encode(kw, n_bands, 8)
    before = set(threading.enumerate())
    it = B.iter_gop_banded(stream, n_bands)
    fb, _halo = next(it)
    assert fb["poc"] == 0
    it.close()
    assert set(threading.enumerate()) <= before


def test_streaming_banded_decode_with_the_halo_widened(monkeypatch):
    """Bundles stream from a stage-A worker thread (``iter_gop_banded``);
    later pictures report a wider MV bound, and the device DPB is
    re-sharded at the new halo: bit-exact against the sequential decode and
    the JAX package's banded decode."""
    n_bands = 4
    stream = _encode(dict(width=32 * n_bands, height=96, gop="ipp",
                          deblocking=True, sao=True, search_range=3),
                     n_bands, 4)
    _frames, ref, (hl, hc) = B.prepare_gop_banded(stream, n_bands)
    jframes, _jref, _h = JB.prepare_gop_banded(stream, n_bands)
    jouts = jax_decode_gop_banded(_mesh(n_bands), jframes, halo_l=hl,
                                  halo_c=hc)
    orig = B.required_halo_frame
    calls = {"n": 0}

    def bumped(plan, sps, nb):
        """From the third picture on, a bound wider than the halo so far."""
        got = orig(plan, sps, nb)
        calls["n"] += 1
        if calls["n"] < 3:
            return got
        return max(got[0], halos[-1][0]) + 8, max(got[1], halos[-1][1]) + 4

    monkeypatch.setattr(B, "required_halo_frame", bumped)
    halos = []

    def tap(it):
        for fb, halo in it:
            halos.append(halo)
            yield fb, halo

    pipeline.host_refs["count"] = 0
    outs = list(decode_stream_banded(BandLayout(["cpu"] * n_bands), tap(
        B.iter_gop_banded(stream, n_bands, margin_l=0, margin_c=0))))
    assert len(set(halos)) >= 2, f"halo never widened: {halos}"
    assert halos[3] > halos[2] > halos[1], halos
    assert pipeline.host_refs["count"] == 0
    assert len(outs) == len(ref) == 4
    for i, (out, want, jout) in enumerate(zip(outs, ref, jouts)):
        _assert_planes(stitch(out), want, f"streamed picture {i}")
        _assert_planes(stitch(out), jout, f"streamed picture {i} vs JAX")


def test_refuses_tiles_without_cross_tile_filtering():
    """Named for what the banded decode once did with such a stream: it
    refused it.  It decodes it now: with loop filtering off across tiles
    the band filters take the boundary strengths gated at the tile edges
    and the SAO edge restrictions, and every picture equals the sequential
    decode.  The JAX package's band filters (ungated strengths, no edge
    flags in its ``_sao_local``) differ from it there."""
    n_bands = 4
    stream = _encode(dict(width=128, height=96, gop="ipp", deblocking=True,
                          sao=True, search_range=3), n_bands, 2,
                     lf_across_tiles=False)
    frames, ref, (hl, hc) = B.prepare_gop_banded(stream, n_bands)
    assert all(f["md5_ok"] for f in frames)
    assert all(f["filters"].per_slice for f in frames)
    pipeline.host_refs["count"] = 0
    outs = decode_gop_banded(BandLayout(["cpu"] * n_bands), frames, hl, hc)
    assert pipeline.host_refs["count"] == 0
    for i, (out, want) in enumerate(zip(outs, ref)):
        _assert_planes(stitch(out), want, f"picture {i} vs sequential")
    jframes, jref, (hl, hc) = JB.prepare_gop_banded(stream, n_bands)
    jouts = jax_decode_gop_banded(_mesh(n_bands), jframes, halo_l=hl,
                                  halo_c=hc)
    assert any((np.asarray(g) != w).any()
               for out, want in zip(jouts, jref) for g, w in zip(out, want))


# the pictures both banded decodes refuse: (encoder settings, the JAX
# error's type, where the port's message says the JAX decode raises)
REFUSED = {
    "422": (dict(chroma_format_idc=2, bit_depth=10, deblocking=True),
            TypeError, "hevc_tpu/tpu/filters.py:107"),
    "422_sao": (dict(chroma_format_idc=2, bit_depth=10, sao=True),
                TypeError, "hevc_tpu/tpu/sharded.py:72"),
    "400_inter": (dict(chroma_format_idc=0, deblocking=True), IndexError,
                  "hevc_tpu/tpu/pack.py:274"),
    "400_deblock_sao": (dict(chroma_format_idc=0, gop="all_intra",
                             deblocking=True, sao=True),
                        TypeError, "hevc_tpu/tpu/sharded.py:72"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refuses_what_the_band_filters_do_not_do(name):
    """The pictures the JAX banded decode raises on: the port refuses them
    naming the JAX error, which the JAX decode raises."""
    extra, jax_error, where = REFUSED[name]
    stream = _encode(dict(width=128, height=64, gop="ipp", search_range=2)
                     | extra, 4, 2)
    with pytest.raises(NotImplementedError, match=where):
        B.prepare_gop_banded(stream, 4)
    with pytest.raises(jax_error):
        jframes, _jref, (hl, hc) = JB.prepare_gop_banded(stream, 4)
        jax_decode_gop_banded(_mesh(4), jframes, halo_l=hl, halo_c=hc)


def test_a_halo_narrower_than_the_mv_bound_raises():
    kw, n_bands, n_frames = CASES["ipp4"]
    stream = _encode(kw, n_bands, n_frames)
    _f, _r, (hl, hc) = B.prepare_gop_banded(stream, n_bands)
    assert hl > 8
    with pytest.raises(B.BandHaloExceeded):
        B.prepare_gop_banded(stream, n_bands, halo_l=hl - 8, halo_c=hc)
