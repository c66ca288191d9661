"""The port's banded and frame-axis decodes of the streams whose in-loop
filters are not one picture-wide set, bit for bit (tolerance 0), on the
CPU: a slice per tile; two slices a band with their own beta/tc offsets,
one of them without loop filtering across its edges and one without
deblocking, no loop filtering across tiles; PCM exempt from the filters;
4:0:0 intra pictures (deblocked, or with SAO); and 4:2:2 without filters.

Each stream decodes through ``band.prepare_gop_banded`` +
``sharded.decode_gop_banded`` in 2 and 4 bands (one a tile column) and
through the frame axis (``pgop_frame.decode_frame_parallel``), equal to
the sequential host decode (every MD5 correct), with no reference from the
host.  Where the JAX package's banded decode is right (a slice per tile
with filtering across slices and tiles, 4:2:2 without filters) the port is
held against it too; on 4:0:0 intra pictures it is wrong, which is
asserted.  The pictures both banded decodes refuse are in
tests/test_torch_band_pipeline.py.
"""
from functools import lru_cache

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from hevc_tpu.tpu import band as JB
from hevc_tpu.tpu.sharded import decode_gop_banded as jax_decode_gop_banded
from hevc_tpu_torch import band as B
from hevc_tpu_torch import pipeline
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.pgop_frame import decode_frame_parallel
from hevc_tpu_torch.sharded import BandLayout, decode_gop_banded, stitch

IPP = dict(width=128, height=96, qp=30, log2_ctb_size=5, log2_cu_size=5,
           gop="ipp", deblocking=True, sao=True, search_range=2, seed=2)


def _two_slices_a_band(n):
    """2n slices over n x 2 tiles, even offsets (odd ones are written
    halved), slice 1 without loop filtering across its edges, the last
    without deblocking."""
    params = [dict(beta_offset=(-4, -2, 0, 2, 4, 6)[k % 6],
                   tc_offset=(2, -2, 4, 0, -4, 6)[k % 6])
              for k in range(2 * n)]
    params[1]["lf_across"] = False
    params[-1] = dict(disable=True)
    return dict(IPP, tiles=(n, 2), slices=2 * n, lf_across_tiles=False,
                slice_filter_params=tuple(params), log2_cu_size=4)


KINDS = {  # name: the encoder settings of n bands
    "slice_per_tile": lambda n: dict(IPP, tiles=(n, 1), slices=n),
    "two_slices_a_band": _two_slices_a_band,
    "pcm": lambda n: dict(IPP, tiles=(n, 1), log2_cu_size=4, pcm=0.3,
                          pcm_loop_filter_disabled=True),
    "400_intra_deblock": lambda n: dict(IPP, tiles=(n, 1), height=64,
                                        chroma_format_idc=0,
                                        gop="all_intra", sao=False),
    "400_intra_sao": lambda n: dict(IPP, tiles=(n, 1), height=64,
                                    chroma_format_idc=0, gop="all_intra",
                                    deblocking=False),
    "422_unfiltered": lambda n: dict(IPP, tiles=(n, 1), height=64,
                                     chroma_format_idc=2, bit_depth=10,
                                     deblocking=False, sao=False),
}


@lru_cache(maxsize=None)
def stream(name, n_bands, n_frames=3):
    cfg = EncoderConfig(**KINDS[name](n_bands))
    enc = IntraEncoder(cfg)
    out = bytearray()
    for t in range(n_frames):
        planes = synth_frame("gradient", cfg.width, cfg.height, t, seed=4)
        if cfg.bit_depth > 8:
            planes = [p.astype(np.int32) << (cfg.bit_depth - 8)
                      for p in planes]
        out += enc.encode_frame(planes)
    return bytes(out)


def _assert_planes(got, want, what):
    assert len(got) == len(want), what
    for p, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, p, g.shape, w.shape)
        bad = np.argwhere(g != w)
        assert not bad.size, (
            f"{what} plane {p}: {len(bad)} samples differ, first (y, x) "
            f"{tuple(bad[0])}: {g[tuple(bad[0])]} != {w[tuple(bad[0])]}")


def _features(name, frames):
    """The kind's feature is really in its bundles."""
    fis = [f["filters"] for f in frames]
    if name in ("slice_per_tile", "two_slices_a_band"):
        assert all(fi.per_slice for fi in fis)
    if name == "two_slices_a_band":
        assert all(np.ndim(fi.beta) == 2 and np.unique(fi.beta).size > 2
                   for fi in fis)
        assert all(fi.do_deblock and not fi.bs_v.all() for fi in fis)
    if name == "pcm":
        assert fis[0].no_filter is not None and fis[0].no_filter.any()
    if name.startswith("400"):
        assert all(f["mono"] for f in frames)
        assert all(fi.do_deblock == (name == "400_intra_deblock")
                   for fi in fis)
        assert all(f["do_sao"] == (name == "400_intra_sao") for f in frames)
    if name == "422_unfiltered":
        assert all(f["sub_h"] == 1 and not f["do_sao"]
                   and not f["filters"].do_deblock for f in frames)
    inter = [pf.mc_groups for f in frames for pf in f["bands"].values()]
    assert any(inter) == (not name.startswith("400"))


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_banded_decode_matches_sequential(name, n_bands):
    data = stream(name, n_bands)
    frames, ref, (hl, hc) = B.prepare_gop_banded(data, n_bands)
    assert [f["md5_ok"] for f in frames] == [True] * 3
    _features(name, frames)
    pipeline.host_refs["count"] = 0
    outs = decode_gop_banded(BandLayout(["cpu"] * n_bands), frames, hl, hc)
    assert pipeline.host_refs["count"] == 0
    assert len(outs) == len(ref) == 3
    for i, (out, want) in enumerate(zip(outs, ref)):
        _assert_planes(stitch(out), want, f"{name} picture {i}")


@pytest.mark.parametrize("name", sorted(KINDS))
def test_frame_axis_matches_sequential(name):
    """One band a picture, the pictures spread over two devices.  The
    all-intra streams' pictures are IDR pictures, every one POC 0, which
    the frame axis keys its output by: one of them is decoded."""
    n = 1 if name.startswith("400") else 3
    data = stream(name, 2, n)
    _frames, ref, _halo = B.prepare_gop_banded(data, 2)
    pipeline.host_refs["count"] = 0
    got, batches = decode_frame_parallel(data, ["cpu"] * 2)
    assert pipeline.host_refs["count"] == 0
    assert sum(map(len, batches)) == n and sorted(got) == list(range(n))
    for poc, want in enumerate(ref):
        _assert_planes(got[poc], want, f"{name} POC {poc}")


def _jax_banded(data, n_bands):
    jframes, jref, (hl, hc) = JB.prepare_gop_banded(data, n_bands)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:n_bands]), ("tile",))
    return jax_decode_gop_banded(mesh, jframes, halo_l=hl, halo_c=hc), jref


@pytest.mark.parametrize("name", ["slice_per_tile", "422_unfiltered"])
def test_matches_jax_where_jax_is_right(name):
    data = stream(name, 4)
    frames, ref, (hl, hc) = B.prepare_gop_banded(data, 4)
    outs = decode_gop_banded(BandLayout(["cpu"] * 4), frames, hl, hc)
    jouts, _jref = _jax_banded(data, 4)
    for i, (out, jout) in enumerate(zip(outs, jouts)):
        _assert_planes(stitch(out), jout, f"{name} picture {i} vs JAX")


def test_jax_is_wrong_on_4_0_0_intra_pictures():
    """The JAX banded decode takes 4:0:0 intra pictures and gets a picture
    wrong, where the port's equals the sequential decode (above)."""
    data = stream("400_intra_deblock", 4)
    jouts, jref = _jax_banded(data, 4)
    assert any((np.asarray(out[0]) != want[0]).any()
               for out, want in zip(jouts, jref))
