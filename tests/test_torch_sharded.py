"""The port's column-band deblocking + SAO with halo exchange, bit for bit
(tolerance 0), on random planes and maps made from NumPy seeds: for 2, 4
and 8 bands on the CPU in one process, every case equals the port's
single-device ``deblock`` + ``sao_plane`` and the JAX package's
``filter_frame_sharded`` on the 8-device CPU mesh of conftest.py — the
cases of tests/test_sharded.py.

For 4:4:4 (sub 1) the JAX filters map the chroma QP with the 4:2:0 table
(Table 8-10) where the spec takes Min(qPi, 51) (ROADMAP, 'Where the port
follows the spec'), so there the chroma planes are held against the port's
single-device filters alone, which tests/test_torch_filter_maps.py holds
against the NumPy filters of the spec.

With a multi-slice picture's inputs (per-4x4 beta/tc offset maps, SAO edge
restrictions per CTB, the PCM/TQB exemption map; 4:2:0 and 4:2:2) the
bands are held against the port's single-device filters on the same
inputs: the JAX banded filters take none of them."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from hevc_tpu.tpu.sharded import filter_frame_sharded as jax_sharded
from hevc_tpu_torch.filters import deblock, sao_plane
from hevc_tpu_torch.sharded import (BandLayout, _nf_masks,
                                     filter_frame_sharded)
from hevc_tpu_torch.tables import tables_from_reference


def _random_frame(rng, w, h, bd=8, sub=2):
    maxv = (1 << bd) - 1
    y = rng.integers(0, maxv + 1, (h, w), np.int32)
    cb = rng.integers(0, maxv + 1, (h // sub, w // sub), np.int32)
    cr = rng.integers(0, maxv + 1, (h // sub, w // sub), np.int32)
    qp4 = rng.integers(20, 45, (h // 4, w // 4), np.int32)
    bs_v = rng.integers(0, 3, (h // 4, w // 4), np.int32)
    bs_h = rng.integers(0, 3, (h // 4, w // 4), np.int32)
    bs_v[:, 0] = 0   # picture-boundary edges carry bs=0
    bs_h[0, :] = 0
    return y, cb, cr, qp4, bs_v, bs_h


def _random_sao(rng, w, h, ctb_log2=6):
    cty, ctx = h >> ctb_log2, w >> ctb_log2
    st, sp, so, sc = [], [], [], []
    for _p in range(3):
        st.append(rng.integers(0, 3, (cty, ctx), np.int32))
        sp.append(rng.integers(0, 29, (cty, ctx), np.int32))
        so.append(rng.integers(-7, 8, (cty, ctx, 4), np.int32))
        sc.append(rng.integers(0, 4, (cty, ctx), np.int32))
    return tuple(st), tuple(sp), tuple(so), tuple(sc)


def _mesh(n):
    devs = jax.devices("cpu")
    assert len(devs) >= n, f"conftest.py gives {len(devs)} cpu devices"
    return Mesh(np.asarray(devs[:n]), ("tile",))


def _assert_equal(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.argwhere(got != want)
    assert not bad.size, (f"{what}: {len(bad)} samples differ, first (y, x) "
                          f"{tuple(bad[0])}: {got[tuple(bad[0])]} != "
                          f"{want[tuple(bad[0])]}")


@pytest.mark.parametrize("n_bands", [2, 4, 8])
@pytest.mark.parametrize("bd,sub", [(8, 2), (10, 2), (8, 1)])
def test_sharded_filters_match_single_device_and_jax(n_bands, bd, sub):
    w, h, ctb_log2 = 512, 128, 6
    rng = np.random.default_rng(7 * n_bands + bd + sub)
    y, cb, cr, qp4, bs_v, bs_h = _random_frame(rng, w, h, bd, sub)
    st, sp, so, sc = _random_sao(rng, w, h, ctb_log2)
    offs = (0, 0, 1, -1)
    t = torch.from_numpy
    ry, rcb, rcr = deblock(t(y), t(cb), t(cr), t(qp4), t(bs_v), t(bs_h),
                           *offs, tables_from_reference("cpu"), bd=bd,
                           sub_w=sub, sub_h=sub)
    single = []
    for i, p in enumerate((ry, rcb, rcr)):
        lg = ctb_log2 - (0 if i == 0 else sub.bit_length() - 1)
        single.append(sao_plane(p, t(st[i]), t(sp[i]), t(so[i]), t(sc[i]),
                                lg, bd))
    got = filter_frame_sharded(
        BandLayout(["cpu"] * n_bands), y, cb, cr, qp4, bs_v, bs_h, *offs,
        st, sp, so, sc, bit_depth=bd, ctb_log2=ctb_log2, sub_w=sub,
        sub_h=sub)
    ref = jax_sharded(_mesh(n_bands), y, cb, cr, qp4, bs_v, bs_h, *offs,
                      st, sp, so, sc, bit_depth=bd, ctb_log2=ctb_log2,
                      sub_w=sub, sub_h=sub)
    for p, name in enumerate(("y", "cb", "cr")):
        _assert_equal(got[p], single[p].numpy(), f"{name} vs single device")
        if p == 0 or sub == 2:
            _assert_equal(got[p], ref[p], f"{name} vs JAX")


def test_sharded_deblock_only_matches_single_device_and_jax():
    w, h = 256, 64
    rng = np.random.default_rng(3)
    y, cb, cr, qp4, bs_v, bs_h = _random_frame(rng, w, h)
    t = torch.from_numpy
    single = deblock(t(y), t(cb), t(cr), t(qp4), t(bs_v), t(bs_h), 2, -2,
                     0, 0, tables_from_reference("cpu"))
    z = tuple(np.zeros((h >> 6 or 1, w >> 6, *(4,) * (i == 2)), np.int32)
              for i in range(3))
    sao = ((z[0],) * 3, (z[0],) * 3, (z[2],) * 3, (z[0],) * 3)
    got = filter_frame_sharded(BandLayout(["cpu"] * 4), y, cb, cr, qp4,
                               bs_v, bs_h, 2, -2, 0, 0, *sao, bit_depth=8,
                               ctb_log2=6, do_sao=False)
    ref = jax_sharded(_mesh(4), y, cb, cr, qp4, bs_v, bs_h, 2, -2, 0, 0,
                      *sao, bit_depth=8, ctb_log2=6, do_sao=False)
    for p in range(3):
        _assert_equal(got[p], single[p].numpy(), f"plane {p} vs single")
        _assert_equal(got[p], ref[p], f"plane {p} vs JAX")


def test_sharded_filters_refuse_a_band_of_part_of_a_ctb():
    rng = np.random.default_rng(1)
    y, cb, cr, qp4, bs_v, bs_h = _random_frame(rng, 192, 64)
    st, sp, so, sc = _random_sao(rng, 192, 64)
    with pytest.raises(ValueError, match="multiple of the CTB"):
        filter_frame_sharded(BandLayout(["cpu"] * 2), y, cb, cr, qp4, bs_v,
                             bs_h, 0, 0, 0, 0, st, sp, so, sc, bit_depth=8,
                             ctb_log2=6)


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("sub_w,sub_h", [(2, 2), (2, 1)], ids=["420", "422"])
def test_sharded_filters_with_slice_maps_match_single_device(n_bands, sub_w,
                                                             sub_h):
    w, h, ctb_log2, bd = 512, 128, 6, 8
    rng = np.random.default_rng(11 * n_bands + sub_h)
    y, _cb, _cr, qp4, bs_v, bs_h = _random_frame(rng, w, h, bd)
    cb, cr = (rng.integers(0, 1 << bd, (h // sub_h, w // sub_w), np.int32)
              for _ in range(2))
    beta = 2 * rng.integers(-6, 7, qp4.shape).astype(np.int32)
    tc = 2 * rng.integers(-6, 7, qp4.shape).astype(np.int32)
    flags = rng.integers(0, 256, (h >> ctb_log2, w >> ctb_log2)).astype(
        np.uint8)
    nf4 = rng.random(qp4.shape) < 0.1
    st, sp, so, sc = _random_sao(rng, w, h, ctb_log2)
    t = torch.from_numpy
    nf_y, nf_c = _nf_masks(t(nf4), sub_w, sub_h)
    ry, rcb, rcr = deblock(t(y), t(cb), t(cr), t(qp4), t(bs_v), t(bs_h),
                           t(beta), t(tc), 1, -1,
                           tables_from_reference("cpu"), bd=bd, sub_w=sub_w,
                           sub_h=sub_h, nf_y=nf_y, nf_c=nf_c)
    single = []
    for i, p in enumerate((ry, rcb, rcr)):
        lg = (ctb_log2, ctb_log2) if i == 0 else (
            ctb_log2 - sub_h + 1, ctb_log2 - sub_w + 1)
        single.append(sao_plane(p, t(st[i]), t(sp[i]), t(so[i]), t(sc[i]),
                                lg, bd, edge_flags=t(flags.astype(np.int32)),
                                nf=nf_y if i == 0 else nf_c))
    got = filter_frame_sharded(
        BandLayout(["cpu"] * n_bands), y, cb, cr, qp4, bs_v, bs_h, beta, tc,
        1, -1, st, sp, so, sc, bit_depth=bd, ctb_log2=ctb_log2, sub_w=sub_w,
        sub_h=sub_h, edge_flags=flags, no_filter=nf4)
    for p, name in enumerate(("y", "cb", "cr")):
        _assert_equal(got[p], single[p].numpy(), f"{name} vs single device")
