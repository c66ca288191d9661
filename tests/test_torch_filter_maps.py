"""The port's in-loop filters with the JAX version's maps and masks, on
seeded random planes, bit for bit (tolerance 0).

(a) ``filters.deblock`` with per-4x4 beta/tc offset maps and PCM/TQB
    exemption masks against ``hevc_tpu.tpu.filters.deblock_jax``, and
    ``deblock_luma`` (the whole of 4:0:0's deblocking) against its luma;
(b) ``filters.sao_plane`` with per-CTB slice/tile edge restrictions and
    an exemption mask against ``sao_plane_jax``;
(c) 4:2:2 and 4:4:4, where ``deblock_jax`` and ``sao_plane_jax`` raise:
    against the NumPy filters the inline decoder runs
    (``hevc_tpu.ops.deblock.deblock_frame``, ``ops.sao.apply_sao_frame``).
"""
import numpy as np
import pytest
import torch

from hevc_tpu.ops.deblock import deblock_frame
from hevc_tpu.ops.sao import SaoParams, apply_sao_frame
from hevc_tpu.tpu.filters import deblock_jax, sao_plane_jax
from hevc_tpu_torch.filters import deblock, deblock_luma, sao_plane
from hevc_tpu_torch.tables import tables_from_reference

CPU = torch.device("cpu")
T = tables_from_reference(CPU)
SUB = {1: (2, 2), 2: (2, 1), 3: (1, 1)}   # chroma format -> (sub_w, sub_h)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _deblock_case(seed, h, w, bd, cf, maps, nf):
    """Planes, QP/BS maps, offsets (maps or scalars) and an nf mask."""
    rng = np.random.default_rng(seed)
    sub_w, sub_h = SUB[cf]
    h4, w4 = h // 4, w // 4
    # smooth content, so that the strong and weak filters both engage
    base = rng.integers(0, 1 << bd, (h // 8 + 1, w // 8 + 1))
    y = np.repeat(np.repeat(base, 8, 0), 8, 1)[:h, :w]
    y = np.clip(y + rng.integers(-3, 4, (h, w)), 0, (1 << bd) - 1)
    cb, cr = (np.clip(y[::sub_h, ::sub_w]
                      + rng.integers(-2, 3, (h // sub_h, w // sub_w)),
                      0, (1 << bd) - 1) for _ in range(2))
    qp = rng.integers(20, 52, (h4, w4))
    bs_v = rng.integers(0, 3, (h4, w4))
    bs_h = rng.integers(0, 3, (h4, w4))
    if maps:
        ctb = rng.integers(-6, 7, (2, -(-h4 // 4), -(-w4 // 4)))
        beta, tc = (np.repeat(np.repeat(m, 4, 0), 4, 1)[:h4, :w4]
                    for m in ctb)
    else:
        beta, tc = (int(v) for v in rng.integers(-6, 7, 2))
    nf4 = rng.random((h4, w4)) < 0.2 if nf else None
    offs = (int(rng.integers(-4, 5)), int(rng.integers(-4, 5)))
    return [a.astype(np.int32) for a in (y, cb, cr)], \
        [a.astype(np.int32) for a in (qp, bs_v, bs_h)], beta, tc, nf4, offs


def _nf_masks(nf4, h, w, sub_w, sub_h):
    if nf4 is None:
        return None, None
    nf_l = np.repeat(np.repeat(nf4, 4, 0), 4, 1)[:h, :w]
    return _t(nf_l), _t(nf_l[::sub_h, ::sub_w])


def _port_deblock(planes, maps, beta, tc, nf4, offs, bd, cf):
    sub_w, sub_h = SUB[cf]
    h, w = planes[0].shape
    nf_y, nf_c = _nf_masks(nf4, h, w, sub_w, sub_h)
    off = [_t(np.asarray(v, np.int32)) for v in (beta, tc) + offs]
    out = deblock(*(_t(p) for p in planes), *(_t(m) for m in maps), *off,
                  T, bd=bd, sub_w=sub_w, sub_h=sub_h, nf_y=nf_y, nf_c=nf_c)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("seed,h,w,bd,maps,nf", [
    (1, 64, 96, 8, True, True),
    (2, 48, 80, 10, True, False),
    (3, 64, 64, 8, False, True),
    (4, 72, 120, 12, True, True),
])
def test_deblock_maps_and_nf_match_jax(seed, h, w, bd, maps, nf):
    planes, m, beta, tc, nf4, offs = _deblock_case(seed, h, w, bd, 1, maps,
                                                   nf)
    got = _port_deblock(planes, m, beta, tc, nf4, offs, bd, 1)
    nf_y, nf_c = _nf_masks(nf4, h, w, 2, 2)
    want = deblock_jax(*planes, *m, np.asarray(beta, np.int32),
                       np.asarray(tc, np.int32), *offs, bd=bd,
                       has_nf=nf, nf_y=None if nf_y is None else
                       nf_y.numpy(), nf_c=None if nf_c is None else
                       nf_c.numpy())
    for p in range(3):
        assert np.array_equal(got[p], np.asarray(want[p])), f"plane {p}"
    assert any(not np.array_equal(g, p) for g, p in zip(got, planes))
    # 4:0:0: the luma pass pair alone
    luma = deblock_luma(_t(planes[0]), *(_t(a) for a in m),
                        _t(np.asarray(beta, np.int32)),
                        _t(np.asarray(tc, np.int32)), T, bd, nf_y)
    assert np.array_equal(luma.numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("cf", [2, 3])
@pytest.mark.parametrize("seed,maps,nf", [(5, True, True), (6, False, False),
                                          (7, True, False)])
def test_deblock_422_444_matches_numpy_filters(cf, seed, maps, nf):
    h, w, bd = 64, 96, 10 if seed == 6 else 8
    planes, m, beta, tc, nf4, offs = _deblock_case(seed, h, w, bd, cf, maps,
                                                   nf)
    got = _port_deblock(planes, m, beta, tc, nf4, offs, bd, cf)
    want = [p.copy() for p in planes]
    deblock_frame(want, m[0], m[1], m[2], bit_depth=bd, beta_offset=beta,
                  tc_offset=tc, chroma_format_idc=cf, cb_qp_offset=offs[0],
                  cr_qp_offset=offs[1], no_filter4=nf4)
    for p in range(3):
        assert np.array_equal(got[p], want[p]), f"plane {p}"
    assert not np.array_equal(got[1], planes[1])


def _sao_case(seed, h, w, lh, lw, bd, flags, nf):
    rng = np.random.default_rng(seed)
    cty, ctx = -(-h >> lh), -(-w >> lw)
    plane = rng.integers(0, 1 << bd, (h, w)).astype(np.int32)
    plane = np.clip(np.cumsum(plane % 7 - 3, 1) + (1 << (bd - 1)), 0,
                    (1 << bd) - 1).astype(np.int32)
    typ = rng.integers(0, 3, (cty, ctx)).astype(np.int32)
    pos = rng.integers(0, 32, (cty, ctx)).astype(np.int32)
    offs = rng.integers(-7, 8, (cty, ctx, 4)).astype(np.int32)
    eo = rng.integers(0, 4, (cty, ctx)).astype(np.int32)
    fl = rng.integers(0, 256, (cty, ctx)).astype(np.int32) if flags \
        else None
    m = rng.random((h, w)) < 0.15 if nf else None
    return plane, typ, pos, offs, eo, fl, m


@pytest.mark.parametrize("seed,h,w,lg,bd,flags,nf", [
    (1, 64, 96, 4, 8, True, True),
    (2, 48, 80, 5, 10, True, False),
    (3, 72, 120, 4, 8, False, True),
    (4, 40, 56, 3, 12, True, True),
])
def test_sao_edge_flags_and_nf_match_jax(seed, h, w, lg, bd, flags, nf):
    plane, typ, pos, offs, eo, fl, m = _sao_case(seed, h, w, lg, lg, bd,
                                                 flags, nf)
    got = sao_plane(_t(plane), _t(typ), _t(pos), _t(offs), _t(eo), lg, bd,
                    edge_flags=None if fl is None else _t(fl),
                    nf=None if m is None else _t(m))
    want = sao_plane_jax(plane, typ, pos, offs, eo, lg, bd, edge_flags=fl,
                         nf=m)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), plane)


@pytest.mark.parametrize("cf,flags,nf", [(2, True, True), (2, False, False),
                                         (3, True, False)])
def test_sao_422_444_matches_numpy_filters(cf, flags, nf):
    """The three planes of one picture: chroma CTBs of 2^(lg - log2 sub_h)
    x 2^(lg - log2 sub_w) samples."""
    h, w, lg, bd = 64, 96, 4, 8
    sub_w, sub_h = SUB[cf]
    rng = np.random.default_rng(10 + cf)
    cty, ctx = h >> lg, w >> lg
    cases = [_sao_case(20 + k, h // (sub_h if k else 1),
                       w // (sub_w if k else 1),
                       lg - (sub_h - 1 if k else 0),
                       lg - (sub_w - 1 if k else 0), bd, False, False)
             for k in range(3)]
    typ = rng.integers(0, 3, (2, cty, ctx))
    eo = rng.integers(0, 4, (2, cty, ctx))
    fl = rng.integers(0, 256, (cty, ctx)).astype(np.int32) if flags \
        else None
    nf4 = rng.random((h // 4, w // 4)) < 0.2 if nf else None
    nf_y, nf_c = _nf_masks(nf4, h, w, sub_w, sub_h)
    sao_map = {}
    for yc in range(cty):
        for xc in range(ctx):
            prm = SaoParams()
            for k in range(3):
                # cb and cr share their type and edge class (7.3.8.3)
                prm.type_idx[k] = int(typ[min(k, 1), yc, xc])
                prm.eo_class[k] = int(eo[min(k, 1), yc, xc])
                prm.band_position[k] = int(cases[k][2][yc, xc])
                prm.offsets[k] = cases[k][3][yc, xc].tolist()
            sao_map[(xc, yc)] = prm
    want = [c[0].copy() for c in cases]
    apply_sao_frame(want, sao_map, 1 << lg, bd, sub_w, sub_h,
                    edge_flags=fl, no_filter4=nf4)
    for k, c in enumerate(cases):
        t = np.asarray([[sao_map[(x, y)].type_idx[k] for x in range(ctx)]
                        for y in range(cty)], np.int32)
        e = np.asarray([[sao_map[(x, y)].eo_class[k] for x in range(ctx)]
                        for y in range(cty)], np.int32)
        lgs = (lg - (sub_h - 1 if k else 0), lg - (sub_w - 1 if k else 0))
        got = sao_plane(_t(c[0]), _t(t), _t(c[2]), _t(c[3]), _t(e), lgs,
                        bd, edge_flags=None if fl is None else _t(fl),
                        nf=nf_y if k == 0 else nf_c)
        assert np.array_equal(got.numpy(), want[k]), f"plane {k}"
        assert not np.array_equal(got.numpy(), c[0])
