"""The loop filter kernels' code against the JAX package's filters, on the
same inputs, bit for bit (tolerance 0).

``csrc/filters.cu`` built by the host's C++ compiler
(tests/loop_filter_host.py) runs the kernels' per-item code through the
wrapper's parameters:
(a) on the inputs of tests/test_torch_filter_maps.py: deblocking with
    per-4x4 offset maps or scalar offsets and PCM/TQB nf maps, 8 to 12
    bit, against ``hevc_tpu.tpu.filters.deblock_jax`` in 4:2:0 and its
    luma in 4:0:0; SAO with per-CTB slice/tile edge flags and nf maps
    against ``sao_plane_jax``; 4:2:2 and 4:4:4, where those two raise,
    against the NumPy filters the inline decoder runs
    (``hevc_tpu.ops.deblock.deblock_frame``, ``ops.sao.apply_sao_frame``);
(b) on every picture of ``hevc_tpu_torch.filter_cases`` (canvas views,
    deblocking and SAO as the case turns them on): against ``deblock_jax``
    then ``sao_plane_jax`` for 4:0:0 and 4:2:0, and against the NumPy
    filters for 4:2:2 and 4:4:4.
"""
import numpy as np
import pytest
import torch

import test_torch_filter_maps as fm
from hevc_tpu.ops.deblock import deblock_frame
from hevc_tpu.ops.sao import SaoParams, apply_sao_frame
from hevc_tpu.tpu.filters import deblock_jax, sao_plane_jax
from hevc_tpu_torch import filter_cases
from loop_filter_host import build_host_lib, host_filters

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """(deblock, sao): the kernels' code on host memory."""
    return host_filters(build_host_lib(tmp_path_factory.mktemp("filters")))


def _i32(a):
    """A new int32 tensor of ``a`` (the kernels' code writes in place)."""
    return torch.from_numpy(np.array(a, np.int32))


def _pixels(nf4, shape, sub_w=1, sub_h=1):
    """The bool sample mask of a per-4x4 nf map for a plane of ``shape``
    subsampled by (sub_w, sub_h); None without a map."""
    if nf4 is None:
        return None
    m = np.repeat(np.repeat(nf4 != 0, 4, 0), 4, 1)[::sub_h, ::sub_w]
    return m[:shape[0], :shape[1]]


def _kernel_deblock(host, planes, maps, beta, tc, offs, bd, sub_w, sub_h,
                    nf4):
    ts = [_i32(p) for p in planes]
    host[0](ts, *(_i32(m) for m in maps), _i32(beta), _i32(tc),
            tuple(_i32(o) for o in offs), None, bd, sub_w, sub_h,
            None if nf4 is None else _i32(nf4))
    return [t.numpy() for t in ts]


def _kernel_sao(host, planes, typ, pos, offs, eo, lg, bd, sub_w, sub_h,
                flags, nf4):
    """SAO of ``planes`` with per-plane per-CTB maps stacked as the frame
    program hands them ([planes, cty, ctx], offsets [..., 4])."""
    out = host[1]([_i32(p) for p in planes], _i32(typ), _i32(pos),
                  _i32(offs), _i32(eo), lg, bd, sub_w, sub_h,
                  None if flags is None else _i32(flags),
                  None if nf4 is None else _i32(nf4))
    return [t.numpy() for t in out]


# ---------------------------------------------------------------------------
# (a) the inputs of tests/test_torch_filter_maps.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,h,w,bd,maps,nf", [
    (1, 64, 96, 8, True, True),
    (2, 48, 80, 10, True, False),
    (3, 64, 64, 8, False, True),
    (4, 72, 120, 12, True, True),
])
def test_kernel_deblock_matches_deblock_jax(host, seed, h, w, bd, maps, nf):
    planes, m, beta, tc, nf4, offs = fm._deblock_case(seed, h, w, bd, 1,
                                                      maps, nf)
    got = _kernel_deblock(host, planes, m, beta, tc, offs, bd, 2, 2, nf4)
    nf_y, nf_c = _pixels(nf4, (h, w)), _pixels(nf4, (h // 2, w // 2), 2, 2)
    want = deblock_jax(*planes, *m, np.asarray(beta, np.int32),
                       np.asarray(tc, np.int32), *offs, bd=bd, has_nf=nf,
                       nf_y=nf_y, nf_c=nf_c)
    for p in range(3):
        assert np.array_equal(got[p], np.asarray(want[p])), f"plane {p}"
    assert all(not np.array_equal(g, p) for g, p in zip(got, planes))
    # 4:0:0: the luma plane alone
    luma = _kernel_deblock(host, planes[:1], m, beta, tc, (), bd, 1, 1, nf4)
    assert np.array_equal(luma[0], np.asarray(want[0]))


@pytest.mark.parametrize("cf", [2, 3])
@pytest.mark.parametrize("seed,maps,nf", [(5, True, True), (6, False, False),
                                          (7, True, False)])
def test_kernel_deblock_422_444_matches_numpy_filters(host, cf, seed, maps,
                                                      nf):
    h, w, bd = 64, 96, 10 if seed == 6 else 8
    sub_w, sub_h = fm.SUB[cf]
    planes, m, beta, tc, nf4, offs = fm._deblock_case(seed, h, w, bd, cf,
                                                      maps, nf)
    got = _kernel_deblock(host, planes, m, beta, tc, offs, bd, sub_w, sub_h,
                          nf4)
    want = [p.copy() for p in planes]
    deblock_frame(want, m[0], m[1], m[2], bit_depth=bd, beta_offset=beta,
                  tc_offset=tc, chroma_format_idc=cf, cb_qp_offset=offs[0],
                  cr_qp_offset=offs[1], no_filter4=nf4)
    for p in range(3):
        assert np.array_equal(got[p], want[p]), f"plane {p}"
    assert all(not np.array_equal(g, p) for g, p in zip(got, planes))


@pytest.mark.parametrize("seed,h,w,lg,bd,flags,nf", [
    (1, 64, 96, 4, 8, True, True),
    (2, 48, 80, 5, 10, True, False),
    (3, 72, 120, 4, 8, False, True),
    (4, 40, 56, 3, 12, True, True),
])
def test_kernel_sao_matches_sao_plane_jax(host, seed, h, w, lg, bd, flags,
                                          nf):
    """One plane (the kernels' 4:0:0 call); the nf map per 4x4, as the
    kernels take it."""
    plane, typ, pos, offs, eo, fl, _m = fm._sao_case(seed, h, w, lg, lg, bd,
                                                     flags, False)
    nf4 = np.random.default_rng([seed, 4]).random((h // 4, w // 4)) < 0.15 \
        if nf else None
    (got,) = _kernel_sao(host, [plane], typ[None], pos[None], offs[None],
                         eo[None], lg, bd, 1, 1, fl, nf4)
    want = sao_plane_jax(plane, typ, pos, offs, eo, lg, bd, edge_flags=fl,
                         nf=_pixels(nf4, (h, w)))
    assert np.array_equal(got, np.asarray(want))
    assert not np.array_equal(got, plane)


@pytest.mark.parametrize("cf,flags,nf", [(2, True, True), (2, False, False),
                                         (3, True, False)])
def test_kernel_sao_422_444_matches_numpy_filters(host, cf, flags, nf):
    """The three planes of one picture in one call: chroma CTBs of
    2^(lg - log2 sub_h) x 2^(lg - log2 sub_w) samples."""
    h, w, lg, bd = 64, 96, 4, 8
    sub_w, sub_h = fm.SUB[cf]
    rng = np.random.default_rng(10 + cf)
    cty, ctx = h >> lg, w >> lg
    cases = [fm._sao_case(20 + k, h // (sub_h if k else 1),
                          w // (sub_w if k else 1),
                          lg - (sub_h - 1 if k else 0),
                          lg - (sub_w - 1 if k else 0), bd, False, False)
             for k in range(3)]
    # cb and cr share their type and edge class (7.3.8.3)
    typ = rng.integers(0, 3, (2, cty, ctx))[[0, 1, 1]]
    eo = rng.integers(0, 4, (2, cty, ctx))[[0, 1, 1]]
    fl = rng.integers(0, 256, (cty, ctx)).astype(np.int32) if flags \
        else None
    nf4 = rng.random((h // 4, w // 4)) < 0.2 if nf else None
    pos = np.stack([c[2] for c in cases])
    offs = np.stack([c[3] for c in cases])
    planes = [c[0] for c in cases]
    got = _kernel_sao(host, planes, typ, pos, offs, eo, lg, bd, sub_w,
                      sub_h, fl, nf4)
    want = [p.copy() for p in planes]
    apply_sao_frame(want, _sao_map(typ, pos, offs, eo), 1 << lg, bd, sub_w,
                    sub_h, edge_flags=fl, no_filter4=nf4)
    for k in range(3):
        assert np.array_equal(got[k], want[k]), f"plane {k}"
        assert not np.array_equal(got[k], planes[k])


def _sao_map(typ, pos, offs, eo):
    """``apply_sao_frame``'s {(ctb x, ctb y): SaoParams} of per-plane
    per-CTB maps [planes, cty, ctx] (offsets [..., 4])."""
    out = {}
    for yc in range(typ.shape[1]):
        for xc in range(typ.shape[2]):
            prm = SaoParams()
            for k in range(typ.shape[0]):
                prm.type_idx[k] = int(typ[k, yc, xc])
                prm.eo_class[k] = int(eo[k, yc, xc])
                prm.band_position[k] = int(pos[k, yc, xc])
                prm.offsets[k] = [int(v) for v in offs[k, yc, xc]]
            out[(xc, yc)] = prm
    return out


# ---------------------------------------------------------------------------
# (b) the pictures of hevc_tpu_torch.filter_cases
# ---------------------------------------------------------------------------

def _offset(a):
    """A filter case's beta/tc offset as the NumPy filters take it: a
    per-4x4 map or an int."""
    a = np.asarray(a)
    return a.astype(np.int32) if a.ndim == 2 else int(a)


def _reference(case):
    """The case's output planes by the JAX package: ``deblock_jax`` and
    ``sao_plane_jax`` for 4:0:0 and 4:2:0 (4:0:0's luma deblocked as a
    4:2:0 picture's, beside blank chroma), the NumPy filters for 4:2:2 and
    4:4:4."""
    cf, bd, lg = case["format"], case["bd"], case["ctb_log2"]
    sub_w, sub_h = case["sub_w"], case["sub_h"]
    planes = [case["canvas"][oy:oy + h, ox:ox + w].astype(np.int32)
              for oy, ox, h, w in case["regions"]]
    shapes = [p.shape for p in planes]
    nf4 = None if case["nf4"] is None else case["nf4"] != 0
    maps = [case[k].astype(np.int32) for k in ("qp4", "bs_v", "bs_h")]
    beta, tc = _offset(case["beta_off"]), _offset(case["tc_off"])
    qp_offs = [int(v) for v in case["qp_offs"]]
    sao = [case[k].astype(np.int32) for k in ("sao_t", "sao_b", "sao_o",
                                              "sao_e")]
    fl = case["edge_flags"]
    fl = None if fl is None else fl.astype(np.int32)
    if cf in (2, 3):
        if case["deblock"]:
            deblock_frame(planes, *maps, bit_depth=bd, beta_offset=beta,
                          tc_offset=tc, chroma_format_idc=cf,
                          cb_qp_offset=qp_offs[0], cr_qp_offset=qp_offs[1],
                          no_filter4=nf4)
        if case["sao"]:
            apply_sao_frame(planes, _sao_map(*sao), 1 << lg, bd, sub_w, sub_h,
                            edge_flags=fl, no_filter4=nf4)
        return planes
    h, w = shapes[0]
    if case["deblock"]:
        chroma = planes[1:] or [np.zeros((h // 2, w // 2), np.int32)] * 2
        out = deblock_jax(planes[0], *chroma, *maps,
                          np.asarray(beta, np.int32),
                          np.asarray(tc, np.int32), *qp_offs, bd=bd,
                          has_nf=nf4 is not None,
                          nf_y=_pixels(nf4, shapes[0]),
                          nf_c=_pixels(nf4, chroma[0].shape, 2, 2))
        planes = [np.asarray(o) for o in out[:len(planes)]]
    if case["sao"]:
        planes = [np.asarray(sao_plane_jax(
            p, sao[0][k], sao[1][k], sao[2][k], sao[3][k], lg - (k > 0), bd,
            edge_flags=fl, nf=_pixels(nf4, p.shape, 1 + (k > 0),
                                      1 + (k > 0))))
            for k, p in enumerate(planes)]
    return planes


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(filter_cases.CASES))
def test_kernel_code_matches_the_jax_package_on_filter_cases(host, name,
                                                             seed):
    case = filter_cases.make(name, seed)
    _canvas, got = filter_cases.run(case, CPU, *host)
    want = _reference(case)
    assert len(got) == len(want) == len(case["regions"])
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), w), \
            f"{name} plane {k}: {int((g.numpy() != w).sum())} samples differ"
