"""The loop filter kernels (``hevc_tpu_torch/csrc/filters.cu``) and their
wrapper (``filters_cuda``) on the CPU.

(a) The kernels' per-item code, built by the host's C++ compiler (the file
    exports ``hevc_deblock_host`` / ``hevc_sao_host`` without
    ``__CUDACC__``), against the plain versions on every case of
    ``hevc_tpu_torch.filter_cases``, bit for bit, with every sample of the
    canvas outside the planes left as it was;
(b) the wrapper on CPU tensors: the plain path, equal to the
    ``filters.deblock`` / ``deblock_luma`` / ``sao_plane`` calls the frame
    program made before it (sample masks from the per-4x4 ``nf`` map),
    deblocking in place as on the card, no launch counted; the frame
    program on a stream through it;
(c) the kernels' constant tables against ``tables.py``; the wrapper's
    refusals; ``bounds.loop_filter_work`` against a recount.
The same code against the JAX package's filters is in
tests/test_torch_loop_filter_jax.py, the card's run of these cases in
tests/test_torch_cuda.py.
"""
import re

import numpy as np
import pytest
import torch

from hevc_tpu_torch import (build, filter_cases, filters, filters_cuda,
                            native, pipeline, trace)
from hevc_tpu_torch.bounds import loop_filter_work
from hevc_tpu_torch.tables import tables_from_reference
from loop_filter_host import SRC, build_host_lib, host_filters
from torch_gate import native_ready
from torch_streams import CONFIGS, decode_port, encode_config

CPU = torch.device("cpu")
CASES = sorted(filter_cases.CASES)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """filters.cu built by the host's C++ compiler."""
    return build_host_lib(tmp_path_factory.mktemp("filters"))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_kernel_code_matches_plain(host_lib, name, seed):
    case = filter_cases.make(name, seed)
    canvas, got = filter_cases.run(case, CPU, *host_filters(host_lib))
    _c, want = filter_cases.run(case, CPU, filters_cuda.deblock_plain,
                                filters_cuda.sao_plain)
    assert len(got) == len(want) == len(case["regions"])
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"{name} plane {k}: " \
            f"{int((g != w).sum())} samples differ"
    out = filter_cases.outside(case)
    assert np.array_equal(canvas.numpy()[out], case["canvas"][out])
    # the case filters something in every plane
    for (oy, ox, h, w), p in zip(case["regions"], want):
        assert not np.array_equal(p.numpy(),
                                  case["canvas"][oy:oy + h, ox:ox + w])


@pytest.mark.parametrize("bs", [1, 2])
def test_kernel_code_matches_plain_at_the_luma_thresholds(host_lib, bs):
    """One 8-bit luma plane of flat 8-sample blocks: segment m at QP 20 +
    m, the step at edge j of j samples (alternating up and down), so that
    every QP meets every step across the strong/weak choice (|p0 - q0| <
    (5 tc + 1) >> 1, which only an odd tc at 8 bits can tell from 5 tc >> 1)
    and the weak filter's |delta| < 10 tc."""
    n_seg, n_e = 32, 31
    v = np.cumsum([128] + [j * (-1) ** j for j in range(n_e)])
    plane = np.repeat(np.repeat(v[None, :], 8, 1), 4 * n_seg, 0)
    qp4 = np.repeat((20 + np.arange(n_seg))[:, None], 2 * (n_e + 1), 1)
    maps = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in
            (qp4, np.full(qp4.shape, bs), np.zeros(qp4.shape))]
    zero = torch.zeros((), dtype=torch.int32)
    args = (*maps, zero, zero, (), tables_from_reference(CPU), 8, 1, 1, None)
    deblock, _sao = host_filters(host_lib)
    got = deblock([torch.from_numpy(plane.astype(np.int32))], *args)
    want = filters_cuda.deblock_plain(
        [torch.from_numpy(plane.astype(np.int32))], *args)
    assert torch.equal(got[0], want[0])
    # both filters engage: a strong edge changes p2, a weak one does not
    changed = (want[0].numpy() != plane)[:, 5::8][:, :n_e]
    assert changed.any() and not changed.all()


def _before(planes, qp4, bs_v, bs_h, beta, tc, qp_offs, tables, bd, sub_w,
            sub_h, nf4):
    """The frame program's filter calls as they were before the kernels:
    pixel masks from the per-4x4 map, then ``filters`` plane by plane."""
    nf_y = nf_c = None
    if nf4 is not None:
        nf_l = (nf4 != 0).repeat_interleave(4, 0).repeat_interleave(4, 1)
        nf_y = nf_l[:planes[0].shape[0], :planes[0].shape[1]]
        hc, wc = planes[-1].shape
        nf_c = nf_l[::sub_h, ::sub_w][:hc, :wc]
    if len(planes) == 1:
        return [filters.deblock_luma(planes[0], qp4, bs_v, bs_h, beta, tc,
                                     tables, bd, nf_y)], nf_y, nf_c
    return list(filters.deblock(*planes, qp4, bs_v, bs_h, beta, tc,
                                *qp_offs, tables, bd=bd, sub_w=sub_w,
                                sub_h=sub_h, nf_y=nf_y, nf_c=nf_c)), nf_y, \
        nf_c


@pytest.mark.parametrize("name", CASES)
def test_wrapper_takes_the_plain_path_on_the_cpu(name):
    case = filter_cases.make(name, 3)
    _canvas, planes, d, s = filter_cases.tensors(case, CPU)
    build.reset_launches()
    trace.reset()
    want, nf_y, nf_c = _before(planes, *d)
    if not case["deblock"]:
        want = planes
    deblocked = [w.clone() for w in want]
    t, b, o, e, lg = s[:5]
    want = [filters.sao_plane(
        p, t[k], b[k], o[k], e[k],
        (lg, lg) if k == 0 else (lg - (case["sub_h"] == 2),
                                 lg - (case["sub_w"] == 2)),
        case["bd"], edge_flags=s[8], nf=nf_y if k == 0 else nf_c)
        for k, p in enumerate(want)] if case["sao"] else want
    got = planes
    if case["deblock"]:
        got = filters_cuda.deblock_planes(got, *d)
        # in place, as on the card
        assert all(g is p for g, p in zip(got, planes))
    assert all(torch.equal(p, w) for p, w in zip(planes, deblocked))
    if case["sao"]:
        got = filters_cuda.sao_planes(got, *s)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.launches["deblock"] == build.launches["sao"] == 0
    assert "loop_filter_launches" not in trace.report()


@pytest.mark.skipif(not native_ready(native),
                    reason="native toolchain unavailable")
@pytest.mark.parametrize("name", ["ipp_wpp", "slices_pcm", "mono"])
def test_frame_program_filters_through_the_wrapper_on_the_cpu(
        monkeypatch, name):
    """Every picture of a stream takes the wrapper's plain path once per
    filter, no kernel launch is counted, and every MD5 holds."""
    calls = {"deblock": 0, "sao": 0}
    on = {"deblock": 0, "sao": 0}

    def counted(fn, key):
        def run(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return run

    def pack(pic):
        out = orig_pack(pic)
        spec = dict(out[6])
        on["deblock"] += bool(spec["do_deblock"])
        on["sao"] += bool(spec["do_sao"])
        return out

    orig_pack = pipeline.pack_frame
    monkeypatch.setattr(pipeline, "pack_frame", pack)
    monkeypatch.setattr(filters_cuda, "deblock_plain",
                        counted(filters_cuda.deblock_plain, "deblock"))
    monkeypatch.setattr(filters_cuda, "sao_plain",
                        counted(filters_cuda.sao_plain, "sao"))
    build.reset_launches()
    frames, n = decode_port(encode_config(*CONFIGS[name]), CPU)
    assert all(md5 is True for _p, md5, _poc in frames)
    assert n == len(frames) and calls == on and on["deblock"] == n
    assert on["sao"] > 0
    assert build.launches["deblock"] == build.launches["sao"] == 0


def _table(name):
    body = re.search(rf"c_{name}\[\d+\] = \{{([^}}]*)\}}",
                     open(SRC).read()).group(1)
    return [int(v) for v in body.replace("\n", " ").split(",")]


@pytest.mark.parametrize("name", ["beta", "tc", "qpc"])
def test_kernel_tables_mirror_the_reference(name):
    assert _table(name) == tables_from_reference(CPU)[name].tolist()


def _args(name="420_10bit_slices_nf"):
    """A case's planes and the wrapper's ``deblock_params`` and
    ``sao_params`` arguments after them."""
    _canvas, planes, d, s = filter_cases.tensors(filter_cases.make(name),
                                                 CPU)
    return planes, list(d[:6]) + list(d[7:]), list(s)


DEBLOCK_REFUSES = {"plane_dtype", "plane_columns", "map_shape", "map_dtype",
                   "bit_depth", "two_planes", "nf_shape"}
SAO_REFUSES = {"plane_dtype", "plane_columns", "bit_depth", "two_planes",
               "sao_maps", "nf_shape"}


@pytest.mark.parametrize("what", sorted(DEBLOCK_REFUSES | SAO_REFUSES))
def test_wrapper_refuses_what_the_kernels_do_not_take(what):
    planes, d, s = _args()
    if what == "plane_dtype":
        planes[1] = planes[1].to(torch.int16)
    elif what == "plane_columns":
        planes[0] = planes[0][:, ::2]
    elif what == "map_shape":
        d[1] = d[1][:-1]
    elif what == "map_dtype":
        d[2] = d[2].to(torch.int8)
    elif what == "bit_depth":
        d[6] = s[5] = 7
    elif what == "two_planes":
        planes = planes[:2]
    elif what == "sao_maps":
        s[0] = s[0][:, :-1]
    elif what == "nf_shape":
        d[9] = d[9][:, :-1]
        s[9] = s[9][:-1]
    if what in DEBLOCK_REFUSES:
        with pytest.raises(ValueError):
            filters_cuda.deblock_params(planes, *d)
    if what in SAO_REFUSES:
        with pytest.raises(ValueError):
            filters_cuda.sao_params(planes, *s)


@pytest.mark.parametrize("name", CASES)
def test_loop_filter_work_counts_each_pass(name):
    case = filter_cases.make(name)
    shapes = [(h, w) for _oy, _ox, h, w in case["regions"]]
    h4, w4 = case["qp4"].shape
    cth, ctw = case["sao_t"].shape[1:]
    per_slice = case["edge_flags"] is not None
    nf = case["nf4"] is not None
    got = loop_filter_work(shapes, h4, w4, cth, ctw, case["deblock"],
                           case["sao"], per_slice, nf)
    planes = sum(2 * 4 * h * w for h, w in shapes)
    # a deblocking pass writes 6 of 8 luma samples and 2 of 8 chroma ones
    db_planes = sum(4 * h * w * (14 if k == 0 else 10) // 8
                    for k, (h, w) in enumerate(shapes))
    maps = (4 if per_slice else 2) * 4 * h4 * w4 + (0 if per_slice else 16)
    nf_b = 4 * h4 * w4 if nf else 0
    want_db = db_planes + maps + nf_b if case["deblock"] else 0
    want_sao = (planes + len(shapes) * 7 * 4 * cth * ctw
                + (4 * cth * ctw if per_slice else 0) + nf_b) \
        if case["sao"] else 0
    assert got == {"deblock_v": want_db, "deblock_h": want_db,
                   "sao": want_sao}
