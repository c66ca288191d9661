"""The residual-stage kernel (``hevc_tpu_torch/csrc/resid.cu``) and its
wrapper (``resid_cuda``) on the CPU.

(a) The kernel's per-lane code, built by the host's C++ compiler (the file
    exports ``hevc_residuals_host`` without ``__CUDACC__``), against the
    plain version (``recon.residuals``) on every case of
    ``hevc_tpu_torch.resid_cases``, bit for bit, and on the range-extension
    streams of tests/torch_streams.py decoded with that code in the frame
    program (every SEI MD5 correct, every plane equal to the inline
    decoder's);
(b) that the cases reach every path: DST and DCT, skip and bypass, both
    signs of the dequantisation's shift, every clip, the negative
    transform-skip shift, rotation, RDPCM both ways, CCP from slot 0 and
    from a record, empty classes;
(c) the wrapper on CPU tensors (the plain path, no launch counted), its
    refusals, the launch parameters, the kernel's constant tables against
    ``tables.py`` and ``bounds.residual_work`` against a recount.
The same code against the JAX package's ``_residuals`` is in
tests/test_torch_resid_jax.py, the card's run in tests/test_torch_cuda.py.
"""
import re

import numpy as np
import pytest
import torch

from hevc_tpu_torch import (build, pipeline, recon, resid_cases, resid_cuda,
                            trace, transforms)
from hevc_tpu_torch.bounds import residual_work
from hevc_tpu_torch.tables import tables_from_reference
from resid_host import SRC, build_host_lib, host_residuals

CPU = torch.device("cpu")
CASES = sorted(resid_cases.CASES)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The kernel's code on host memory, as ``resid_cuda.residuals``."""
    return host_residuals(build_host_lib(tmp_path_factory.mktemp("resid")))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", CASES)
def test_kernel_code_matches_plain(host, name, seed):
    args = resid_cases.tensors(resid_cases.make(name, seed), CPU)
    got = host(*args)
    want = resid_cuda.residuals_plain(*args)
    assert len(got) == len(want) == 4
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.int32
        assert torch.equal(g, w), \
            f"{name} class {c}: {int((g != w).sum())} samples differ"
        assert not g[0].any(), "slot 0 is zeros"


# ---------------------------------------------------------------------------
# (b) the paths the cases reach
# ---------------------------------------------------------------------------

def _paths(case):
    """The set of paths one case reaches, found with the plain version's
    own steps (``transforms``) on its live, transformed records."""
    bd = case["bd"]
    tables = tables_from_reference(CPU)
    seen = set()
    for c, (lv, m, bank) in enumerate(zip(case["levels"], case["rmeta"],
                                          case["bank"])):
        s, log2 = 4 << c, c + 2
        live = np.arange(m.shape[0]) < case["live"][c]
        if not live.any():
            seen.add("empty class")
            continue
        if ((lv == -32768) | (lv == 32767)).any():
            seen.add("int16 limits")
        seen |= {k for k, on in (
            ("dst", (m[live, 1] != 0).any() and s == 4),
            ("transform skip", (m[live, 2] != 0).any()),
            ("bypass", (m[live, 3] != 0).any()),
            ("matrix", (m[live, 4] > 0).any()),
            ("rotation", (m[live, 5] != 0).any()),
            ("rdpcm horizontal", (m[live, 6] == 1).any()),
            ("rdpcm vertical", (m[live, 6] == 2).any()),
            ("ccp from a record", ((m[:, 7] != 0) & (m[:, 8] > 0)).any()),
            ("ccp from slot 0", ((m[:, 7] != 0) & (m[:, 8] == 0)).any()),
            ("negative skip shift", (m[live, 2] != 0).any()
             and 15 - bd - log2 < 0)) if on}
        qp = torch.from_numpy(m[:, 0])
        sh2 = bd + log2 - 5 - torch.div(qp, 6, rounding_mode="floor")
        if (sh2[torch.from_numpy(live)] <= 0).any():
            seen.add("shift <= 0")
        lv32 = torch.from_numpy(lv.astype(np.int32))
        sm = torch.from_numpy(bank)[torch.from_numpy(m[:, 4]).long()]
        ls = tables["level_scale"][torch.remainder(qp, 6).long()]
        num = lv32.long() * (ls[:, None, None] * sm).long()
        big = torch.where(sh2[:, None, None] > 0,
                          num >> sh2.clamp(min=0)[:, None, None],
                          num << (-sh2).clamp(min=0)[:, None, None])
        if (big.abs() > 32768).any():
            seen.add("dequant clip")
        d = transforms.dequant_batch(lv32, qp, log2, bd, tables, sm)
        tx = torch.from_numpy(live & (m[:, 2] == 0) & (m[:, 3] == 0))
        T = tables[f"dct{s}"].double()
        e = (T.t() @ d.double()).long()
        e1 = (e + 64) >> 7
        if (e1.abs() > 32768)[tx].any():
            seen.add("first pass clip")
        r = (e1.clamp(-32768, 32767).double() @ T).long()
        if (((r + (1 << (19 - bd))) >> (20 - bd)).abs() > 32768)[tx].any():
            seen.add("second pass clip")
    return seen


PATHS = ("dst", "transform skip", "bypass", "matrix", "rotation",
         "rdpcm horizontal", "rdpcm vertical", "ccp from a record",
         "ccp from slot 0", "negative skip shift", "shift <= 0",
         "int16 limits", "dequant clip", "first pass clip",
         "second pass clip", "empty class")


@pytest.fixture(scope="module")
def reached():
    return set().union(*(_paths(resid_cases.make(n, s))
                         for n in CASES for s in (0, 1)))


@pytest.mark.parametrize("path", PATHS)
def test_the_cases_reach_every_path(reached, path):
    assert path in reached


def test_the_cases_span_bit_depths_8_to_16():
    assert {resid_cases.CASES[n][0] for n in CASES} >= {8, 10, 12, 16}


# ---------------------------------------------------------------------------
# (a) real streams: the range-extension tools through the frame program
# ---------------------------------------------------------------------------

# stream -> the columns its pictures set (ts, rdpcm; ccp alpha and slot):
# the port's encoder chooses no 4x4 skip, so no rotation, in these streams
REXT = {"rext_explicit_rdpcm": (2, 6), "rext_explicit_rdpcm_tools": (2, 6),
        "rext_ccp": (7, 8), "rext_ccp_tools": (7, 8)}


@pytest.mark.parametrize("name", sorted(REXT))
def test_kernel_code_decodes_the_rext_streams(host, monkeypatch, name):
    """The stream through ``TorchDecoder`` on the CPU with the kernel's
    code in place of the plain residual stage: every MD5 correct, every
    plane the inline decoder's, and the tools' columns set."""
    from hevc_tpu_torch import native
    if not native.available():
        pytest.skip("native toolchain unavailable")
    from torch_streams import FORMATS, assert_same, decode_inline, \
        decode_port
    cols = np.zeros(9, bool)

    def kernel_code(levels, rmeta, bd, bank, tables):
        for m in rmeta:
            cols[:] |= (m != 0).any(0).numpy()
        return host(levels, rmeta, bd, bank, tables)

    monkeypatch.setattr(pipeline, "residuals", kernel_code)
    data = FORMATS[name]()
    got, n_prog = decode_port(data, CPU)
    assert_same(decode_inline(data), got, name)
    assert n_prog == len(got)
    assert all(cols[k] for k in REXT[name]), (name, cols)


# ---------------------------------------------------------------------------
# (c) the wrapper, the launch parameters, the constants, the bound
# ---------------------------------------------------------------------------

def test_wrapper_on_the_cpu_is_the_plain_version():
    case = resid_cases.make("rext_10bit", 3)
    levels, rmeta, bd, bank, tables = resid_cases.tensors(case, CPU)
    build.reset_launches()
    trace.reset()
    got = resid_cuda.residuals(levels, rmeta, bd, bank, tables)
    want = recon.residuals([lv.to(torch.int32) for lv in levels], rmeta,
                           bd, bank, tables)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert build.launches["resid_tx"] == 0
    assert "residual_launches" not in trace.report()
    # int32 levels are taken on the CPU too
    again = resid_cuda.residuals([lv.to(torch.int32) for lv in levels],
                                 rmeta, bd, bank, tables)
    assert all(torch.equal(g, w) for g, w in zip(again, want))


def test_frame_program_binds_the_wrapper():
    from hevc_tpu_torch import sharded
    assert pipeline.residuals is resid_cuda.residuals
    assert sharded.residuals is resid_cuda.residuals


def _refusal(kind, levels, rmeta, bank):
    if kind == "int32 levels":
        levels[1] = levels[1].to(torch.int32)
    elif kind == "five columns":
        rmeta[2] = rmeta[2][:, :5].contiguous()
    elif kind == "bank of six":
        bank[0] = bank[0][:6]
    elif kind == "levels and rows disagree":
        levels[3] = levels[3][:-1]
    elif kind == "three classes":
        levels.pop()
    elif kind == "strided rows":
        rmeta[0] = rmeta[0].t().contiguous().t()
    return levels, rmeta, bank


@pytest.mark.parametrize("kind", ["int32 levels", "five columns",
                                  "bank of six", "levels and rows disagree",
                                  "three classes", "strided rows",
                                  "bit depth 7"])
def test_the_launch_parameters_refuse_what_the_kernel_cannot_read(kind):
    levels, rmeta, bd, bank, _t = resid_cases.tensors(
        resid_cases.make("main_8bit", 0), CPU)
    levels, rmeta, bank = _refusal(kind, levels, rmeta, bank)
    with pytest.raises(ValueError):
        resid_cuda.resid_params(levels, rmeta, 7 if kind == "bit depth 7"
                                else bd, bank)


def test_the_launch_parameters():
    levels, rmeta, bd, bank, _t = resid_cases.tensors(
        resid_cases.make("empty_classes", 0), CPU)
    p, pools = resid_cuda.resid_params(levels, rmeta, bd, bank)
    units = 0
    for c, s in enumerate(resid_cuda.SIZES):
        n = rmeta[c].shape[0]
        q = p.cls[c]
        assert (q.n, q.unit0) == (n, units)
        assert pools[c].shape == (n + 1, s, s) and pools[c].is_contiguous()
        assert q.out == pools[c].data_ptr()
        units += -(-(n + 1) // (32 // s))
    assert p.units == units and p.bd == bd
    # one buffer, the classes back to back
    assert pools[1].data_ptr() == pools[0].data_ptr() + 4 * pools[0].numel()


def _table(name):
    body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", open(SRC).read(),
                     re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)])


def test_kernel_constants_match_tables():
    t = {k: v.numpy() for k, v in tables_from_reference(CPU).items()}
    assert np.array_equal(_table("c_dct"), t["dct32"].reshape(-1))
    assert np.array_equal(_table("c_dst4"), t["dst4"].reshape(-1))
    assert np.array_equal(_table("c_level_scale"), t["level_scale"])
    for n in (4, 8, 16):  # the n-point DCT inside the 32-point one
        assert np.array_equal(t[f"dct{n}"], t["dct32"][::32 // n, :n])


def test_residual_work_against_a_recount():
    case = resid_cases.make("rext_10bit", 0)
    n_bytes, ops = residual_work(case["rmeta"])
    want_b, want_ops = 0, 0
    for c, (lv, m) in enumerate(zip(case["levels"], case["rmeta"])):
        s = 4 << c
        want_b += lv.nbytes + m.nbytes + 4 * (m.shape[0] + 1) * s * s
        for row in m:
            want_ops += 4 * s * s
            if row[2] == 0 and row[3] == 0:
                want_ops += s * s * (4 * s + 4)
    assert (n_bytes, ops) == (want_b, want_ops)
