"""The port's plain MC and residual add (hevc_tpu_torch/mc.py) against the
JAX package: the XLA phases (tpu/mc.py, pipeline._mc_tile_phase) and the
Pallas kernels in interpret mode (tpu/mc_pallas.py), bit for bit, on the
parametrisation of tests/test_mc_pallas.py; and the host side of the two
kernels' launches (mc_cuda.mc_table, the tap tables of csrc/mc.cu).  The
CUDA kernels are held against the plain versions by
tests/test_torch_cuda.py, which needs a card.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hevc_tpu.tpu import mc_pallas as MP
from hevc_tpu.tpu.mc import mc_phase, resid_phase
from hevc_tpu.tpu.pipeline import DUMP16, _mc_tile_phase
from hevc_tpu_torch import build, mc_cuda
from hevc_tpu_torch.tables import tables_from_reference
from test_torch_cuda import (CH, CW, MC_CASES, _legacy_fields, _mixed_mc,
                             _mixed_resid, _port_mc, _port_resid, _prod_rows,
                             _refs, _resid_case)


@pytest.mark.parametrize("is_ch,bi,w,h,bd,wp", MC_CASES)
def test_mc_plain_matches_xla_and_pallas(is_ch, bi, w, h, bd, wp):
    rng = np.random.default_rng(hash((is_ch, bi, w, h, bd, wp)) % 2**32)
    ntaps = 4 if is_ch else 8
    refs = _refs(rng, bd)
    rows = _prod_rows(rng, 3, bi, w, h, ntaps, wp, bd)
    canvas = rng.integers(0, 1 << bd, (CH, CW)).astype(np.int32)
    got = _port_mc(canvas, refs, [(is_ch, bi, wp, 3, w, h, rows)], bd)

    fields = _legacy_fields(rows, bi, wp)
    want = np.asarray(mc_phase(jnp.asarray(canvas), jnp.asarray(refs),
                               jnp.asarray(refs),
                               ((is_ch, bi, w, h, wp, jnp.asarray(fields)),),
                               bd))
    assert np.array_equal(got, want)
    pg = MP.prepare_mc_fields(((is_ch, bi, wp, w, h, fields),))
    pr = MP.pad_refs(jnp.asarray(refs))
    pal = MP.mc_phase_pallas(MP.pad_canvas(jnp.asarray(canvas)), pr, pr, pg,
                             bd, interpret=True)
    assert np.array_equal(got, np.asarray(pal[:CH, :CW]))


@pytest.mark.parametrize("kind", [0, 1, 2, 3])
@pytest.mark.parametrize("is_ch", [False, True])
def test_mc_plain_kind3_matches_specialised_kinds(kind, is_ch):
    """Every row as kind 3 equals pipeline._mc_tile_phase's specialised
    full-pel / horizontal / vertical kinds, padding rows included."""
    bd, w, h = 8, 8, 8
    ntaps = 4 if is_ch else 8
    rng = np.random.default_rng(kind * 2 + is_ch)
    fx, fy = {0: (0, 0), 1: (1, 0), 2: (0, 3), 3: (2, 1)}[kind]
    bi = kind in (0, 3)
    rows = _prod_rows(rng, 6, bi, w, h, ntaps, False, bd, fracs=(fx, fy))
    pad = np.zeros((3, 17), np.int32)
    pad[:, 10] = pad[:, 11] = DUMP16
    rows = np.concatenate([rows, pad])
    refs = _refs(rng, bd)
    canvas = rng.integers(0, 1 << bd, (CH, CW)).astype(np.int32)
    got = _port_mc(canvas, refs, [(is_ch, bi, False, kind, w, h, rows)], bd)
    want = _mc_tile_phase(jnp.asarray(canvas), jnp.asarray(refs),
                          jnp.asarray(refs),
                          ((is_ch, bi, False, kind, w, h,
                            jnp.asarray(rows)),), bd)
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("cls,bd", [(0, 8), (1, 8), (2, 10), (3, 8)])
def test_resid_plain_matches_xla_and_pallas(cls, bd):
    canvas, fields, pools = _resid_case(cls, bd)
    got = _port_resid(canvas, fields, pools, bd)
    jpools = tuple(jnp.asarray(p) for p in pools)
    want = resid_phase(jnp.asarray(canvas),
                       tuple(jnp.asarray(f) for f in fields), jpools, bd)
    assert np.array_equal(got, np.asarray(want))
    fts = MP.prepare_resid_fields(tuple(fields))
    pal = MP.resid_phase_pallas(MP.pad_canvas(jnp.asarray(canvas)), fts,
                                jpools, bd, interpret=True)
    assert np.array_equal(got, np.asarray(pal[:160, :220]))


@pytest.mark.parametrize("cls", [0, 1, 2, 3])
def test_resid_plain_padding_rows_write_nothing(cls):
    canvas, fields, pools = _resid_case(cls, 8, n_pad=3)
    got = _port_resid(canvas, fields, pools, 8)
    want = resid_phase(jnp.asarray(canvas),
                       tuple(jnp.asarray(f) for f in fields),
                       tuple(jnp.asarray(p) for p in pools), 8)
    assert np.array_equal(got, np.asarray(want))
    real = _port_resid(canvas, [f[:6] for f in fields], pools, 8)
    assert np.array_equal(got, real)


def test_wrappers_take_the_plain_path_on_cpu():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    build.reset_launches()
    canvas, fields, pools = _resid_case(1, 8)
    t = torch.from_numpy
    got = mc_cuda.resid_add(t(canvas).clone(), [t(f) for f in fields],
                            [t(p) for p in pools], 8).numpy()
    assert np.array_equal(got, _port_resid(canvas, fields, pools, 8))
    assert (build.launches["mc"], build.launches["resid_add"]) == (0, 0)


def test_mc_table_merges_kinds_orders_classes_and_drops_padding():
    """Every real row of the groups appears in the table exactly once,
    under its block class; padding rows drop out; the classes ascend; and
    the plain version on the table equals ``_mc_tile_phase`` on the
    groups as the JAX pack hands them (kinds apart, padding in)."""
    canvas, refs, groups, bd = _mixed_mc(np.random.default_rng(4))
    table = mc_cuda.mc_table(groups, canvas.shape)
    keys = [g[:5] for g in table.groups]
    assert keys == sorted(set(keys))
    assert [g[5] for g in table.groups] == list(
        np.cumsum([0] + [g[6] for g in table.groups])[:-1])
    want_rows = {}
    for is_ch, bi, wp, _kind, w, h, rows in groups:
        real = rows[rows[:, 10] != DUMP16]
        want_rows.setdefault((int(is_ch), int(bi), int(wp), w, h),
                             []).extend(map(tuple, real.tolist()))
    got_rows = {g[:5]: list(map(tuple, table.rows[g[5]:g[5] + g[6]]
                                .tolist())) for g in table.groups}
    assert got_rows.keys() == want_rows.keys()
    for k in got_rows:
        assert sorted(got_rows[k]) == sorted(want_rows[k]), k
    assert table.rows.shape[0] == sum(len(v) for v in want_rows.values())
    plain = mc_cuda.mc(torch.from_numpy(canvas).clone(),
                       torch.from_numpy(refs), torch.from_numpy(refs),
                       groups, bd).numpy()
    want = _mc_tile_phase(jnp.asarray(canvas), jnp.asarray(refs),
                          jnp.asarray(refs),
                          tuple(g[:6] + (jnp.asarray(g[6]),)
                                for g in groups), bd)
    assert np.array_equal(plain, np.asarray(want))


@pytest.mark.parametrize("w,h", [(64, 64), (3, 8), (10, 4), (4, 65)])
def test_mc_table_refuses_what_is_no_pu_size(w, h):
    rows = np.zeros((1, 17), np.int32)
    if w == 64:
        mc_cuda.mc_table([(True, False, False, 3, w, h, rows)], (90, 90))
        return
    with pytest.raises(ValueError, match="PU size"):
        mc_cuda.mc_table([(True, False, False, 3, w, h, rows)], (90, 90))


def test_mc_table_is_int16_and_refuses_a_row_that_does_not_fit():
    rows = np.zeros((2, 17), np.int32)
    rows[:, 10:12] = 8
    rows[1, 12] = 1 << 15
    table = mc_cuda.mc_table([(False, False, True, 3, 8, 8, rows[:1])],
                             (90, 90))
    assert table.rows.dtype == np.int16 and table.rows.shape == (1, 17)
    with pytest.raises(ValueError, match="int16"):
        mc_cuda.mc_table([(False, False, True, 3, 8, 8, rows)], (90, 90))


def test_mc_kernel_taps_are_the_ops_tables():
    """``c_qpel`` and ``c_epel`` of csrc/mc.cu hold the rows of
    ``tables.tables_from_reference`` (built from ops/mc.py)."""
    src = open(os.path.join(os.path.dirname(build.__file__), "csrc",
                            "mc.cu")).read()
    tabs = tables_from_reference(torch.device("cpu"))
    for name, key in (("c_qpel", "qpel"), ("c_epel", "epel")):
        body = re.search(name + r"\[\d+\]\[\d+\] = \{(.*?)\};", src,
                         re.S).group(1)
        vals = [int(v) for v in re.findall(r"-?\d+", body)]
        assert vals == tabs[key].reshape(-1).tolist(), name


@pytest.mark.parametrize("bd", [8, 10])
def test_resid_plain_all_classes_in_one_call_matches_xla(bd):
    """The four classes of one picture in one call, with padding rows and
    a TU that straddles the canvas edge (read from its clamped origin, as
    ``resid_phase`` reads it), against ``resid_phase``."""
    canvas, fields, pools = _mixed_resid(bd)
    got = _port_resid(canvas, fields, pools, bd)
    want = resid_phase(jnp.asarray(canvas),
                       tuple(jnp.asarray(f) for f in fields),
                       tuple(jnp.asarray(p) for p in pools), bd)
    assert np.array_equal(got, np.asarray(want))
    # the straddling TU changed pixels, the padding rows none
    assert not np.array_equal(got[-3:], canvas[-3:])
