"""The port's plain MC and residual add (hevc_tpu_torch/mc.py) against the
JAX package: the XLA phases (tpu/mc.py, pipeline._mc_tile_phase) and the
Pallas kernels in interpret mode (tpu/mc_pallas.py), bit for bit, on the
parametrisation of tests/test_mc_pallas.py.  The CUDA kernels are held
against the plain versions by tests/test_torch_cuda.py, which needs a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hevc_tpu.tpu import mc_pallas as MP
from hevc_tpu.tpu.mc import mc_phase, resid_phase
from hevc_tpu.tpu.pipeline import DUMP16, _mc_tile_phase
from hevc_tpu_torch import build, mc_cuda
from test_torch_cuda import (CH, CW, MC_CASES, _legacy_fields, _port_mc,
                             _port_resid, _prod_rows, _refs, _resid_case)


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
