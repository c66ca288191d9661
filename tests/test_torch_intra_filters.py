"""The port's intra wavefront, deblocking and SAO against the JAX package,
stage by stage, on the inputs the JAX pack produced for small streams
(tests/test_torch_pipeline.py records them).  Bit-exact."""
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hevc_tpu import native
from hevc_tpu.tpu.filters import deblock_jax, sao_plane_jax
from hevc_tpu.tpu.intra import reconstruct_wavefront as jax_wavefront
from hevc_tpu.tpu.mc import resid_phase
from hevc_tpu.tpu.pipeline import _mc_tile_phase
from hevc_tpu.tpu.recon import _residuals
from hevc_tpu_torch.filters import deblock, sao_plane
from hevc_tpu_torch.intra import reconstruct_wavefront
from hevc_tpu_torch.tables import tables_from_reference
from test_torch_pipeline import decoded
from torch_gate import native_ready

pytestmark = pytest.mark.skipif(not native_ready(native),
                                reason="native toolchain unavailable")
TABLES = tables_from_reference(torch.device("cpu"))
CASES = [("ipp_wpp", k) for k in range(3)]  # the I frame and two P frames


def _unpack(rec):
    """A JAX-pack record -> NumPy stage inputs, in _pipeline_frame order."""
    S = dict(rec["spec"])
    meta, meta16, meta8, avail_u8, levels16 = rec["bufs"]
    nc, h4, w4 = S["n_chunks"], S["h4"], S["w4"]
    cth, ctw = S["ctb_h"], S["ctb_w"]
    pos = 0

    def take(n, shape):
        nonlocal pos
        pos += n
        return meta[pos - n:pos].reshape(shape)

    d = dict(S=S)
    d["scal"] = [take(nc * b * 8, (nc, b, 8)) for b in S["B"]]
    d["rmeta"] = [take(n * 9, (n, 9)) for n in S["nlv"]]
    groups, p16 = [], 0
    for (is_ch, bi, wp, kind, w, h, nrow) in S["mc_groups"]:
        rows = meta16[p16:p16 + nrow * 17].reshape(nrow, 17).astype(np.int32)
        p16 += nrow * 17
        groups.append((is_ch, bi, wp, kind, w, h, rows))
    d["mc"] = groups
    d["resid"] = [take(n * 3, (n, 3)) for n in S["resid_rows"]]
    d["sao"] = [take(3 * cth * ctw, (3, cth, ctw)) for _ in range(3)] \
        + [take(3 * cth * ctw * 4, (3, cth, ctw, 4))]
    d["qp_bs"] = [meta8[k * h4 * w4:(k + 1) * h4 * w4].reshape(h4, w4)
                  .astype(np.int32) for k in range(3)]
    d["dboff"] = take(4, (4,))
    apos, d["avail"] = 0, []
    for b in S["B"]:
        n = nc * b * 128
        d["avail"].append(avail_u8[apos:apos + n].reshape(nc, b, 128) != 0)
        apos += n
    lpos, d["levels"] = 0, []
    for c, s in enumerate((4, 8, 16, 32)):
        n = S["nlv"][c] * s * s
        d["levels"].append(levels16[lpos:lpos + n]
                           .reshape(S["nlv"][c], s, s).astype(np.int32))
        lpos += n
    return d


@lru_cache(maxsize=None)
def _jax_stages(name, k):
    """Canvas after the inter phases, then after intra (JAX), plus the
    residual pools, of frame k of a recorded config."""
    rec = decoded(name)[3][k]
    d = _unpack(rec)
    S = d["S"]
    bd = S["bd"]
    resids = _residuals(tuple(jnp.asarray(v) for v in d["levels"]),
                        tuple(jnp.asarray(v) for v in d["rmeta"]), bd,
                        tuple(jnp.asarray(b) for b in rec["bank"]))
    canvas = jnp.asarray(rec["canvas0"]).astype(jnp.int32)
    if S["n_refs"]:
        ry, rcb, rcr = rec["refs"]
        canvas = _mc_tile_phase(
            canvas, jnp.asarray(np.stack(ry)), jnp.asarray(np.stack(rcb + rcr)),
            tuple(g[:6] + (jnp.asarray(g[6]),) for g in d["mc"]), bd)
    canvas = resid_phase(canvas, tuple(jnp.asarray(f) for f in d["resid"]),
                         resids, bd)
    out = jax_wavefront(canvas, tuple(jnp.asarray(s) for s in d["scal"]),
                        tuple(jnp.asarray(a) for a in d["avail"]), resids,
                        bd, S["n_chunks"])
    return d, np.asarray(canvas), resids, np.asarray(out)


def _planes(canvas, S):
    return [canvas[oy:oy + h, ox:ox + w] for oy, ox, h, w in S["regions"]]


@pytest.mark.parametrize("name,k", CASES)
def test_reconstruct_wavefront_matches_jax(name, k):
    d, canvas, resids, want = _jax_stages(name, k)
    t = torch.from_numpy
    got = reconstruct_wavefront(
        t(canvas.copy()), [t(s) for s in d["scal"]],
        [t(a) for a in d["avail"]], [t(np.array(r)) for r in resids],
        d["S"]["bd"], TABLES)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("name,k", CASES)
def test_deblock_and_sao_match_jax(name, k):
    d, _canvas, _resids, out = _jax_stages(name, k)
    S = d["S"]
    bd = S["bd"]
    assert S["do_deblock"] and S["do_sao"]
    planes = _planes(out, S)
    qp4, bs_v, bs_h = d["qp_bs"]
    db = d["dboff"]
    want = deblock_jax(*(jnp.asarray(p) for p in planes), jnp.asarray(qp4),
                       jnp.asarray(bs_v), jnp.asarray(bs_h), int(db[0]),
                       int(db[1]), int(db[2]), int(db[3]), bd=bd,
                       sub_w=S["sub_w"], sub_h=S["sub_h"])
    t = torch.from_numpy
    got = deblock(*(t(np.ascontiguousarray(p)) for p in planes), t(qp4),
                  t(bs_v), t(bs_h), int(db[0]), int(db[1]), int(db[2]),
                  int(db[3]), TABLES, bd=bd, sub_w=S["sub_w"],
                  sub_h=S["sub_h"])
    for p in range(3):
        assert np.array_equal(got[p].numpy(), np.asarray(want[p])), p
    sao_t, sao_b, sao_e, sao_o = d["sao"]
    for p in range(3):
        lg = S["ctb_log2"] - (0 if p == 0 else S["sub_w"].bit_length() - 1)
        w = sao_plane_jax(want[p], sao_t[p], sao_b[p], sao_o[p], sao_e[p],
                          lg, bd)
        g = sao_plane(got[p], t(sao_t[p]), t(sao_b[p]), t(sao_o[p]),
                      t(sao_e[p]), lg, bd)
        assert np.array_equal(g.numpy(), np.asarray(w)), p
