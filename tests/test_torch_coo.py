"""The sparse (COO) level upload against the JAX package, bit for bit
(tolerance 0), on the CPU.

A level pool of at least 65,536 coefficients with fewer than a third of
them nonzero ships as (int32 index, int16 value) pairs, padded to a power
of two with the index ``total`` (hevc_tpu/tpu/pipeline.py:876-890); the
frame program scatters them back into the dense pool and drops the padding.
The stream: a smooth 256x192 IPP picture pair whose pools both ship so.

- ``pack.pack_frame`` against ``pack_frame_pipeline`` of the JAX package
  on the same pictures, field for field (two native libraries in one
  process);
- ``pipeline.frame_program`` on the JAX pack against the JAX
  ``_pipeline_frame`` and against the same picture's dense pool;
- ``pipeline.scatter_levels`` drops a padding pair whatever its value;
- ``TorchDecoder(device="cpu")`` on the stream, every MD5 correct, every
  plane the JAX package's.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from hevc_tpu.tpu import pipeline as JP
from hevc_tpu_torch import native as TN
from hevc_tpu_torch import pipeline as PP
from hevc_tpu_torch.decoder import TorchDecoder
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.pack import (COO_MIN, _level_rows, coo_pairs, pack_frame,
                                 sparse_levels)
from torch_gate import native_ready

pytestmark = pytest.mark.skipif(not native_ready(native),
                                reason="native toolchain unavailable")
CPU = torch.device("cpu")
W, H = 256, 192


@lru_cache(maxsize=None)
def stream():
    cfg = EncoderConfig(width=W, height=H, qp=30, gop="ipp", deblocking=True,
                        sao=True, log2_ctb_size=5, log2_cu_size=5,
                        search_range=2, seed=1)
    enc = IntraEncoder(cfg)
    return b"".join(enc.encode_frame(synth_frame("gradient", W, H, t,
                                                 seed=3)) for t in range(2))


def _coo(spec):
    return dict(spec)["coo"]


@lru_cache(maxsize=None)
def jax_calls():
    """The inputs and outputs of every JAX ``_pipeline_frame`` call of the
    stream, NumPy, decode order."""
    calls = []
    orig = JP._pipeline_frame

    def record(*args):
        out = orig(*args)
        (meta, meta16, meta8, avail, levels, bank, canvas0, ry, rcb, rcr,
         spec) = args
        lv = tuple(np.array(a) for a in levels) if _coo(spec)[0] \
            else np.array(levels)
        calls.append(dict(
            bufs=[np.array(a) for a in (meta, meta16, meta8, avail)] + [lv],
            bank=[np.array(b) for b in bank], canvas0=np.array(canvas0),
            refs=[[torch.from_numpy(np.array(r)) for r in rs]
                  for rs in (ry, rcb, rcr)],
            spec=spec, out=[np.array(o) for o in out]))
        return out

    JP._pipeline_frame = record
    try:
        frames = Decoder(check_md5=True,
                         recon_backend="jax").decode_bytes(stream())
    finally:
        JP._pipeline_frame = orig
    assert [f.md5_ok for f in frames] == [True, True]
    return calls


def _run(call, levels, spec):
    out = PP.frame_program(*call["bufs"][:4], levels, call["bank"],
                           call["canvas0"], *call["refs"], spec, CPU)
    return [o.numpy() for o in out]


def _dense(levels, total):
    """The dense pool of (idx, val) pairs, rebuilt on the host."""
    idx, val = levels
    pool = np.zeros(total, np.int16)
    keep = idx < total
    np.put(pool, idx[keep], val[keep])
    return pool


def test_both_pictures_ship_sparse():
    calls = jax_calls()
    assert len(calls) == 2 and dict(calls[1]["spec"])["n_refs"]
    for call in calls:
        coo_n, total = _coo(call["spec"])
        assert coo_n > 0 and total >= COO_MIN
        idx, val = call["bufs"][4]
        assert idx.dtype == np.int32 and val.dtype == np.int16
        assert idx.size == val.size == coo_n and coo_n & (coo_n - 1) == 0
        assert (idx[val != 0] < total).all() and (idx < total).sum() * 3 \
            < total


def test_port_pack_is_the_jax_pack_field_by_field():
    """``pack_frame`` of the port and ``pack_frame_pipeline`` of the JAX
    package on the port's pictures: the same (idx, val) pairs and ``coo``.
    The I picture's buffers and spec are the same field for field; the P
    picture's too, but for what the port packs without padding on purpose
    (no padded inter residual rows in ``meta``, MC rows of one kind in
    ``meta16``: the spec's ``resid_rows`` and ``mc_groups``)."""
    packs = []
    orig = PP.finish_frame

    def finish(pic, lay, poc, device):
        packs.append((pack_frame(pic), JP.pack_frame_pipeline(pic)))
        return orig(pic, lay, poc, device)

    PP.finish_frame = finish
    try:
        frames = TorchDecoder(check_md5=True,
                              device="cpu").decode_bytes(stream())
    finally:
        PP.finish_frame = orig
    assert [f.md5_ok for f in frames] == [True, True]
    assert len(packs) == 2
    unpadded = {"resid_rows", "mc_groups"}
    for k, (got, want) in enumerate(packs):
        assert _coo(got[6])[0] > 0, f"picture {k} is not sparse"
        skip = unpadded if k else set()
        assert [kv for kv in got[6] if kv[0] not in skip] == \
            [kv for kv in want[6] if kv[0] not in skip], f"picture {k}: spec"
        names = ("meta8", "avail_u8") if k else ("meta", "meta16", "meta8",
                                                 "avail_u8")
        for name in names:
            i = ("meta", "meta16", "meta8", "avail_u8").index(name)
            assert got[i].dtype == want[i].dtype \
                and np.array_equal(got[i], want[i]), f"picture {k}: {name}"
        for g, w in zip(got[4], want[4]):
            assert g.dtype == w.dtype and np.array_equal(g, w), \
                f"picture {k}: levels16 pairs"
        # no PCM: the port passes the canvas shape, the JAX pack a zero
        # canvas
        assert got[5] == np.shape(want[5]) and not np.asarray(want[5]).any()


@pytest.mark.parametrize("k", [0, 1], ids=["I", "P"])
def test_frame_program_on_the_jax_coo_pack(k):
    """The port's frame program on the JAX COO pack == the JAX
    ``_pipeline_frame`` on it, and == the port's frame program on the same
    pool uploaded dense (spec ``coo`` (0, total))."""
    call = jax_calls()[k]
    got = _run(call, call["bufs"][4], call["spec"])
    assert len(got) == len(call["out"])
    for p, (g, w) in enumerate(zip(got, call["out"])):
        assert g.shape == w.shape and np.array_equal(g, w), \
            f"output {p} != JAX"
    _n, total = _coo(call["spec"])
    spec = tuple((key, (0, total) if key == "coo" else v)
                 for key, v in call["spec"])
    dense = _run(call, _dense(call["bufs"][4], total), spec)
    for p, (g, d) in enumerate(zip(got, dense)):
        assert np.array_equal(g, d), f"output {p}: COO != dense"


def test_scatter_drops_the_padding_pairs():
    """Padding pairs carry the index ``total``; torch drops no
    out-of-range index, so the scatter must: a padding pair with a nonzero
    value leaves the pool as the real pairs make it."""
    rng = np.random.default_rng(5)
    total = 1000
    idx = np.sort(rng.choice(total - 1, 37, replace=False)).astype(np.int32)
    idx[-1] = total - 1                     # the last real entry
    val = rng.integers(-300, 300, 37).astype(np.int16)
    val[val == 0] = 1
    pad_i = np.full(27, total, np.int32)
    pad_v = np.full(27, 77, np.int16)
    got = PP.scatter_levels(torch.from_numpy(np.concatenate([idx, pad_i])),
                            torch.from_numpy(np.concatenate([val, pad_v])),
                            total)
    want = np.zeros(total, np.int16)
    want[idx] = val
    assert got.shape == (total,) and got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)


def test_coo_pairs_threshold():
    """Below 65,536 coefficients, or with a third or more nonzero, the pool
    goes dense; else the pairs are the nonzeros in order, padded to a power
    of two with the index ``total``."""
    small = np.zeros(COO_MIN - 1, np.int16)
    small[::7] = 3
    assert coo_pairs(small) is None
    dense = np.zeros(3 * 30000, np.int16)
    dense[:30000] = 2                       # exactly a third
    assert coo_pairs(dense) is None
    dense[0] = 0
    idx, val = coo_pairs(dense)
    assert idx.size == val.size == 32768
    assert np.array_equal(idx[:29999], np.arange(1, 30000))
    assert (idx[29999:] == dense.size).all() and (val[29999:] == 0).all()
    assert (val[:29999] == 2).all()


def _level_case(seed, overlap=False):
    """A native level buffer and its level rows (class, offset, 9 fields):
    rows of every class in shuffled order and at shuffled offsets, some
    CCP-only (offset -1), coefficients outside every row (PCM samples), a
    few nonzeros a row; ``overlap`` makes two rows share coefficients."""
    rng = np.random.default_rng(seed)
    cls = rng.choice(4, 900, p=[0.3, 0.3, 0.25, 0.15]).astype(np.int32)
    size = (4 << cls) ** 2
    gap = rng.integers(0, 40, cls.size)
    order = rng.permutation(cls.size)
    off = np.empty(cls.size, np.int64)
    pos = 0
    for t in order:
        pos += int(gap[t])
        off[t] = pos
        pos += int(size[t])
    lvl = np.zeros(pos + 64, np.int16)
    lvl[rng.choice(lvl.size, lvl.size // 50, replace=False)] = \
        rng.integers(-200, 200, lvl.size // 50)
    off[rng.choice(cls.size, 40, replace=False)] = -1
    if overlap:
        t = int(np.flatnonzero(off >= 0)[0])
        u = int(np.flatnonzero((off >= 0) & (np.arange(cls.size) != t))[0])
        off[u] = off[t] + 1
    lm = np.zeros((cls.size, 11), np.int32)
    lm[:, 0], lm[:, 1] = cls, off
    lm[:, 2:] = rng.integers(-9, 9, (cls.size, 9))
    nlv = [-(-(int((cls == c).sum()) + 1) // 16) * 16 for c in range(4)]
    return lvl, lm, nlv


def _gathered(lvl, lm, nlv):
    """The dense pool and rows of the native gather (the pack's dense
    path)."""
    rms = [np.zeros((nlv[c], 9), np.int32) for c in range(4)]
    pools = [np.zeros(nlv[c] * (4 << c) ** 2, np.int16) for c in range(4)]
    TN._gather_levels_fn()(lvl, np.ascontiguousarray(lm).reshape(-1),
                           lm.shape[0], *(r.reshape(-1) for r in rms),
                           *pools)
    return np.concatenate(pools), rms


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_sparse_levels_are_the_pairs_of_the_gathered_pool(seed):
    """``sparse_levels`` finds the (idx, val) pairs of the pool that the
    native gather fills without building it: the same pairs as
    ``coo_pairs`` of that pool, and ``_level_rows`` its rows."""
    lvl, lm, nlv = _level_case(seed)
    pool, rms = _gathered(lvl, lm, nlv)
    want = coo_pairs(pool)
    assert want is not None
    got, total = sparse_levels(lvl, lm, nlv)
    assert total == pool.size
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    for g, w in zip(_level_rows(lm, nlv), rms):
        assert np.array_equal(g, w)


def test_sparse_levels_leave_dense_and_shared_rows_to_the_pool():
    """No pairs where two rows read the same coefficients, nor where the
    level buffer holds a sixteenth of the pool's size or more in nonzeros,
    whether the pool then ships dense or sparse: the pack builds the pool
    and ``coo_pairs`` decides."""
    lvl, lm, nlv = _level_case(4, overlap=True)
    assert sparse_levels(lvl, lm, nlv) is None
    lvl, lm, nlv = _level_case(5)
    lvl[::8] = 5                            # an eighth nonzero: sparse
    assert coo_pairs(_gathered(lvl, lm, nlv)[0]) is not None
    assert sparse_levels(lvl, lm, nlv) is None
    lvl[:] = 7
    assert coo_pairs(_gathered(lvl, lm, nlv)[0]) is None
    assert sparse_levels(lvl, lm, nlv) is None


def test_torch_decoder_decodes_the_sparse_stream():
    """``TorchDecoder(device="cpu")``: both pictures through the COO
    upload, every MD5 correct, every plane == the JAX package's decode."""
    coo = []
    orig = PP.pack_frame

    def pack(pic):
        out = orig(pic)
        coo.append(_coo(out[6])[0])
        return out

    PP.pack_frame = pack
    try:
        got = TorchDecoder(check_md5=True, device="cpu").decode_bytes(
            stream())
    finally:
        PP.pack_frame = orig
    assert len(coo) == 2 and all(coo), coo
    want = Decoder(check_md5=True, recon_backend="jax").decode_bytes(
        stream())
    assert [f.md5_ok for f in got] == [True, True]
    for g, w in zip(got, want):
        assert g.poc == w.poc
        for p in range(3):
            assert np.array_equal(np.asarray(g.planes[p]),
                                  np.asarray(w.planes[p])), (g.poc, p)
