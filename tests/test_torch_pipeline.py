"""The port's frame program and decoder against the JAX package.

(a) The buffers of the JAX pack (pipeline.pack_frame_pipeline) and the
    references the JAX decoder held go through JAX ``_pipeline_frame``
    and through ``hevc_tpu_torch.pipeline.frame_program``: the fused
    outputs and the padded references must be equal.
(b) ``TorchDecoder(device="cpu")`` against ``Decoder(recon_backend="jax")``
    and ``"inline"``, frame by frame, with every SEI MD5 correct.
(c) The port's own host side against the JAX package's on the same
    streams: the native stage-A records of every picture, and
    ``native.pack_frame_native`` of both packages on the port's pictures
    (two native libraries loaded in one process).
All comparisons are bit-exact.
"""
from functools import lru_cache

import numpy as np
import pytest
import torch

from hevc_tpu import native
from hevc_tpu.decoder.core import Decoder
from hevc_tpu.tpu import pipeline as JP
from hevc_tpu_torch import native as port_native
from hevc_tpu_torch import pipeline as PP
from hevc_tpu_torch.decoder import TorchDecoder
from hevc_tpu_torch.pipeline import frame_program
from hevc_tpu_torch.tables import dpb_from_numpy
from torch_streams import CONFIGS, INLINE_ONLY, encode_config

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")
CPU = torch.device("cpu")

def _planes(frames):
    return [([np.asarray(p) for p in f.planes], f.md5_ok, f.poc)
            for f in frames]


def _records(pic):
    """A picture's native stage-A records, its chunks concatenated."""
    rec, lvl = native._concat_chunks(pic.native_chunks)
    return np.array(rec), np.array(lvl)


@lru_cache(maxsize=None)
def decoded(name):
    """(stream, inline frames, jax frames, frame-program records, native
    records) of one config; each frame-program record holds the NumPy
    inputs and outputs of one JAX ``_pipeline_frame`` call, each native
    record a picture's (rec, lvl) in decode order."""
    stream = encode_config(*CONFIGS[name])
    inline = _planes(Decoder(check_md5=True,
                             recon_backend="inline").decode_bytes(stream))
    records, stage_a = [], []
    orig = JP._pipeline_frame
    orig_finish = JP.finish_frame_pipeline

    def finish(pic, lay, poc):
        stage_a.append(_records(pic))
        return orig_finish(pic, lay, poc)

    def record(*args):
        out = orig(*args)
        (meta, meta16, meta8, avail, levels, bank, canvas0, ry, rcb, rcr,
         spec) = args
        records.append(dict(
            bufs=[np.array(a) for a in (meta, meta16, meta8, avail,
                                        levels)],
            bank=[np.array(b) for b in bank], canvas0=np.array(canvas0),
            refs=[[np.array(r) for r in rs] for rs in (ry, rcb, rcr)],
            spec=spec, out=[np.array(o) for o in out]))
        return out

    JP._pipeline_frame, JP.finish_frame_pipeline = record, finish
    try:
        jax_frames = _planes(Decoder(check_md5=True, recon_backend="jax")
                             .decode_bytes(stream))
    finally:
        JP._pipeline_frame, JP.finish_frame_pipeline = orig, orig_finish
    return stream, inline, jax_frames, records, stage_a


@lru_cache(maxsize=None)
def port_decoded(name):
    """(frames, native records, pack comparisons, frame-program inputs)
    of ``TorchDecoder(device="cpu")`` on one config's stream.  Each pack
    comparison is the port's and the JAX package's
    ``pack_frame_native`` of one of the port's pictures; each
    frame-program input is (meta, canvas0, spec)."""
    stream = decoded(name)[0]
    stage_a, packs, programs = [], [], []
    orig_finish, orig_program = PP.finish_frame, PP.frame_program

    def finish(pic, lay, poc, device):
        stage_a.append(_records(pic))
        if pic.sps.chroma_format_idc:   # both PackedFrame packs need chroma
            packs.append((port_native.pack_frame_native(pic),
                          native.pack_frame_native(pic)))
        return orig_finish(pic, lay, poc, device)

    def program(meta, meta16, meta8, avail_u8, levels16, scale_bank,
                canvas0, *rest):
        programs.append((np.array(meta), canvas0, rest[-2]))
        return orig_program(meta, meta16, meta8, avail_u8, levels16,
                            scale_bank, canvas0, *rest)

    PP.finish_frame, PP.frame_program = finish, program
    try:
        frames = _planes(TorchDecoder(check_md5=True,
                                      device="cpu").decode_bytes(stream))
    finally:
        PP.finish_frame, PP.frame_program = orig_finish, orig_program
    return frames, stage_a, packs, programs


def run_port(rec):
    """Feed one record's inputs to the port's frame program (NumPy out)."""
    refs = [[torch.from_numpy(r) for r in rs] for rs in rec["refs"]]
    out = frame_program(*rec["bufs"], rec["bank"], rec["canvas0"], *refs,
                        rec["spec"], CPU)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_frame_program_matches_jax(name):
    records = decoded(name)[3]
    assert records and any(dict(r["spec"])["n_refs"] for r in records)
    for k, rec in enumerate(records):
        got = run_port(rec)
        assert np.array_equal(got[0], rec["out"][0]), f"{name} frame {k}"
        for p in range(3):
            assert np.array_equal(got[1 + p], rec["out"][1 + p]), \
                f"{name} frame {k} padded ref {p}"


def test_configs_reach_every_spec_feature():
    """The JAX frame-program calls compared above include per-slice filter
    maps, PCM/TQB exemption masks, a PCM canvas and 4:0:0."""
    specs = {k: [(dict(r["spec"]), r["canvas0"]) for r in decoded(k)[3]]
             for k in ("slices_pcm", "mono")}
    sp = specs["slices_pcm"]
    assert all(S["per_slice"] for S, _c in sp)
    assert any(S["nf"] for S, _c in sp) and any(c.any() for _S, c in sp)
    assert all(S["mono"] and S["do_deblock"] and S["do_sao"]
               for S, _c in specs["mono"])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_torch_decoder_matches_jax_and_inline(name):
    _stream_, inline, jax_frames = decoded(name)[:3]
    got = port_decoded(name)[0]
    assert len(got) == len(inline) == len(jax_frames)
    for (a, _ma, pa), (b, _mb, pb), (c, mc, pc) in zip(inline, jax_frames,
                                                       got):
        assert pa == pb == pc and mc is True
        assert len(a) == len(b) == len(c)
        for p in range(len(c)):
            assert np.array_equal(a[p], c[p]), f"{name} poc {pc} plane {p}"
            assert np.array_equal(b[p], c[p])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_native_records_match_jax_package(name):
    """The port's native stage A (its own copy of stage_a.cpp, built into
    hevc_tpu_torch/build/) records what hevc_tpu.native records."""
    want = decoded(name)[4]
    got = port_decoded(name)[1]
    assert len(got) == len(want) > 0
    for k, ((gr, gl), (wr, wl)) in enumerate(zip(got, want)):
        assert np.array_equal(gr, wr), f"{name} picture {k} records"
        assert np.array_equal(gl, wl), f"{name} picture {k} levels"


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b) and a.dtype == b.dtype
    return a == b


@pytest.mark.parametrize("name", sorted(set(CONFIGS) - {"mono"}))
def test_pack_frame_native_matches_jax_package(name):
    packs = port_decoded(name)[2]
    assert packs
    for k, (got, want) in enumerate(packs):
        for field in want.__dataclass_fields__:
            assert _same(getattr(got, field), getattr(want, field)), \
                f"{name} picture {k} PackedFrame.{field}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_resid_tus_lie_inside_the_canvas_and_are_disjoint(name):
    """What makes resid_add_kernel's one launch over all four classes
    exact: no TU of the port's pack straddles the canvas edge (where JAX
    reads it from a clamped origin), so each TU reads only the pixels it
    writes, and no two TUs of a picture, of any classes, share a pixel."""
    n_tu = 0
    for meta, canvas0, spec in port_decoded(name)[3]:
        S = dict(spec)
        ch, cw = canvas0 if isinstance(canvas0, tuple) else canvas0.shape
        pos = sum(S["n_chunks"] * b * 8 for b in S["B"]) \
            + sum(n * 9 for n in S["nlv"])
        cover = np.zeros((ch, cw), np.int32)
        for c, n in enumerate(S["resid_rows"]):
            s = 4 << c
            rows = meta[pos:pos + 3 * n].reshape(n, 3)
            pos += 3 * n
            assert ((rows[:, 0] >= 0) & (rows[:, 0] <= ch - s)
                    & (rows[:, 1] >= 0) & (rows[:, 1] <= cw - s)).all()
            for cy, cx, _slot in rows:
                cover[cy:cy + s, cx:cx + s] += 1
            n_tu += n
        assert cover.max() <= 1
    assert n_tu > 0


@pytest.mark.parametrize("name", sorted(INLINE_ONLY))
def test_torch_decoder_matches_inline(name):
    kw, n = INLINE_ONLY[name]
    stream = encode_config(kw, n)
    want = _planes(Decoder(check_md5=True,
                           recon_backend="inline").decode_bytes(stream))
    got = _planes(TorchDecoder(check_md5=True,
                               device="cpu").decode_bytes(stream))
    assert len(got) == len(want) == n
    for (a, _ma, pa), (c, mc, pc) in zip(want, got):
        assert pa == pc and mc is True
        for p in range(3):
            assert np.array_equal(a[p], c[p]), f"{name} poc {pc} plane {p}"


def test_dpb_from_numpy_matches_pad_np():
    rng = np.random.default_rng(0)
    planes = [rng.integers(0, 256, (80, 96)).astype(np.uint8),
              rng.integers(0, 256, (40, 48)).astype(np.uint8),
              rng.integers(0, 1024, (40, 48)).astype(np.uint16)]
    want = JP._pad_np(planes)
    got = dpb_from_numpy(planes, CPU)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_unported_spec_features_raise():
    """What the frame program leaves out on purpose: the TPU-aligned pack
    layout (the sparse level upload is ported: tests/test_torch_coo.py)."""
    rec = decoded("ipp_wpp")[3][0]
    spec = tuple((k, 1 if k == "pallas" else v) for k, v in rec["spec"])
    with pytest.raises(NotImplementedError, match="Hopper, not TPU"):
        run_port(dict(rec, spec=spec))
