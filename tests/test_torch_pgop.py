"""The port's frame-axis decode against the sequential decode and the JAX
package's, bit for bit (tolerance 0), on the CPU: the parallel-B GOP
(``encoder.pgop.ParallelBGopEncoder``: I0, P(n+1), then n B pictures that
read only the two anchors) with 4 and 8 B pictures in one batch, its stream
on the port's inline, plan and torch backends with every MD5, a normal
hierarchical-B RA stream through ``decode_frame_parallel``, a parallel-B
GOP of three slices (their own filter offsets, one without loop filtering
across its edges, one without deblocking) with PCM exempt from the
filters, and ``ref_batches``.  No reference comes from the host."""
import jax
import numpy as np
import pytest

import hevc_tpu.decoder.core as jax_dcore
from hevc_tpu.tpu.pgop_frame import decode_bframes_frame_axis as jax_bframes
from hevc_tpu.tpu.pgop_frame import ref_batches as jax_ref_batches
from hevc_tpu_torch import pipeline
from hevc_tpu_torch.decoder import Decoder
from hevc_tpu_torch.decoder import core as dcore
from hevc_tpu_torch.encoder.core import EncoderConfig, RaEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.encoder.pgop import ParallelBGopEncoder
from hevc_tpu_torch.pgop_frame import (decode_bframes_frame_axis,
                                       decode_frame_parallel, ref_batches)

RA = dict(width=96, height=64, qp=30, log2_ctb_size=5, log2_cu_size=5,
          gop="ra", deblocking=True, sao=True, search_range=2)


def _assert_planes(got, want, what):
    for p, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        bad = np.argwhere(g != w)
        assert g.shape == w.shape and not bad.size, (
            f"{what} plane {p}: first differing (y, x) "
            f"{tuple(bad[0]) if bad.size else None}")


def _sequential(stream):
    frames = Decoder(recon_backend="inline").decode_bytes(stream)
    assert all(f.md5_ok for f in frames)
    return {f.poc: f.planes for f in frames}


@pytest.mark.parametrize("n", [4, 8])
def test_frame_axis_matches_sequential_and_jax(n):
    pipeline.host_refs["count"] = 0
    stream, got, batches = decode_bframes_frame_axis(["cpu"] * n)
    assert pipeline.host_refs["count"] == 0
    assert batches == [[0], [n + 1], list(range(1, n + 1))]
    want = _sequential(stream)
    jgot, _jwant = jax_bframes(n, jax.devices("cpu")[:n], width=96,
                               height=64)
    assert sorted(got) == list(range(1, n + 1))
    for k in range(1, n + 1):
        _assert_planes(got[k], want[k], f"B{k} vs sequential")
        _assert_planes(got[k], jgot[k - 1], f"B{k} vs JAX")
    assert any((got[1][0] != got[k][0]).any() for k in range(2, n + 1))


def test_pgop_stream_decodes_on_every_backend():
    """The parallel-B stream is a conforming stream: bit-exact with the
    encoder's reconstructions, every MD5 correct, on the inline, plan and
    torch (CPU) backends; its temporal layer 1 drops cleanly."""
    n_b = 4
    enc = ParallelBGopEncoder(EncoderConfig(**RA, seed=2), n_b)
    stream = enc.encode([synth_frame("noise", 96, 64, t, seed=4)
                         for t in range(n_b + 2)])
    recons = dict(enc.recons)
    for backend in ("inline", "plan", "torch"):
        kw = dict(device="cpu") if backend == "torch" else {}
        frames = Decoder(recon_backend=backend, **kw).decode_bytes(stream)
        assert len(frames) == n_b + 2
        for f in frames:
            assert f.md5_ok, f"poc {f.poc} md5 [{backend}]"
            _assert_planes(f.planes, recons[f.poc], f"poc {f.poc} {backend}")
    anchors = Decoder(temporal_layer=0).decode_bytes(stream)
    assert sorted(f.poc for f in anchors) == [0, n_b + 1]


def test_frame_parallel_decodes_a_normal_ra_stream():
    """A hierarchical-B RA stream of the standard encoder: its dependency
    batches spread over 4 devices, at least one batch of two pictures or
    more, bit-exact against the sequential decode."""
    stream = RaEncoder(EncoderConfig(**RA, seed=3)).encode(
        [synth_frame("noise", 96, 64, t, seed=5) for t in range(6)])
    pipeline.host_refs["count"] = 0
    got, batches = decode_frame_parallel(stream, ["cpu"] * 4)
    assert pipeline.host_refs["count"] == 0
    assert any(len(b) >= 2 for b in batches), batches
    want = _sequential(stream)
    assert sorted(got) == sorted(want) == list(range(6))
    for poc in want:
        _assert_planes(got[poc], want[poc], f"poc {poc}")


def test_frame_axis_decodes_a_multislice_batch():
    """A parallel-B GOP whose pictures have three slices with their own
    filters and PCM exempt from them: its four B pictures in one batch over
    4 devices, every picture bit-exact against the sequential decode."""
    n_b = 4
    cfg = EncoderConfig(**RA, seed=2, slices=3, slice_filter_params=(
        dict(beta_offset=2, tc_offset=-2),
        dict(lf_across=False, beta_offset=-4, tc_offset=2),
        dict(disable=True)), pcm=0.2, pcm_loop_filter_disabled=True)
    stream = ParallelBGopEncoder(cfg, n_b).encode(
        [synth_frame("gradient", 96, 64, t, seed=4) for t in range(n_b + 2)])
    pipeline.host_refs["count"] = 0
    got, batches = decode_frame_parallel(stream, ["cpu"] * 4)
    assert pipeline.host_refs["count"] == 0
    assert batches == [[0], [n_b + 1], list(range(1, n_b + 1))]
    want = _sequential(stream)
    assert sorted(got) == sorted(want) == list(range(n_b + 2))
    for poc in want:
        _assert_planes(got[poc], want[poc], f"poc {poc}")


def _captured(mod, stream):
    out = []
    orig = mod.execute_plan_numpy

    def capture(pic, plan):
        out.append((pic, list(plan), None))
        orig(pic, plan)

    mod.execute_plan_numpy = capture
    try:
        mod.Decoder(recon_backend="plan").decode_bytes(stream)
    finally:
        mod.execute_plan_numpy = orig
    return out


def test_ref_batches_match_jax():
    """The batch schedule of a 6-frame RA GOP: the JAX package's, with at
    least one batch of several pictures."""
    cfg = EncoderConfig(width=64, height=48, qp=32, gop="ra", seed=1,
                        search_range=2)
    stream = RaEncoder(cfg).encode([synth_frame("gradient", 64, 48, t)
                                    for t in range(6)])
    got = [[item[0].poc for item in b]
           for b in ref_batches(_captured(dcore, stream))]
    want = [[item[0].poc for item in b]
            for b in jax_ref_batches(_captured(jax_dcore, stream))]
    assert got == want
    assert sum(map(len, got)) == 6 and any(len(b) >= 2 for b in got), got


def test_ref_batches_refuse_a_reference_decoded_later():
    class Pic:
        def __init__(self, poc, refs):
            self.poc = poc
            self.ref_list_l0 = [(r, None) for r in refs]

    with pytest.raises(ValueError, match="reference availability"):
        ref_batches([(Pic(0, []), None), (Pic(1, [2]), None)])
