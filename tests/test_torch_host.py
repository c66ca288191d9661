"""The port's own host side against the JAX package's.

The port carries copies of the JAX package's host code (bitstream, CABAC,
syntax, NumPy oracles, native stage A, containers, encoder) and imports
nothing of it.  Here: no module of hevc_tpu_torch and no line of
chip_smoke.py imports ``jax`` or ``hevc_tpu``; the port's encoder writes
the bytes the JAX package's encoder writes (its parallel-B GOP encoder
too); the port's decoder rejects a backend it does not have.
"""
import ast
import os

import numpy as np
import pytest

from hevc_tpu.encoder.core import EncoderConfig as JaxConfig
from hevc_tpu.encoder.core import IntraEncoder as JaxIntra
from hevc_tpu.encoder.core import RaEncoder as JaxRa
from hevc_tpu.encoder.generate import synth_frame as jax_synth
from hevc_tpu.encoder.pgop import ParallelBGopEncoder as JaxPgop
from hevc_tpu_torch.decoder import Decoder, TorchDecoder
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder, RaEncoder
from hevc_tpu_torch.encoder.generate import synth_frame
from hevc_tpu_torch.encoder.pgop import ParallelBGopEncoder
from test_torch_pipeline import CONFIGS, INLINE_ONLY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "hevc_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, subdirs, files in os.walk(PKG):
        subdirs[:] = [s for s in subdirs if s not in ("build", "__pycache__")]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    """The top-level package of every absolute import in the file."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_hevc_tpu():
    files = _sources()
    assert len(files) > 50
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f))
                                            & {"jax", "hevc_tpu"})
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def _encode(pkg_config, intra, ra, synth, kw, n):
    cfg = pkg_config(**kw)
    frames = [synth("noise", cfg.width, cfg.height, t, seed=3)
              for t in range(n)]
    if cfg.bit_depth > 8:
        frames = [[p.astype(np.int32) << (cfg.bit_depth - 8) for p in f]
                  for f in frames]
    if cfg.gop == "ra":
        return bytes(ra(cfg).encode(frames))
    enc = intra(cfg)
    return b"".join(enc.encode_frame(f) for f in frames)


ALL_CONFIGS = dict(CONFIGS, **INLINE_ONLY)


@pytest.mark.parametrize("name", sorted(ALL_CONFIGS))
def test_port_encoder_is_byte_identical(name):
    kw, n = ALL_CONFIGS[name]
    got = _encode(EncoderConfig, IntraEncoder, RaEncoder, synth_frame, kw, n)
    want = _encode(JaxConfig, JaxIntra, JaxRa, jax_synth, kw, n)
    assert len(got) > 100 and got == want


@pytest.mark.parametrize("n_b", [2, 4])
def test_port_parallel_b_encoder_is_byte_identical(n_b):
    kw = dict(width=96, height=64, qp=30, log2_ctb_size=5, log2_cu_size=5,
              gop="ra", deblocking=True, sao=True, seed=2, search_range=2)
    got_enc = ParallelBGopEncoder(EncoderConfig(**kw), n_b)
    want_enc = JaxPgop(JaxConfig(**kw), n_b)
    got = got_enc.encode([synth_frame("noise", 96, 64, t, seed=4)
                          for t in range(n_b + 2)])
    want = want_enc.encode([jax_synth("noise", 96, 64, t, seed=4)
                            for t in range(n_b + 2)])
    assert len(got) > 100 and got == want
    assert [p for p, _ in got_enc.recons] == [p for p, _ in want_enc.recons]


def test_decoder_refuses_an_unknown_backend():
    with pytest.raises(ValueError, match="recon_backend 'jax'"):
        Decoder(recon_backend="jax")
    dec = TorchDecoder(device="cpu")
    assert isinstance(dec, Decoder) and dec.recon_backend == "torch"
    assert dec.device.type == "cpu"


def test_torch_backend_refuses_pictures_without_native_records(monkeypatch):
    """It no longer does: with the native record stream off, the Python
    syntax layer's plan becomes records (``native.plan_to_records``) and
    the picture goes through the same pack and frame program."""
    cfg = EncoderConfig(width=64, height=64, qp=30, gop="ipp",
                        deblocking=True, sao=True)
    data = IntraEncoder(cfg).encode_frame(synth_frame("noise", 64, 64, 0,
                                                      seed=3))
    want = Decoder(check_md5=True, recon_backend="inline").decode_bytes(data)
    monkeypatch.setenv("HEVC_TPU_NATIVE_PACK", "0")
    got = TorchDecoder(check_md5=True, device="cpu").decode_bytes(data)
    assert [f.md5_ok for f in got] == [True]
    for p in range(3):
        assert np.array_equal(np.asarray(got[0].planes[p]),
                              np.asarray(want[0].planes[p]))
