"""Streams and decode helpers of the port's format tests, importing only
the port (the card tests run where the JAX package is not installed).

Every stream is made by the port's encoder, which writes the bytes the JAX
package's encoder writes (tests/test_torch_host.py); each named stream
takes the settings of the JAX package's test that defines it.
"""
import numpy as np

from hevc_tpu_torch import pipeline as PP
from hevc_tpu_torch.decoder import Decoder, TorchDecoder
from hevc_tpu_torch.encoder.core import EncoderConfig, IntraEncoder, RaEncoder
from hevc_tpu_torch.encoder.generate import synth_frame

CONFIGS = {
    # the headline stream's settings at 96x80: IPP, WPP, deblock, SAO
    "ipp_wpp": (dict(width=96, height=80, qp=30, gop="ipp", wpp=True,
                     deblocking=True, sao=True, log2_ctb_size=5,
                     log2_cu_size=5, search_range=3, seed=1), 3),
    # tests/test_pipeline.py CONFIGS: bi prediction, explicit WP
    "ra_filters": (dict(width=96, height=80, qp=31, gop="ra",
                        deblocking=True, sao=True, split_policy="random",
                        seed=2, max_transform_hierarchy_depth_intra=2), 8),
    "wp": (dict(width=64, height=64, qp=30, gop="lowb",
                weighted_pred=True, search_range=2), 6),
    # the frame program's per-slice maps, nf masks and PCM canvas (two
    # slices of two tiles each, no cross-tile filtering), and 4:0:0
    "slices_pcm": (dict(width=128, height=64, qp=30, gop="ipp",
                        log2_ctb_size=5, log2_cu_size=4, tiles=(4, 1),
                        lf_across_tiles=False, slices=2,
                        slice_filter_params=(
                            dict(beta_offset=2, tc_offset=-2,
                                 lf_across=False),
                            dict(beta_offset=-4, tc_offset=2)),
                        pcm=0.3, pcm_loop_filter_disabled=True,
                        deblocking=True, sao=True, search_range=2,
                        seed=1), 3),
    "mono": (dict(width=96, height=64, qp=30, gop="ipp", chroma_format_idc=0,
                  deblocking=True, sao=True, log2_ctb_size=5,
                  search_range=2, seed=1), 3),
}

# more formats of tests/test_pipeline.py CONFIGS, against the inline decoder
INLINE_ONLY = {
    "main10_422": (dict(width=64, height=48, qp=30, bit_depth=10,
                        chroma_format_idc=2, gop="ipp"), 3),
    # both loop filters in 4:2:2, where the JAX device path raises
    "main10_422_filters": (dict(width=64, height=48, qp=30, bit_depth=10,
                                chroma_format_idc=2, gop="ipp",
                                deblocking=True, sao=True,
                                log2_ctb_size=4), 3),
    "scaling": (dict(width=64, height=48, qp=30, scaling_lists="custom",
                     gop="ipp"), 3),
    "amp_qp": (dict(width=64, height=64, qp=30, gop="ra", amp="all",
                    log2_ctb_size=5, cu_qp_delta_depth=1), 8),
    "tmvp": (dict(width=64, height=64, qp=30, gop="lowb", tmvp=True), 6),
}


def encode_config(kw, n, seed=3):
    """tests/test_pipeline.py's stream of one config: n noise frames."""
    cfg = EncoderConfig(**kw)
    frames = [synth_frame("noise", cfg.width, cfg.height, t, seed=seed)
              for t in range(n)]
    if cfg.bit_depth > 8:
        frames = [[p.astype(np.int32) << (cfg.bit_depth - 8) for p in f]
                  for f in frames]
    if cfg.gop == "ra":
        return bytes(RaEncoder(cfg).encode(frames))
    enc = IntraEncoder(cfg)
    return b"".join(enc.encode_frame(f) for f in frames)


def _encode(kw, w, h, n, seed, mono=False):
    enc = IntraEncoder(EncoderConfig(width=w, height=h, **kw))
    out = bytearray()
    for t in range(n):
        f = synth_frame("noise", w, h, t, seed=seed)
        out += enc.encode_frame(f[:1] if mono else f)
    return bytes(out)


def _multislice(w=96, h=96, n=3, **kw):
    """tests/test_multislice.py ``encode``."""
    return _encode(dict(qp=30, log2_ctb_size=5, log2_cu_size=5, gop="ipp",
                        seed=2, search_range=2, **kw), w, h, n, 4)


def _mono(**kw):
    """tests/test_monochrome.py ``encode_mono``."""
    return _encode(dict(qp=30, log2_ctb_size=5, log2_cu_size=5, seed=2,
                        chroma_format_idc=0, **kw), 96, 64, 3, 4, mono=True)


PER_SLICE = (  # tests/test_multislice.py
    dict(beta_offset=4, tc_offset=-2, lf_across=False),
    dict(disable=True),
    dict(beta_offset=-2, tc_offset=4, sao=False, lf_across=True),
)

# tests/test_dependent_slices.py and tests/test_rext_tools.py CASES
DEPENDENT = {
    "one_dep": dict(dependent_slices=1),
    "two_dep": dict(dependent_slices=2),
    "two_dep_ipp": dict(dependent_slices=2, gop="ipp", search_range=2),
    "dep_cu_qp": dict(dependent_slices=1, cu_qp_delta_depth=0),
}
REXT = {
    "persistent_rice": dict(transform_skip=True,
                            rext_persistent_rice=True),
    "ts_context": dict(transform_skip=True, rext_ts_context=True),
    "ts_rotation": dict(transform_skip=True, rext_ts_rotation=True),
    "implicit_rdpcm": dict(transform_skip=True,
                           rext_implicit_rdpcm=True),
    "chroma_qp_offsets": dict(
        rext_chroma_qp_offsets=((3, -3), (-2, 4))),
    "all_tools": dict(transform_skip=True, rext_persistent_rice=True,
                      rext_ts_context=True, rext_ts_rotation=True,
                      rext_implicit_rdpcm=True,
                      rext_chroma_qp_offsets=((2, -2),)),
    "inter_rice": dict(transform_skip=True, rext_persistent_rice=True,
                       rext_ts_context=True, gop="ipp", search_range=2),
    "ccp": dict(chroma_format_idc=3, rext_ccp=True),
    "ccp_tools": dict(chroma_format_idc=3, rext_ccp=True,
                      transform_skip=True, rext_persistent_rice=True,
                      rext_ts_context=True),
    "explicit_rdpcm": dict(gop="ipp", search_range=2,
                           rext_explicit_rdpcm=True),
    "explicit_rdpcm_tools": dict(gop="ipp", search_range=2,
                                 rext_explicit_rdpcm=True,
                                 rext_persistent_rice=True,
                                 rext_ts_context=True),
}

# name -> a zero-argument function that encodes the stream
FORMATS = {
    # tests/test_multislice.py
    "per_slice_params": lambda: _multislice(
        slices=3, deblocking=True, sao=True, slice_filter_params=PER_SLICE),
    "tiles": lambda: _multislice(
        w=128, h=64, slices=2, tiles=(4, 1), deblocking=True, sao=True,
        slice_filter_params=(dict(beta_offset=2), dict(tc_offset=-2))),
    "tiles_no_loop_filter_across": lambda: _multislice(
        w=128, h=64, tiles=(2, 2), deblocking=True, sao=True,
        lf_across_tiles=False),
    "dependent_with_wpp": lambda: _multislice(
        dependent_slices=2, wpp=True, deblocking=True, sao=True),
    "dependent_with_tiles": lambda: _multislice(
        w=128, h=64, dependent_slices=3, tiles=(2, 2), deblocking=True,
        sao=True),
    "inter_gop": lambda: _multislice(
        n=4, slices=2, deblocking=True, sao=True,
        slice_filter_params=(dict(beta_offset=2, lf_across=False),
                             dict(tc_offset=2))),
    # tests/test_monochrome.py, the cases the JAX device path decodes
    "mono_intra": lambda: _mono(deblocking=True),
    "mono_inter_sao": lambda: _mono(deblocking=True, sao=True, gop="ipp",
                                    search_range=2),
    # 4:0:0 P pictures whose stage A runs in the Python syntax layer
    "mono_dependent_ipp": lambda: _mono(deblocking=True, sao=True,
                                        gop="ipp", search_range=2,
                                        dependent_slices=1),
    # tests/test_pipeline.py CONFIGS
    "pcm": lambda: encode_config(dict(
        width=64, height=48, qp=30, pcm=0.5, pcm_bit_depth=6,
        pcm_loop_filter_disabled=True, deblocking=True), 3),
    "pipeline_tiles": lambda: encode_config(dict(
        width=96, height=64, qp=30, gop="ipp", tiles=(2, 2)), 3),
}
for _k, _kw in DEPENDENT.items():
    FORMATS["dep_" + _k] = (lambda kw=_kw: _encode(dict(
        qp=30, log2_ctb_size=5, log2_cu_size=5, seed=3, deblocking=True,
        sao=True, **kw), 96, 96, 3, 6))
for _k, _kw in REXT.items():
    FORMATS["rext_" + _k] = (lambda kw=_kw: _encode(dict(
        qp=30, log2_ctb_size=5, log2_cu_size=5, seed=3, **kw), 96, 64, 3,
        6))


# ---------------------------------------------------------------------------
# SHVC two-layer streams: the configurations of tests/test_shvc.py and
# tests/test_cgs.py, made by the port's ShvcEncoder
# ---------------------------------------------------------------------------

# tests/test_cgs.py DELTAS1: gain and DC changes per octant half
CGS_DELTAS = {
    (0, 0, 0, 0): (-3, 0, 1),
    (0, 0, 0, 3): (2, -1, 0),
    (0, 1, 0, 1): (4, 2, -2),
    (1, 0, 1, 2): (-2, 3, 1),
    (1, 1, 1, 3): (1, 1, 1),
}


def shvc_configs(bl_wh, el_wh, qp=30, **el_kw):
    """tests/test_shvc.py ``cfg_pair``."""
    bl = EncoderConfig(width=bl_wh[0], height=bl_wh[1], qp=qp,
                       log2_ctb_size=5, log2_cu_size=5, gop="ipp",
                       search_range=2, seed=3)
    el = EncoderConfig(width=el_wh[0], height=el_wh[1], qp=qp,
                       log2_ctb_size=5, log2_cu_size=5, gop="ipp",
                       search_range=2, seed=4, **el_kw)
    return bl, el


def cgs_lut():
    """tests/test_cgs.py ``lut_depth1``."""
    from hevc_tpu_torch.ops.cgs import CgsLut
    return CgsLut(octant_depth=1, y_part_num_log2=1, res_quant_bit=1,
                  flc_bits=2, adapt_threshold_u_delta=5,
                  adapt_threshold_v_delta=-3)


def encode_shvc(encoder_cls, bl, el, n, sources=("gradient", "zoneplate"),
                synth=synth_frame, cgs=None):
    """tests/test_shvc.py ``encode_shvc`` (an EL deeper than 8 bits gets
    its source shifted up, as test_shvc_bit_depth_8_to_10 does), with
    ``encoder_cls`` the port's or the JAX package's ShvcEncoder and
    ``synth`` its ``synth_frame``.  ``cgs``: a CgsLut for tests/test_cgs.py
    ``encode_cgs`` (with CGS_DELTAS)."""
    kw = {} if cgs is None else dict(cgs=cgs, cgs_deltas=CGS_DELTAS)
    enc = encoder_cls(bl, el, **kw)
    bl_base = synth(sources[0], bl.width, bl.height, 0)
    el_base = synth(sources[1], el.width, el.height, 0)
    if el.bit_depth > 8:
        el_base = [p.astype(np.int32) << (el.bit_depth - 8) for p in el_base]
    out = bytearray()
    for t in range(n):
        out += enc.encode_frame(
            [np.roll(p, (t * 2, t * 3), (0, 1)) for p in bl_base],
            [np.roll(p, (t * 4, t * 6), (0, 1)) for p in el_base])
    return bytes(out)


def _tmvp(col_idx, bl_tmvp):
    bl, el = shvc_configs((64, 64), (128, 128))
    bl.tmvp, el.tmvp, el.tmvp_col_ref_idx = bl_tmvp, True, col_idx
    return (bl, el), 4, {}


def _filters():
    bl, el = shvc_configs((64, 64), (128, 128))
    for c in (bl, el):
        c.deblocking = c.sao = True
    return (bl, el), 3, dict(sources=("noise", "zoneplate"))


def _snr():
    bl, el = shvc_configs((64, 64), (64, 64), qp=34)
    el.qp = 26  # SNR scalability: same size, finer quantization
    return (bl, el), 3, {}


# name -> a zero-argument function giving ((bl config, el config), access
# units, encode_shvc's keywords); fresh configs on every call
SHVC = {
    "x2": lambda: (shvc_configs((64, 64), (128, 128)), 3, {}),
    "x1_5": lambda: (shvc_configs((64, 64), (96, 96)), 2, {}),
    "arbitrary": lambda: (shvc_configs((48, 32), (112, 80)), 2, {}),
    "snr": _snr,
    "filters": _filters,
    "tmvp_col0": lambda: _tmvp(0, False),
    "tmvp_col1": lambda: _tmvp(1, True),
    "bd8_10": lambda: (shvc_configs((64, 64), (128, 128), bit_depth=10),
                       3, {}),
    "cgs": lambda: (shvc_configs((64, 64), (128, 128)), 3,
                    dict(cgs=cgs_lut())),
    "cgs_snr": lambda: (shvc_configs((64, 64), (64, 64)), 3,
                        dict(cgs=cgs_lut())),
}


def shvc_stream(name):
    """The SHVC stream ``name`` made by the port's encoder."""
    from hevc_tpu_torch.encoder.shvc import ShvcEncoder
    (bl, el), n, kw = SHVC[name]()
    return encode_shvc(ShvcEncoder, bl, el, n, **kw)


def planes_of(frames):
    """[(planes as NumPy, md5_ok, poc)] of decoded frames."""
    return [([np.asarray(p) for p in f.planes], f.md5_ok, f.poc)
            for f in frames]


def decode_port(stream, device):
    """``TorchDecoder`` on ``device``: (planes_of its frames, the number of
    pictures that went through the frame program)."""
    n = [0]
    orig = PP.finish_frame

    def finish(*args):
        n[0] += 1
        return orig(*args)

    PP.finish_frame = finish
    try:
        frames = TorchDecoder(check_md5=True,
                              device=device).decode_bytes(stream)
        return planes_of(frames), n[0]
    finally:
        PP.finish_frame = orig


def decode_inline(stream):
    """The port's inline (NumPy) decoder."""
    return planes_of(Decoder(check_md5=True,
                             recon_backend="inline").decode_bytes(stream))


def assert_same(want, got, name, need_md5=True):
    """Frame by frame: the same POCs and every plane equal; every frame's
    SEI MD5 correct on the port."""
    assert len(got) == len(want) > 0, name
    for (a, _ma, pa), (c, mc, pc) in zip(want, got):
        assert pa == pc, name
        assert mc is True or not need_md5, f"{name} poc {pc} md5 {mc}"
        assert len(a) == len(c), f"{name} poc {pc} planes"
        for p, (x, y) in enumerate(zip(a, c)):
            assert np.array_equal(x, y), f"{name} poc {pc} plane {p}"
