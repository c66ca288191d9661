"""The port's SHVC inter-layer reference against the JAX package's, bit for
bit (tolerance 0), on inputs made from NumPy seeds: ``upsample_frame`` at
x2, x1.5, an arbitrary ratio, x1 (SNR) and across bit depths,
``color_map_frame`` with random LUTs of octant depth 1 and 2,
``pad_dev_refs`` with ``aligned=False``, ``upscale_motion_field`` (the
port's per-block NumPy against the JAX package's loop); the port's
``ShvcEncoder``
writes the JAX package's bytes; ``LazyPlanes`` over a list of planes and
``device_ready``; the IL build refuses a base layer missing from its
device DPB.  tests/test_torch_shvc_streams.py decodes the two-layer
streams."""
import numpy as np
import pytest
import torch

from hevc_tpu.bitstream.bits import BitWriter as JaxBitWriter
from hevc_tpu.encoder.core import EncoderConfig as JaxConfig
from hevc_tpu.encoder.generate import synth_frame as jax_synth
from hevc_tpu.encoder.shvc import ShvcEncoder as JaxShvc
from hevc_tpu.ops.cgs import CgsLut as JaxCgsLut
from hevc_tpu.ops.cgs import write_cgs_lut as jax_write_lut
from hevc_tpu.ops.upsample import upscale_motion_field as jax_motion
from hevc_tpu.tpu.pipeline import pad_dev_refs as jax_pad_dev_refs
from hevc_tpu.tpu.upsample import color_map_frame_jax, upsample_frame_jax
from hevc_tpu_torch import pipeline as PP
from hevc_tpu_torch import upsample as UP
from hevc_tpu_torch.bitstream.bits import BitWriter
from hevc_tpu_torch.encoder.shvc import ShvcEncoder
from hevc_tpu_torch.ops.cgs import CgsLut, write_cgs_lut
from hevc_tpu_torch.ops.upsample import upscale_motion_field
from hevc_tpu_torch.pack import PAD_REF
from torch_streams import SHVC, encode_shvc

def _planes(rng, h, w, bd, sub=2):
    return [rng.integers(0, 1 << bd, (h, w)).astype(np.int32),
            rng.integers(0, 1 << bd, (h // sub, w // sub)).astype(np.int32),
            rng.integers(0, 1 << bd, (h // sub, w // sub)).astype(np.int32)]


def _t(planes):
    return [torch.from_numpy(p) for p in planes]


UPSAMPLE = {  # (BL h, w), (EL h, w), BL bit depth, EL bit depth
    "x2": ((24, 32), (48, 64), 8, 8),
    "x1_5": ((32, 48), (48, 72), 8, 8),
    "arbitrary": ((32, 48), (80, 112), 8, 8),   # tests/test_shvc.py:107
    "arbitrary_down_rows": ((40, 24), (56, 60), 8, 8),
    "snr_x1": ((32, 48), (32, 48), 8, 8),
    "bd8_10": ((24, 32), (48, 64), 8, 10),
    "bd10_10": ((24, 32), (36, 48), 10, 10),
}


@pytest.mark.parametrize("name", sorted(UPSAMPLE))
def test_upsample_frame_matches_jax(name):
    (bh, bw), (eh, ew), bl_bd, el_bd = UPSAMPLE[name]
    bl = _planes(np.random.default_rng(len(name)), bh, bw, bl_bd)
    want = upsample_frame_jax(bl, ew, eh, bl_bit_depth=bl_bd,
                              el_bit_depth=el_bd)
    got = UP.upsample_frame(_t(bl), ew, eh, bl_bit_depth=bl_bd,
                            el_bit_depth=el_bd)
    for p, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.int32 and a.shape == tuple(b.shape)
        assert np.array_equal(a.numpy(), np.asarray(b)), (name, p)


def test_upsample_positions_are_cached_per_geometry():
    bl = _t(_planes(np.random.default_rng(0), 16, 16, 8))
    UP._positions.cache_clear()
    for _ in range(3):
        UP.upsample_frame(bl, 24, 24)
    UP.upsample_frame(bl, 32, 32)
    info = UP._positions.cache_info()
    assert info.misses == 2 and info.hits == 2


def _random_lut(pkg_lut, pkg_writer, pkg_write, depth, ypl, out_bd, seed):
    """A LUT of the given octant depth whose every coefficient is random
    (wide enough that mappings wrap int16 and go negative), after the
    PPS writer has laid it out."""
    cgs = pkg_lut(octant_depth=depth, y_part_num_log2=ypl, res_quant_bit=1,
                  flc_bits=2, out_bd_y=out_bd, out_bd_c=out_bd,
                  adapt_threshold_u_delta=5, adapt_threshold_v_delta=-3)
    pkg_write(pkg_writer(), cgs)
    rng = np.random.default_rng(seed)
    shape = cgs.lut.shape
    lut = rng.integers(-3000, 3000, shape).astype(np.int32)
    lut[..., 3, :] = rng.integers(-40000, 40000, shape[:3] + (3,))
    cgs.lut = lut
    return cgs


@pytest.mark.parametrize("depth,ypl,out_bd", [(1, 1, 8), (1, 0, 10),
                                              (2, 0, 8), (2, 1, 10)])
def test_color_map_frame_matches_jax(depth, ypl, out_bd):
    seed = depth * 7 + ypl * 3 + out_bd
    want_lut = _random_lut(JaxCgsLut, JaxBitWriter, jax_write_lut, depth,
                           ypl, out_bd, seed)
    got_lut = _random_lut(CgsLut, BitWriter, write_cgs_lut, depth, ypl,
                          out_bd, seed)
    planes = _planes(np.random.default_rng(seed), 32, 48, 8)
    want = color_map_frame_jax(want_lut, planes)
    got = UP.color_map_frame(got_lut, _t(planes))
    for p, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a.numpy(), np.asarray(b)), (depth, ypl, p)
    # the LUT went to the device once and is kept on the CgsLut
    assert set(got_lut._torch_lut) == {"cpu"}
    lut = got_lut._torch_lut["cpu"]
    UP.color_map_frame(got_lut, _t(planes))
    assert got_lut._torch_lut["cpu"] is lut


@pytest.mark.parametrize("shapes", [((24, 40), (12, 20), (12, 20)),
                                    ((17, 9),)])
def test_pad_dev_refs_matches_jax(shapes):
    rng = np.random.default_rng(len(shapes))
    planes = [rng.integers(0, 1024, s).astype(np.int32) for s in shapes]
    want = jax_pad_dev_refs(planes, False)
    got = PP.pad_dev_refs(_t(planes))
    assert len(got) == 3
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert np.array_equal(a.numpy(), np.asarray(b))
    if len(shapes) == 1:      # monochrome: luma aliased into three slots
        assert got[1] is got[0] and got[2] is got[0]
    with pytest.raises(NotImplementedError, match="TPU-aligned"):
        PP.pad_dev_refs(_t(planes), aligned=True)


MOTION = {  # BL (w, h), EL (w, h)
    "x1_5_1080p": ((1280, 720), (1920, 1080)),
    "x2": ((64, 64), (128, 128)),
    "x1_5_small": ((128, 64), (192, 96)),
    "arbitrary": ((48, 32), (112, 80)),
    "snr": ((64, 64), (64, 64)),
    "off_grids": ((37, 21), (111, 63)),
}


@pytest.mark.parametrize("name", sorted(MOTION))
def test_upscale_motion_field_matches_jax(name):
    """Random BL motion fields (either list empty at random 4x4 blocks,
    MVs past the 16-bit clip after scaling), and the EL IRAP's empty
    field: every array equal, dtype and shape too."""
    (bw, bh), (ew, eh) = MOTION[name]
    rng = np.random.default_rng(len(name))
    h4, w4 = -(-bh // 4), -(-bw // 4)
    no_poc = -(1 << 30)
    field = {
        "mv0": rng.integers(-3000, 3000, (h4, w4, 2)).astype(np.int32),
        "mv1": rng.integers(-40000, 40000, (h4, w4, 2)).astype(np.int32),
        "poc0": np.where(rng.random((h4, w4)) < 0.3, no_poc,
                         rng.integers(-5, 9, (h4, w4))),
        "poc1": np.where(rng.random((h4, w4)) < 0.6, no_poc,
                         rng.integers(-5, 9, (h4, w4))).astype(np.int32)}
    for irap in (False, True):
        want = jax_motion(field, bw, bh, ew, eh, 7, irap=irap)
        got = upscale_motion_field(field, bw, bh, ew, eh, 7, irap=irap)
        assert got["poc"] == want["poc"]
        for k in ("mv0", "mv1", "poc0", "poc1"):
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


def _jax_config(cfg):
    """The JAX package's config of a port config: every field but the
    port's ``source_bit_depth``, which has to be at its default (the JAX
    package codes the planes it is given at ``bit_depth``)."""
    kw = dict(vars(cfg))
    assert kw.pop("source_bit_depth") == 0
    return JaxConfig(**kw)


@pytest.mark.parametrize("name", sorted(SHVC))
def test_port_shvc_encoder_is_byte_identical(name):
    (bl, el), n, kw = SHVC[name]()
    got = encode_shvc(ShvcEncoder, bl, el, n, **kw)
    (jbl, jel), _n, jkw = SHVC[name]()
    jbl, jel = _jax_config(jbl), _jax_config(jel)
    if "cgs" in jkw:
        c = jkw["cgs"]
        jkw["cgs"] = JaxCgsLut(**{k: getattr(c, k) for k in (
            "octant_depth", "y_part_num_log2", "res_quant_bit", "flc_bits",
            "adapt_threshold_u_delta", "adapt_threshold_v_delta")})
    want = encode_shvc(JaxShvc, jbl, jel, n, synth=jax_synth, **jkw)
    assert len(got) > 100 and got == want


def test_lazy_planes_over_a_list_of_device_planes():
    planes = _t(_planes(np.random.default_rng(3), 16, 24, 8))
    lp = PP.LazyPlanes(planes)
    assert len(lp) == 3
    dev = lp.device_planes()
    assert all(a is b for a, b in zip(dev, planes))
    lp.device_ready()          # nothing to wait for on the CPU
    assert lp._np is None      # and nothing was fetched
    assert np.array_equal(lp[1], planes[1].numpy())
    assert lp.device_planes() is None


def test_device_ready_waits_on_the_future_and_fetches_nothing():
    from concurrent.futures import ThreadPoolExecutor
    flat = torch.arange(3 * 4 + 2 * 2 * 2, dtype=torch.uint8)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(lambda: (flat, ((3, 4), (2, 2), (2, 2))))
        lp = PP.LazyPlanes(fut)
        lp.device_ready()
        assert fut.done() and lp._np is None
    assert [p.shape for p in lp.device_planes()] == [(3, 4), (2, 2), (2, 2)]
    assert np.array_equal(lp[0], flat[:12].view(3, 4).numpy())
    lp.device_ready()          # materialised: returns at once


def test_inter_layer_ref_needs_the_base_layer_on_the_device():
    with pytest.raises(RuntimeError, match="poc 7 is not in the base "
                                           "layer's device DPB"):
        PP.inter_layer_ref({}, {}, 7, None, None, 8)


def test_inter_layer_ref_seeds_the_el_device_dpb():
    """The IL job reads the BL's padded interior and leaves the padded
    upsampled planes at the BL's POC in the EL's device DPB."""
    from types import SimpleNamespace
    bl = _planes(np.random.default_rng(5), 16, 24, 8)
    bl_dpb = {4: PP.pad_dev_refs(_t(bl))}
    el_dpb = {}
    sps = SimpleNamespace(width=48, height=32, sub_w=2, sub_h=2,
                          bit_depth_luma=8)
    il = PP.inter_layer_ref(bl_dpb, el_dpb, 4, None, sps, 8)
    want = upsample_frame_jax(bl, 48, 32)
    for a, b, pad in zip(il, want, el_dpb[4]):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert torch.equal(pad[PAD_REF:-PAD_REF, PAD_REF:-PAD_REF], a)
