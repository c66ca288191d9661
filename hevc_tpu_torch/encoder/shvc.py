"""SHVC two-layer scalable encoder (spatial ×2 / ×1.5 / arbitrary, SNR).

Produces conforming SHM-style scalable streams: one VPS with the SHVC
extension (rep formats, layer dependency), per-layer SPS/PPS, and per-AU
base-layer + enhancement-layer slices.  The EL predicts from the
upsampled BL reconstruction inserted as a long-term inter-layer
reference (capability parity with the reference's SHVC encoder inputs —
the openHEVC fork only decodes; stream structure mirrors what its
decoder consumes: hevcdec.c:3597-3637, hevc_refs.c:168, openhevc.c).

EL IRAP pictures carry P slices predicting only from the inter-layer
ref (allowed for nuh_layer_id > 0 — reference: hevcdec.c:791 applies the
I-slice IRAP restriction to decoder 0 only).

Copied from ``hevc_tpu/encoder/shvc.py`` at 52b2179.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..bitstream import nal as nalmod
from ..bitstream.ps import VPS, VPSExt, RepFormat
from ..ops.upsample import upsample_frame, upscale_motion_field
from .core import EncoderConfig, IntraEncoder


class ElEncoder(IntraEncoder):
    """Enhancement-layer encoder: every frame is a P slice whose L0 is
    [previous EL frame, inter-layer ref] (or [IL ref] at IRAP)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__(cfg)
        self.layer_id = 1
        self.il_planes = None  # set per frame by ShvcEncoder

    def _frame_type(self):
        # P slices always; reset the DPB at the (aligned) IRAP
        return True, False, self.frames_encoded == 0

    def _nal_type(self):
        return (nalmod.NAL_IDR_W_RADL if self.frames_encoded == 0
                else nalmod.NAL_TRAIL_R)

    def _setup_tmvp(self):
        if self.frames_encoded == 0:
            return None  # IDR: slice_temporal_mvp_enabled inferred 0
        if self.cfg.tmvp_col_ref_idx == 1:
            # collocated = the IL ref: upscaled BL motion field
            from ..coding.mvs import TemporalCtx
            sps = self.sps
            return TemporalCtx(
                col=self.il_motion, cur_poc=self.poc,
                ctb_log2=sps.log2_ctb_size, pic_w=sps.width,
                pic_h=sps.height, no_backward=True, col_from_l0=True)
        return super()._setup_tmvp()

    def _setup_refs(self):
        assert self.il_planes is not None, "IL ref not set"
        il_entry = (self.poc, self.il_planes)
        if self.dpb:
            # RPL order: ST_CURR_BEF then IL_REF0 (hevc_refs.c:541-545)
            self.ref_list = [self.dpb[-1], il_entry]
            self.ref_lt0 = [False, True]
        else:
            self.ref_list = [il_entry]
            self.ref_lt0 = [True]
        self.ref_list_l1 = []
        self.ref_lt1 = []


class ShvcEncoder:
    """Two-layer scalable encoder: feed per-AU (BL planes, EL planes).

    `cgs` (ops.cgs.CgsLut) + `cgs_splits`/`cgs_deltas` enable CGS
    colour-gamut scalability: the EL PPS carries the 3D-LUT in its
    multilayer extension and the inter-layer reference is built from the
    colour-MAPPED BL reconstruction (reference: hevcdec.c:3627-3629)."""

    def __init__(self, bl_cfg: EncoderConfig, el_cfg: EncoderConfig,
                 cgs=None, cgs_splits=None, cgs_deltas=None):
        assert bl_cfg.chroma_format_idc == 1 and \
            el_cfg.chroma_format_idc == 1, "SHVC layers are 4:2:0"
        self.bl = IntraEncoder(bl_cfg)
        self.el = ElEncoder(el_cfg)
        self.cgs = cgs
        if cgs is not None:
            self.el.pps.cgs_lut = cgs
            self.el.pps.cgs_splits = cgs_splits
            self.el.pps.cgs_deltas = cgs_deltas
            # materialize cgs.lut exactly as a decoder will parse it
            self.el.pps.write_rbsp()
        self.bl.include_headers_in_first_au = False
        self.el.include_headers_in_first_au = False
        self.el.sps.sps_id = 1
        self.el.pps.pps_id = 1
        self.el.pps.sps_id = 1

        def rep(cfg):
            return RepFormat(width=cfg.width, height=cfg.height,
                             chroma_format_idc=cfg.chroma_format_idc,
                             bit_depth_luma=cfg.bit_depth,
                             bit_depth_chroma=cfg.bit_depth)

        vps = VPS(max_layers=2, max_layer_id=1,
                  layer_id_included=[[1, 1]],
                  vps_ext=VPSExt(rep_formats=[rep(bl_cfg), rep(el_cfg)]))
        vps.vps_ext.derive(2)
        self.vps = vps
        self.bl.vps = vps
        self.el.vps = vps
        self.frames_encoded = 0

    def headers_annexb(self) -> bytes:
        return nalmod.write_annexb([
            (nalmod.NAL_VPS, 0, 0, self.vps.write_rbsp()),
            (nalmod.NAL_SPS, 0, 0, self.bl.sps.write_rbsp()),
            (nalmod.NAL_SPS, 1, 0, self.el.sps.write_rbsp()),
            (nalmod.NAL_PPS, 0, 0, self.bl.pps.write_rbsp()),
            (nalmod.NAL_PPS, 1, 0, self.el.pps.write_rbsp()),
        ])

    def encode_frame(self, bl_planes: List[np.ndarray],
                     el_planes: List[np.ndarray]) -> bytes:
        """Encode one access unit (BL picture + EL picture)."""
        au = b""
        if self.frames_encoded == 0:
            au += self.headers_annexb()
        au += self.bl.encode_frame(bl_planes)
        bl_recon = [p.astype(np.int32) for p in self.bl.recon_planes]
        bl_bd = self.bl.cfg.bit_depth
        if self.cgs is not None:
            from ..ops.cgs import color_map_frame
            bl_recon = color_map_frame(self.cgs, bl_recon)
            bl_bd = self.cgs.out_bd_y
        self.el.il_planes = upsample_frame(
            bl_recon, self.el.cfg.width, self.el.cfg.height,
            sub_w=self.el.sps.sub_w, sub_h=self.el.sps.sub_h,
            bl_bit_depth=bl_bd,
            el_bit_depth=self.el.cfg.bit_depth)
        bl_poc = self.bl.poc - 1
        self.el.il_motion = upscale_motion_field(
            self.bl.dpb_motion[bl_poc], self.bl.cfg.width,
            self.bl.cfg.height, self.el.cfg.width, self.el.cfg.height,
            bl_poc, irap=self.frames_encoded == 0)
        au += self.el.encode_frame(el_planes)
        self.frames_encoded += 1
        return au
