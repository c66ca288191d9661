"""Slice segment header parse + write (H.265 clause 7.3.6).

Capability parity with the reference's hls_slice_header
(reference: libavcodec/hevcdec.c:612) and SliceHeader struct
(reference: libavcodec/hevc_ps.h:79-234).

Frozen copy of ``hevc_tpu_torch/bitstream/slice.py`` at ee5ffe9.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from .bits import BitReader, BitWriter
from .nal import is_idr_nal, is_irap_nal
from .ps import PPS, SPS, ShortTermRPS

SLICE_B = 0
SLICE_P = 1
SLICE_I = 2


@dataclass
class WeightTable:
    """pred_weight_table (7.3.6.3); weights resolved to absolute values."""
    luma_log2_denom: int = 0
    chroma_log2_denom: int = 0
    # per ref idx: (flag, weight, offset); chroma: [(flag, [w_cb,w_cr],
    # [o_cb,o_cr])]
    luma_l0: list = field(default_factory=list)
    chroma_l0: list = field(default_factory=list)
    luma_l1: list = field(default_factory=list)
    chroma_l1: list = field(default_factory=list)

    def write(self, w: BitWriter, sh, chroma: bool) -> None:
        w.ue(self.luma_log2_denom)
        if chroma:
            w.se(self.chroma_log2_denom - self.luma_log2_denom)
        lists = [(self.luma_l0, self.chroma_l0,
                  sh.num_ref_idx_l0_active)]
        if sh.slice_type == SLICE_B:
            lists.append((self.luma_l1, self.chroma_l1,
                          sh.num_ref_idx_l1_active))
        for luma, chro, n in lists:
            for i in range(n):
                w.flag(luma[i][0])
            if chroma:
                for i in range(n):
                    w.flag(chro[i][0])
            for i in range(n):
                if luma[i][0]:
                    w.se(luma[i][1] - (1 << self.luma_log2_denom))
                    w.se(luma[i][2])
                if chroma and chro[i][0]:
                    for j in range(2):
                        w.se(chro[i][1][j] - (1 << self.chroma_log2_denom))
                        delta = (chro[i][2][j]
                                 + ((128 * chro[i][1][j])
                                    >> self.chroma_log2_denom) - 128)
                        w.se(delta)

    @classmethod
    def parse(cls, r: BitReader, sh, chroma: bool) -> "WeightTable":
        t = cls()
        t.luma_log2_denom = r.ue()
        t.chroma_log2_denom = t.luma_log2_denom
        if chroma:
            t.chroma_log2_denom = t.luma_log2_denom + r.se()
        lists = [("l0", sh.num_ref_idx_l0_active)]
        if sh.slice_type == SLICE_B:
            lists.append(("l1", sh.num_ref_idx_l1_active))
        for name, n in lists:
            lflags = [r.flag() for _ in range(n)]
            cflags = [r.flag() for _ in range(n)] if chroma else [0] * n
            luma, chro = [], []
            for i in range(n):
                if lflags[i]:
                    wgt = (1 << t.luma_log2_denom) + r.se()
                    off = r.se()
                else:
                    wgt, off = 1 << t.luma_log2_denom, 0
                luma.append((lflags[i], wgt, off))
                if chroma and cflags[i]:
                    ws, os_ = [], []
                    for _ in range(2):
                        cw = (1 << t.chroma_log2_denom) + r.se()
                        delta = r.se()
                        co = max(-128, min(127, delta
                                           - ((128 * cw)
                                              >> t.chroma_log2_denom)
                                           + 128))
                        ws.append(cw)
                        os_.append(co)
                    chro.append((1, ws, os_))
                else:
                    chro.append((0, [1 << t.chroma_log2_denom] * 2, [0, 0]))
            setattr(t, "luma_" + name, luma)
            setattr(t, "chroma_" + name, chro)
        return t


@dataclass
class SliceHeader:
    first_slice_in_pic: int = 1
    no_output_of_prior_pics: int = 0
    pps_id: int = 0
    dependent_slice_segment: int = 0
    segment_address: int = 0  # CTB raster address
    slice_type: int = SLICE_I
    pic_output_flag: int = 1
    pic_order_cnt_lsb: int = 0
    # RPS: either index into SPS list or explicit
    short_term_rps_sps_flag: int = 1
    short_term_rps_idx: int = 0
    explicit_rps: Optional[ShortTermRPS] = None
    slice_temporal_mvp_enabled: int = 0
    sao_luma: int = 0
    sao_chroma: int = 0
    num_ref_idx_active_override: int = 0
    num_ref_idx_l0_active: int = 1
    num_ref_idx_l1_active: int = 1
    mvd_l1_zero: int = 0
    cabac_init_flag: int = 0
    collocated_from_l0: int = 1
    collocated_ref_idx: int = 0
    five_minus_max_num_merge_cand: int = 0
    qp_delta: int = 0
    # long-term reference pictures (7.4.7.1): resolved entries
    # (poc_lsb, used_by_curr, msb_present, delta_poc_msb_cycle) — SPS-
    # indexed entries are resolved against the SPS lists at parse time
    lt_entries: List[tuple] = field(default_factory=list)
    # ref_pic_lists_modification (7.3.6.2): list_entry indices into the
    # temp list, or None when unmodified
    list_entry_l0: Optional[List[int]] = None
    list_entry_l1: Optional[List[int]] = None
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    cu_chroma_qp_offset_enabled: int = 0
    deblocking_filter_override: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset: int = 0
    tc_offset: int = 0
    loop_filter_across_slices: int = 0
    entry_point_offsets: List[int] = field(default_factory=list)
    weight_table: Optional["WeightTable"] = None
    # SHVC inter-layer prediction (F.7.3.6.1; reference: hevcdec.c:876-926)
    inter_layer_pred_enabled: int = 0
    active_num_ilr: int = 0
    inter_layer_pred_layer_idc: List[int] = field(default_factory=list)

    def max_num_merge_cand(self) -> int:
        return 5 - self.five_minus_max_num_merge_cand

    def cur_rps(self, sps):
        """The active short-term RPS of this slice."""
        if self.explicit_rps is not None:
            return self.explicit_rps
        return sps.st_rps[self.short_term_rps_idx]

    def num_pics_total_curr(self, sps) -> int:
        """NumPicsTotalCurr (7.4.7.2): used ST + used LT + inter-layer."""
        rps = self.cur_rps(sps)
        n = sum(rps.used_s0) + sum(rps.used_s1)
        n += sum(1 for e in self.lt_entries if e[1])
        n += self.active_num_ilr
        return n

    def _derive_ilr(self, vps, nuh_layer_id: int, temporal_id: int,
                    r: Optional[BitReader], w: Optional[BitWriter]) -> None:
        """Parse (r) or write (w) the slice-header inter-layer block and
        derive active_num_ilr / inter_layer_pred_layer_idc.  Mirrors the
        reference's hls_slice_header (hevcdec.c:876-926)."""
        self.active_num_ilr = 0
        self.inter_layer_pred_layer_idc = []
        if vps is None or vps.vps_ext is None or nuh_layer_id == 0:
            return
        ext = vps.vps_ext
        n_ilr = ext.num_direct_ref_layers[nuh_layer_id]
        lid_vps = ext.layer_id_in_vps[nuh_layer_id]

        def tid_ok(i):
            return ((ext.max_tid_il_ref_pics_plus1[i][lid_vps] > temporal_id
                     or temporal_id == 0)
                    and ext.sub_layers_vps_max_minus1[i] >= temporal_id)

        if not ext.default_ref_layers_active and n_ilr > 0:
            if r is not None:
                self.inter_layer_pred_enabled = r.flag()
            else:
                w.flag(self.inter_layer_pred_enabled)
            if not self.inter_layer_pred_enabled:
                return
            if n_ilr > 1:
                nbits = 1
                while (1 << nbits) < n_ilr:
                    nbits += 1
                if not ext.max_one_active_ref_layer:
                    if r is not None:
                        self.active_num_ilr = r.u(nbits) + 1
                    else:
                        w.u(self.active_num_ilr - 1, nbits)
                else:
                    self.active_num_ilr = 1 if any(
                        tid_ok(i) for i in range(n_ilr)) else 0
                if self.active_num_ilr == n_ilr:
                    self.inter_layer_pred_layer_idc = list(
                        range(self.active_num_ilr))
                else:
                    if r is not None:
                        self.inter_layer_pred_layer_idc = [
                            r.u(nbits) for _ in range(self.active_num_ilr)]
                    else:
                        for idc in self.inter_layer_pred_layer_idc:
                            w.u(idc, nbits)
            else:
                if tid_ok(0):
                    self.active_num_ilr = 1
                    self.inter_layer_pred_layer_idc = [0]
        elif ext.default_ref_layers_active:
            self.inter_layer_pred_enabled = 1
            idc = [i for i in range(n_ilr) if tid_ok(i)]
            self.active_num_ilr = len(idc)
            self.inter_layer_pred_layer_idc = idc

    def write_rbsp(self, sps: SPS, pps: PPS, nal_type: int,
                   data_payload: bytes, nuh_layer_id: int = 0,
                   vps=None, temporal_id: int = 0) -> bytes:
        """Serialize header followed by byte-aligned slice data."""
        w = BitWriter()
        w.flag(self.first_slice_in_pic)
        if is_irap_nal(nal_type):
            w.flag(self.no_output_of_prior_pics)
        w.ue(self.pps_id)
        if not self.first_slice_in_pic:
            if pps.dependent_slice_segments_enabled:
                w.flag(self.dependent_slice_segment)
            import math
            ctb_count = sps.ctb_w * sps.ctb_h
            nbits = max(1, math.ceil(math.log2(ctb_count)))
            w.u(self.segment_address, nbits)
        if not self.dependent_slice_segment:
            for _ in range(pps.num_extra_slice_header_bits):
                w.flag(0)
            w.ue(self.slice_type)
            if pps.output_flag_present:
                w.flag(self.pic_output_flag)
            # F.7.3.6.1: poc lsb is present for IDR too when
            # nuh_layer_id > 0 (reference: hevcdec.c:803-806)
            if nuh_layer_id > 0 or not is_idr_nal(nal_type):
                w.u(self.pic_order_cnt_lsb, sps.log2_max_poc_lsb)
            if not is_idr_nal(nal_type):
                if self.explicit_rps is not None:
                    w.flag(0)  # short_term_ref_pic_set_sps_flag
                    self.explicit_rps.write(w, len(sps.st_rps), len(sps.st_rps))
                else:
                    w.flag(1)
                    if len(sps.st_rps) > 1:
                        import math
                        nbits = math.ceil(math.log2(len(sps.st_rps)))
                        w.u(self.short_term_rps_idx, nbits)
                if sps.long_term_ref_pics_present:
                    if len(sps.lt_ref_pocs_sps) > 0:
                        w.ue(0)  # num_long_term_sps: all slice-coded
                    w.ue(len(self.lt_entries))
                    prev_cyc = 0
                    for i, (lsb, used, msb_present, cyc) in \
                            enumerate(self.lt_entries):
                        w.u(lsb, sps.log2_max_poc_lsb)
                        w.flag(used)
                        w.flag(msb_present)
                        if msb_present:
                            w.ue(cyc if i == 0 else cyc - prev_cyc)
                        prev_cyc = cyc
                if sps.temporal_mvp_enabled:
                    w.flag(self.slice_temporal_mvp_enabled)
            if nuh_layer_id > 0:
                self._derive_ilr(vps, nuh_layer_id, temporal_id, None, w)
            if sps.sao_enabled:
                w.flag(self.sao_luma)
                if sps.chroma_format_idc:
                    w.flag(self.sao_chroma)
            if self.slice_type != SLICE_I:
                override = (self.num_ref_idx_l0_active != pps.num_ref_idx_l0_default
                            or (self.slice_type == SLICE_B
                                and self.num_ref_idx_l1_active != pps.num_ref_idx_l1_default))
                w.flag(override)
                if override:
                    w.ue(self.num_ref_idx_l0_active - 1)
                    if self.slice_type == SLICE_B:
                        w.ue(self.num_ref_idx_l1_active - 1)
                nptc = self.num_pics_total_curr(sps)
                if pps.lists_modification_present and nptc > 1:
                    import math
                    nbits = math.ceil(math.log2(nptc))
                    w.flag(1 if self.list_entry_l0 else 0)
                    if self.list_entry_l0:
                        for e in self.list_entry_l0:
                            w.u(e, nbits)
                    if self.slice_type == SLICE_B:
                        w.flag(1 if self.list_entry_l1 else 0)
                        if self.list_entry_l1:
                            for e in self.list_entry_l1:
                                w.u(e, nbits)
                if self.slice_type == SLICE_B:
                    w.flag(self.mvd_l1_zero)
                if pps.cabac_init_present:
                    w.flag(self.cabac_init_flag)
                if self.slice_temporal_mvp_enabled:
                    if self.slice_type == SLICE_B:
                        w.flag(self.collocated_from_l0)
                    nref = (self.num_ref_idx_l0_active if self.collocated_from_l0
                            else self.num_ref_idx_l1_active)
                    if nref > 1:
                        w.ue(self.collocated_ref_idx)
                if ((pps.weighted_pred and self.slice_type == SLICE_P)
                        or (pps.weighted_bipred
                            and self.slice_type == SLICE_B)):
                    self.weight_table.write(w, self,
                                            sps.chroma_format_idc != 0)
                w.ue(self.five_minus_max_num_merge_cand)
            w.se(self.qp_delta)
            if pps.slice_chroma_qp_offsets_present:
                w.se(self.cb_qp_offset)
                w.se(self.cr_qp_offset)
            if pps.chroma_qp_offset_list_enabled:
                w.flag(self.cu_chroma_qp_offset_enabled)
            # effective disabled state mirrors the parser: the PPS
            # value unless this header carries an override
            eff_disabled = pps.deblocking_filter_disabled
            if pps.deblocking_filter_control_present:
                if pps.deblocking_filter_override_enabled:
                    w.flag(self.deblocking_filter_override)
                if self.deblocking_filter_override:
                    eff_disabled = self.deblocking_filter_disabled
                    w.flag(self.deblocking_filter_disabled)
                    if not self.deblocking_filter_disabled:
                        w.se(self.beta_offset // 2)
                        w.se(self.tc_offset // 2)
            if (pps.loop_filter_across_slices
                    and (self.sao_luma or self.sao_chroma
                         or not eff_disabled)):
                w.flag(self.loop_filter_across_slices)
        if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
            w.ue(len(self.entry_point_offsets))
            if self.entry_point_offsets:
                max_off = max(self.entry_point_offsets)
                nbits = max(1, max_off.bit_length())
                w.ue(nbits - 1)
                for off in self.entry_point_offsets:
                    w.u(off - 1, nbits)
        if pps.slice_header_extension_present:
            w.ue(0)
        # byte_alignment(): stop bit + zeros
        w.u(1, 1)
        w.align_zero()
        return w.getvalue() + data_payload

    @classmethod
    def parse(cls, r: BitReader, nal_type: int, sps_map, pps_map,
              nuh_layer_id: int = 0, vps_map=None,
              temporal_id: int = 0,
              prev_independent: "SliceHeader" = None) -> "SliceHeader":
        """Parse from a BitReader positioned at the header start.

        Leaves `r` positioned at the first byte of slice data (post
        byte_alignment). Needs sps_map/pps_map: dict id→PS.
        prev_independent: the picture's last independent segment header
        (dependent segments inherit everything but the address).
        """
        sh = cls()
        sh.first_slice_in_pic = r.flag()
        if is_irap_nal(nal_type):
            sh.no_output_of_prior_pics = r.flag()
        sh.pps_id = r.ue()
        pps = pps_map[sh.pps_id]
        sps = sps_map[pps.sps_id]
        sh.dependent_slice_segment = 0
        sh.segment_address = 0
        if not sh.first_slice_in_pic:
            if pps.dependent_slice_segments_enabled:
                sh.dependent_slice_segment = r.flag()
            import math
            ctb_count = sps.ctb_w * sps.ctb_h
            nbits = max(1, math.ceil(math.log2(ctb_count)))
            sh.segment_address = r.u(nbits)
        if not sh.dependent_slice_segment:
            for _ in range(pps.num_extra_slice_header_bits):
                r.flag()
            sh.slice_type = r.ue()
            if pps.output_flag_present:
                sh.pic_output_flag = r.flag()
            if sps.separate_colour_plane:
                r.u(2)
            if nuh_layer_id > 0 or not is_idr_nal(nal_type):
                sh.pic_order_cnt_lsb = r.u(sps.log2_max_poc_lsb)
            if not is_idr_nal(nal_type):
                sps_rps = r.flag()
                sh.short_term_rps_sps_flag = sps_rps
                if not sps_rps:
                    sh.explicit_rps = ShortTermRPS.parse(
                        r, len(sps.st_rps), sps.st_rps, len(sps.st_rps))
                elif len(sps.st_rps) > 1:
                    import math
                    nbits = math.ceil(math.log2(len(sps.st_rps)))
                    sh.short_term_rps_idx = r.u(nbits)
                if sps.long_term_ref_pics_present:
                    # 7.3.6.1 long-term RPS: SPS-indexed + slice-coded
                    # entries, resolved to (lsb, used, msb_present,
                    # DeltaPocMsbCycleLt)
                    import math
                    n_sps_lt = len(sps.lt_ref_pocs_sps)
                    num_lt_sps = r.ue() if n_sps_lt > 0 else 0
                    num_lt_pics = r.ue()
                    prev_cyc = 0
                    for i in range(num_lt_sps + num_lt_pics):
                        if i < num_lt_sps:
                            idx = 0
                            if n_sps_lt > 1:
                                idx = r.u(math.ceil(math.log2(n_sps_lt)))
                            lsb = sps.lt_ref_pocs_sps[idx]
                            used = sps.lt_used_sps[idx]
                        else:
                            lsb = r.u(sps.log2_max_poc_lsb)
                            used = r.flag()
                        msb_present = r.flag()
                        d = r.ue() if msb_present else 0
                        # DeltaPocMsbCycleLt accumulation (7.4.7.1)
                        cyc = d if (i == 0 or i == num_lt_sps) \
                            else d + prev_cyc
                        prev_cyc = cyc
                        sh.lt_entries.append((lsb, used, msb_present,
                                              cyc))
                    sh._num_lt_sps = num_lt_sps
                if sps.temporal_mvp_enabled:
                    sh.slice_temporal_mvp_enabled = r.flag()
            if nuh_layer_id > 0:
                vps = (vps_map or {}).get(sps.vps_id)
                sh._derive_ilr(vps, nuh_layer_id, temporal_id, r, None)
            if sps.sao_enabled:
                sh.sao_luma = r.flag()
                if sps.chroma_format_idc:
                    sh.sao_chroma = r.flag()
            if sh.slice_type in (SLICE_P, SLICE_B):
                sh.num_ref_idx_l0_active = pps.num_ref_idx_l0_default
                sh.num_ref_idx_l1_active = pps.num_ref_idx_l1_default
                if r.flag():
                    sh.num_ref_idx_active_override = 1
                    sh.num_ref_idx_l0_active = r.ue() + 1
                    if sh.slice_type == SLICE_B:
                        sh.num_ref_idx_l1_active = r.ue() + 1
                nptc = sh.num_pics_total_curr(sps)
                if pps.lists_modification_present and nptc > 1:
                    # ref_pic_lists_modification (7.3.6.2)
                    import math
                    nbits = math.ceil(math.log2(nptc))
                    if r.flag():
                        sh.list_entry_l0 = [
                            r.u(nbits)
                            for _ in range(sh.num_ref_idx_l0_active)]
                    if sh.slice_type == SLICE_B and r.flag():
                        sh.list_entry_l1 = [
                            r.u(nbits)
                            for _ in range(sh.num_ref_idx_l1_active)]
                if sh.slice_type == SLICE_B:
                    sh.mvd_l1_zero = r.flag()
                if pps.cabac_init_present:
                    sh.cabac_init_flag = r.flag()
                if sh.slice_temporal_mvp_enabled:
                    if sh.slice_type == SLICE_B:
                        sh.collocated_from_l0 = r.flag()
                    nref = (sh.num_ref_idx_l0_active if sh.collocated_from_l0
                            else sh.num_ref_idx_l1_active)
                    if nref > 1:
                        sh.collocated_ref_idx = r.ue()
                if ((pps.weighted_pred and sh.slice_type == SLICE_P)
                        or (pps.weighted_bipred
                            and sh.slice_type == SLICE_B)):
                    sh.weight_table = WeightTable.parse(
                        r, sh, sps.chroma_format_idc != 0)
                sh.five_minus_max_num_merge_cand = r.ue()
            sh.qp_delta = r.se()
            if pps.slice_chroma_qp_offsets_present:
                sh.cb_qp_offset = r.se()
                sh.cr_qp_offset = r.se()
            if pps.chroma_qp_offset_list_enabled:
                sh.cu_chroma_qp_offset_enabled = r.flag()
            sh.deblocking_filter_disabled = pps.deblocking_filter_disabled
            sh.beta_offset = pps.beta_offset
            sh.tc_offset = pps.tc_offset
            if pps.deblocking_filter_control_present:
                if pps.deblocking_filter_override_enabled:
                    sh.deblocking_filter_override = r.flag()
                if sh.deblocking_filter_override:
                    sh.deblocking_filter_disabled = r.flag()
                    if not sh.deblocking_filter_disabled:
                        sh.beta_offset = r.se() * 2
                        sh.tc_offset = r.se() * 2
            if (pps.loop_filter_across_slices
                    and (sh.sao_luma or sh.sao_chroma
                         or not sh.deblocking_filter_disabled)):
                sh.loop_filter_across_slices = r.flag()
            else:
                sh.loop_filter_across_slices = pps.loop_filter_across_slices
        else:
            # dependent slice segment (7.4.7.1): every field above is
            # inherited from the preceding independent segment's header
            # (reference: hevcdec.c:612 hls_slice_header dependent path)
            assert prev_independent is not None, \
                "dependent slice segment without an independent header"
            import copy
            inh = copy.copy(prev_independent)
            inh.first_slice_in_pic = 0
            inh.dependent_slice_segment = 1
            inh.segment_address = sh.segment_address
            inh.entry_point_offsets = []
            sh = inh
        if pps.tiles_enabled or pps.entropy_coding_sync_enabled:
            n = r.ue()
            if n:
                nbits = r.ue() + 1
                sh.entry_point_offsets = [r.u(nbits) + 1 for _ in range(n)]
        if pps.slice_header_extension_present:
            ext_len = r.ue()
            for _ in range(ext_len):
                r.u(8)
        # byte_alignment
        if r.u(1) != 1:
            raise ValueError("alignment_bit_equal_to_one != 1")
        r.align()
        return sh
