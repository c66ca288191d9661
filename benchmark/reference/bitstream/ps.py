"""Parameter sets: VPS / SPS / PPS parse + write (H.265 clause 7.3.2).

Capability parity with the reference's hevc_ps.c (ff_hevc_decode_nal_vps
:1405, _sps :2411, _pps :2923) and the derived PPS address maps built by
setup_pps (reference: libavcodec/hevc_ps.c:2525, hevc_ps.h:920-927).
Re-implemented from the specification; both directions (parse for the
decoder, write for the conformance-stream generator) share one dataclass
per parameter set.

Frozen copy of ``hevc_tpu_torch/bitstream/ps.py`` at ee5ffe9.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .bits import BitReader, BitWriter


# ---------------------------------------------------------------------------
# profile_tier_level (7.3.3)
# ---------------------------------------------------------------------------

@dataclass
class ProfileTierLevel:
    profile_space: int = 0
    tier_flag: int = 0
    profile_idc: int = 1  # 1=Main, 2=Main10, 4=RExt
    compat_flags: int = 1 << (31 - 1)  # bit for profile 1 (MSB-first bit array)
    progressive_source: int = 1
    interlaced_source: int = 0
    non_packed_constraint: int = 0
    frame_only_constraint: int = 1
    level_idc: int = 63  # level 2.1 = 63; 4K needs higher

    def write(self, w: BitWriter, max_sub_layers: int = 1,
              profile_present: bool = True) -> None:
        if profile_present:
            w.u(self.profile_space, 2)
            w.u(self.tier_flag, 1)
            w.u(self.profile_idc, 5)
            w.u(self.compat_flags, 32)
            w.u(self.progressive_source, 1)
            w.u(self.interlaced_source, 1)
            w.u(self.non_packed_constraint, 1)
            w.u(self.frame_only_constraint, 1)
            w.u(0, 32)  # reserved_zero_44bits
            w.u(0, 12)
        w.u(self.level_idc, 8)
        for _ in range(max_sub_layers - 1):
            w.u(0, 2)  # sub_layer profile/level present flags
        if max_sub_layers > 1:
            for _ in range(max_sub_layers - 1, 8):
                w.u(0, 2)  # reserved_zero_2bits

    @classmethod
    def parse(cls, r: BitReader, max_sub_layers: int = 1,
              profile_present: bool = True) -> "ProfileTierLevel":
        p = cls()
        if profile_present:
            p.profile_space = r.u(2)
            p.tier_flag = r.u(1)
            p.profile_idc = r.u(5)
            p.compat_flags = r.u(32)
            p.progressive_source = r.u(1)
            p.interlaced_source = r.u(1)
            p.non_packed_constraint = r.u(1)
            p.frame_only_constraint = r.u(1)
            r.u(32)
            r.u(12)
        p.level_idc = r.u(8)
        sub_profile = []
        sub_level = []
        for _ in range(max_sub_layers - 1):
            sub_profile.append(r.u(1))
            sub_level.append(r.u(1))
        if max_sub_layers > 1:
            for _ in range(max_sub_layers - 1, 8):
                r.u(2)
        for i in range(max_sub_layers - 1):
            if sub_profile[i]:
                r.u(32); r.u(32)  # 88 bits sub-layer profile
                r.u(24)
            if sub_level[i]:
                r.u(8)
        return p


# ---------------------------------------------------------------------------
# short-term reference picture set (7.3.7) — needed for inter streams
# ---------------------------------------------------------------------------

@dataclass
class ShortTermRPS:
    """Explicit (non-predicted) short-term RPS."""
    delta_poc_s0: List[int] = field(default_factory=list)  # negative deltas, ordered closest-first (values < 0)
    used_s0: List[int] = field(default_factory=list)
    delta_poc_s1: List[int] = field(default_factory=list)  # positive deltas
    used_s1: List[int] = field(default_factory=list)

    @property
    def num_negative(self) -> int:
        return len(self.delta_poc_s0)

    @property
    def num_positive(self) -> int:
        return len(self.delta_poc_s1)

    @property
    def num_delta_pocs(self) -> int:
        return self.num_negative + self.num_positive

    def write(self, w: BitWriter, idx: int, num_rps_total: int) -> None:
        if idx > 0:
            w.flag(0)  # inter_ref_pic_set_prediction_flag — always explicit
        w.ue(self.num_negative)
        w.ue(self.num_positive)
        prev = 0
        for i in range(self.num_negative):
            d = self.delta_poc_s0[i]
            w.ue(prev - d - 1)  # delta_poc_s0_minus1
            prev = d
            w.flag(self.used_s0[i])
        prev = 0
        for i in range(self.num_positive):
            d = self.delta_poc_s1[i]
            w.ue(d - prev - 1)
            prev = d
            w.flag(self.used_s1[i])

    @classmethod
    def parse(cls, r: BitReader, idx: int, rps_list: List["ShortTermRPS"],
              num_rps_total: int) -> "ShortTermRPS":
        rps = cls()
        pred = r.flag() if idx > 0 else 0
        if pred:
            # predicted from previous RPS (7-59..7-71)
            if idx == num_rps_total:  # slice-header RPS may pick any
                delta_idx = r.ue() + 1
            else:
                delta_idx = 1
            ref = rps_list[idx - delta_idx]
            delta_rps_sign = r.flag()
            abs_delta_rps = r.ue() + 1
            delta_rps = (1 - 2 * delta_rps_sign) * abs_delta_rps
            nref = ref.num_delta_pocs
            use_flags = []
            for j in range(nref + 1):
                used_by_curr = r.flag()
                use_delta = 1
                if not used_by_curr:
                    use_delta = r.flag()
                use_flags.append((used_by_curr, use_delta))
            ref_all = ([(d, u) for d, u in zip(ref.delta_poc_s0, ref.used_s0)]
                       + [(d, u) for d, u in zip(ref.delta_poc_s1, ref.used_s1)])
            # derive S0
            s0, u0, s1, u1 = [], [], [], []
            # i from num_positive-1 downto 0 over ref S1, then delta_rps itself
            for j in range(ref.num_positive - 1, -1, -1):
                d = ref.delta_poc_s1[j] + delta_rps
                k = ref.num_negative + j
                if d < 0 and use_flags[k][1]:
                    s0.append(d); u0.append(use_flags[k][0])
            if delta_rps < 0 and use_flags[nref][1]:
                s0.append(delta_rps); u0.append(use_flags[nref][0])
            for j in range(ref.num_negative):
                d = ref.delta_poc_s0[j] + delta_rps
                if d < 0 and use_flags[j][1]:
                    s0.append(d); u0.append(use_flags[j][0])
            for j in range(ref.num_negative - 1, -1, -1):
                d = ref.delta_poc_s0[j] + delta_rps
                if d > 0 and use_flags[j][1]:
                    s1.append(d); u1.append(use_flags[j][0])
            if delta_rps > 0 and use_flags[nref][1]:
                s1.append(delta_rps); u1.append(use_flags[nref][0])
            for j in range(ref.num_positive):
                d = ref.delta_poc_s1[j] + delta_rps
                k = ref.num_negative + j
                if d > 0 and use_flags[k][1]:
                    s1.append(d); u1.append(use_flags[k][0])
            rps.delta_poc_s0, rps.used_s0 = s0, u0
            rps.delta_poc_s1, rps.used_s1 = s1, u1
            return rps
        nneg = r.ue()
        npos = r.ue()
        prev = 0
        for _ in range(nneg):
            prev = prev - (r.ue() + 1)
            rps.delta_poc_s0.append(prev)
            rps.used_s0.append(r.flag())
        prev = 0
        for _ in range(npos):
            prev = prev + r.ue() + 1
            rps.delta_poc_s1.append(prev)
            rps.used_s1.append(r.flag())
        return rps


# ---------------------------------------------------------------------------
# SHVC rep_format / vps_extension (F.7.3.2.1)
# ---------------------------------------------------------------------------

@dataclass
class RepFormat:
    """rep_format() (F.7.3.2.1.2; reference: hevc_ps.c:514
    parse_rep_format, struct hevc_ps.h:321-336)."""
    width: int = 0
    height: int = 0
    chroma_and_bd_present: int = 1
    chroma_format_idc: int = 1
    separate_colour_plane: int = 0
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    conf_win: tuple = (0, 0, 0, 0)

    def write(self, w: BitWriter) -> None:
        w.u(self.width, 16)
        w.u(self.height, 16)
        w.flag(self.chroma_and_bd_present)
        if self.chroma_and_bd_present:
            w.u(self.chroma_format_idc, 2)
            if self.chroma_format_idc == 3:
                w.flag(self.separate_colour_plane)
            w.u(self.bit_depth_luma - 8, 4)
            w.u(self.bit_depth_chroma - 8, 4)
        has_win = any(self.conf_win)
        w.flag(has_win)
        if has_win:
            for v in self.conf_win:
                w.ue(v)

    @classmethod
    def parse(cls, r: BitReader) -> "RepFormat":
        f = cls()
        f.width = r.u(16)
        f.height = r.u(16)
        f.chroma_and_bd_present = r.flag()
        if f.chroma_and_bd_present:
            f.chroma_format_idc = r.u(2)
            if f.chroma_format_idc == 3:
                f.separate_colour_plane = r.flag()
            f.bit_depth_luma = r.u(4) + 8
            f.bit_depth_chroma = r.u(4) + 8
        if r.flag():
            f.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
        return f


@dataclass
class VPSExt:
    """SHVC vps_extension() — the subset exercised by 2..N-layer scalable
    streams with one scalability dimension (reference: hevc_ps.c:706
    parse_vps_extension; struct hevc_ps.h:509-562).

    The parser walks the full general syntax (within MAX_LAYERS=8);
    the writer emits the canonical configuration our encoder produces."""
    splitting_flag: int = 0
    scalability_mask: List[int] = field(
        default_factory=lambda: [0, 0, 1] + [0] * 13)
    dimension_id_len: List[int] = field(default_factory=lambda: [1])
    nuh_layer_id_present: int = 0
    layer_id_in_nuh: List[int] = field(default_factory=lambda: [0, 1])
    dimension_id: List[List[int]] = field(default_factory=lambda: [[0], [1]])
    view_id_len: int = 0
    view_id_val: List[int] = field(default_factory=lambda: [0] * 64)
    # direct_dependency_flag[i][j]: layer i (vps order) depends on layer j
    direct_dependency_flag: List[List[int]] = field(default_factory=list)
    sub_layers_vps_max_minus1: List[int] = field(default_factory=list)
    max_tid_il_ref_pics_plus1: Optional[List[List[int]]] = None
    default_ref_layers_active: int = 1
    num_ptl: int = 1  # vps_num_profile_tier_level_minus1 + 1
    num_add_olss: int = 0
    default_output_layer_idc: int = 0
    rep_formats: List[RepFormat] = field(default_factory=list)
    rep_format_idx: List[int] = field(default_factory=list)  # per layer
    max_one_active_ref_layer: int = 1
    poc_lsb_aligned: int = 0
    # dpb_size() for OLS 1..: per-layer max_vps_dec_pic_buffering_minus1
    dpb_max_dec_pic_buffering: List[int] = field(
        default_factory=lambda: [5, 5])
    direct_dep_type_len: int = 2
    direct_dep_all_type: int = 2  # sample + motion inter-layer prediction
    # ---- derived ----
    num_direct_ref_layers: List[int] = field(default_factory=list)
    ref_layer_id: List[List[int]] = field(default_factory=list)

    def derive(self, max_layers: int) -> "VPSExt":
        n = max_layers
        if not self.direct_dependency_flag:
            self.direct_dependency_flag = [
                [1 if j == i - 1 else 0 for j in range(n)] for i in range(n)]
        if not self.sub_layers_vps_max_minus1:
            self.sub_layers_vps_max_minus1 = [0] * n
        if self.max_tid_il_ref_pics_plus1 is None:
            self.max_tid_il_ref_pics_plus1 = [[7] * n for _ in range(n)]
        if len(self.layer_id_in_nuh) < n:
            self.layer_id_in_nuh = list(range(n))
        # NumDirectRefLayers / IdDirectRefLayer keyed by nuh_layer_id
        max_id = max(self.layer_id_in_nuh) + 1
        self.num_direct_ref_layers = [0] * max(max_id, n)
        self.ref_layer_id = [[] for _ in range(max(max_id, n))]
        layer_id_in_vps = {lid: i for i, lid in
                           enumerate(self.layer_id_in_nuh[:n])}
        self.layer_id_in_vps = layer_id_in_vps
        for i in range(n):
            lid = self.layer_id_in_nuh[i]
            for j in range(i):
                if self.direct_dependency_flag[i][j]:
                    self.ref_layer_id[lid].append(self.layer_id_in_nuh[j])
            self.num_direct_ref_layers[lid] = len(self.ref_layer_id[lid])
        if not self.rep_format_idx:
            self.rep_format_idx = [
                min(i, len(self.rep_formats) - 1) if self.rep_formats else 0
                for i in range(max(max_id, n))]
        return self

    def rep_format_of(self, nuh_layer_id: int) -> RepFormat:
        return self.rep_formats[self.rep_format_idx[nuh_layer_id]]


# ---------------------------------------------------------------------------
# VPS (7.3.2.1)
# ---------------------------------------------------------------------------

@dataclass
class VPS:
    vps_id: int = 0
    base_layer_internal: int = 1
    base_layer_available: int = 1
    max_layers: int = 1
    max_sub_layers: int = 1
    temporal_id_nesting: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    max_dec_pic_buffering: List[int] = field(default_factory=lambda: [5])
    num_reorder_pics: List[int] = field(default_factory=lambda: [0])
    max_latency_increase: List[int] = field(default_factory=lambda: [0])
    max_layer_id: int = 0
    # layer_id_included_flag[i][j] for layer set i (set 0 implicit = {0})
    layer_id_included: List[List[int]] = field(default_factory=list)
    vps_ext: Optional[VPSExt] = None

    @property
    def num_layer_sets(self) -> int:
        return 1 + len(self.layer_id_included)

    def write_rbsp(self) -> bytes:
        w = BitWriter()
        w.u(self.vps_id, 4)
        w.u(self.base_layer_internal, 1)
        w.u(self.base_layer_available, 1)
        w.u(self.max_layers - 1, 6)
        w.u(self.max_sub_layers - 1, 3)
        w.u(self.temporal_id_nesting, 1)
        w.u(0xFFFF, 16)  # vps_reserved_0xffff_16bits
        self.ptl.write(w, self.max_sub_layers)
        w.flag(1)  # vps_sub_layer_ordering_info_present_flag
        for i in range(self.max_sub_layers):
            w.ue(self.max_dec_pic_buffering[i] - 1)
            w.ue(self.num_reorder_pics[i])
            w.ue(self.max_latency_increase[i])
        w.u(self.max_layer_id, 6)
        w.ue(self.num_layer_sets - 1)
        for incl in self.layer_id_included:
            for j in range(self.max_layer_id + 1):
                w.flag(incl[j] if j < len(incl) else 0)
        w.flag(0)  # vps_timing_info_present_flag
        if self.vps_ext is not None:
            w.flag(1)  # vps_extension_flag
            w.align_zero_one()  # vps_extension_alignment_bit_equal_to_one
            self._write_extension(w)
        else:
            w.flag(0)
        w.rbsp_trailing_bits()
        return w.getvalue()

    def _write_extension(self, w: BitWriter) -> None:
        """Canonical SHVC vps_extension writer (one scalability dim,
        chain dependency, one OLS per layer set)."""
        e = self.vps_ext.derive(self.max_layers)
        n = self.max_layers
        if n > 1 and self.base_layer_internal:
            self.ptl.write(w, self.max_sub_layers, profile_present=False)
        w.flag(e.splitting_flag)
        assert not e.splitting_flag, "splitting_flag writer not needed"
        for m in e.scalability_mask:
            w.flag(m)
        nst = sum(e.scalability_mask)
        for j in range(nst):
            w.u(e.dimension_id_len[j] - 1, 3)
        w.flag(e.nuh_layer_id_present)
        for i in range(1, n):
            if e.nuh_layer_id_present:
                w.u(e.layer_id_in_nuh[i], 6)
            for j in range(nst):
                w.u(e.dimension_id[i][j], e.dimension_id_len[j])
        w.u(e.view_id_len, 4)
        assert e.view_id_len == 0, "view_id writer not needed"
        for i in range(1, n):
            for j in range(i):
                w.flag(e.direct_dependency_flag[i][j])
        # chain dependency ⇒ NumIndependentLayers == 1 ⇒ no add layer sets
        w.flag(0)  # vps_sub_layers_max_minus1_present_flag
        w.flag(0)  # max_tid_ref_present_flag
        w.flag(e.default_ref_layers_active)
        w.ue(e.num_ptl - 1)
        assert e.num_ptl <= 2, "extra PTL writer not needed"
        if self.base_layer_internal and e.num_ptl > 2:
            pass  # unreachable
        if self.num_layer_sets > 1:
            w.ue(e.num_add_olss)
            assert e.num_add_olss == 0
            w.u(e.default_output_layer_idc, 2)
        # per-OLS output flags / ptl idx / alt flag: none for idc==0,
        # num_ptl<=1, one OLS per layer set
        assert e.default_output_layer_idc == 0
        w.ue(len(e.rep_formats) - 1)
        for f in e.rep_formats:
            f.write(w)
        if len(e.rep_formats) > 1:
            w.flag(0)  # rep_format_idx_present_flag (infer min(i, n-1))
        w.flag(e.max_one_active_ref_layer)
        w.flag(e.poc_lsb_aligned)
        for i in range(1, n):
            if e.num_direct_ref_layers[e.layer_id_in_nuh[i]] == 0:
                w.flag(0)  # poc_lsb_not_present_flag
        # dpb_size(): one OLS per layer set, layer set i = layers 0..i
        for ols in range(1, self.num_layer_sets):
            w.flag(0)  # sub_layer_flag_info_present_flag
            # j == 0 only (sub_layer_dpb_info inferred present)
            n_in_ls = sum(self.layer_id_included[ols - 1]) \
                if ols - 1 < len(self.layer_id_included) else ols + 1
            for k in range(n_in_ls):
                w.ue(e.dpb_max_dec_pic_buffering[k] - 1)
            w.ue(0)  # max_vps_num_reorder_pics
            w.ue(0)  # max_vps_latency_increase_plus1
        w.ue(e.direct_dep_type_len - 2)
        w.flag(1)  # direct_dependency_all_layers_flag
        w.u(e.direct_dep_all_type, e.direct_dep_type_len)
        w.ue(0)  # vps_non_vui_extension_length
        w.flag(0)  # vps_vui_present_flag

    @classmethod
    def parse_rbsp(cls, rbsp: bytes) -> "VPS":
        r = BitReader(rbsp)
        v = cls()
        v.vps_id = r.u(4)
        v.base_layer_internal = r.u(1)
        v.base_layer_available = r.u(1)
        v.max_layers = r.u(6) + 1
        v.max_sub_layers = r.u(3) + 1
        v.temporal_id_nesting = r.u(1)
        r.u(16)
        v.ptl = ProfileTierLevel.parse(r, v.max_sub_layers)
        sub_layer_ordering = r.flag()
        start = 0 if sub_layer_ordering else v.max_sub_layers - 1
        v.max_dec_pic_buffering = [0] * v.max_sub_layers
        v.num_reorder_pics = [0] * v.max_sub_layers
        v.max_latency_increase = [0] * v.max_sub_layers
        for i in range(start, v.max_sub_layers):
            v.max_dec_pic_buffering[i] = r.ue() + 1
            v.num_reorder_pics[i] = r.ue()
            v.max_latency_increase[i] = r.ue()
        v.max_layer_id = r.u(6)
        num_layer_sets = r.ue() + 1
        v.layer_id_included = []
        for _ in range(1, num_layer_sets):
            v.layer_id_included.append(
                [r.flag() for _ in range(v.max_layer_id + 1)])
        if r.flag():  # vps_timing_info_present_flag
            r.u(32); r.u(32)
            if r.flag():
                r.ue()
            for i in range(r.ue()):  # vps_num_hrd_parameters
                r.ue()  # hrd_layer_set_idx
                cprms = r.flag() if i > 0 else 1
                skip_hrd_parameters(r, bool(cprms), v.max_sub_layers)
        if r.flag():  # vps_extension_flag
            r.align()
            v.vps_ext = cls._parse_extension(r, v)
        return v

    @classmethod
    def _parse_extension(cls, r: BitReader, v: "VPS") -> VPSExt:
        """Parse vps_extension() (reference: hevc_ps.c:706)."""
        e = VPSExt()
        n = v.max_layers
        if n > 1 and v.base_layer_internal:
            ProfileTierLevel.parse(r, v.max_sub_layers,
                                   profile_present=False)
        e.splitting_flag = r.flag()
        e.scalability_mask = [r.flag() for _ in range(16)]
        nst = sum(e.scalability_mask)
        e.dimension_id_len = [r.u(3) + 1
                              for _ in range(nst - e.splitting_flag)]
        if e.splitting_flag:
            offs = [0] * (nst + 1)
            for j in range(1, nst):
                offs[j] = sum(e.dimension_id_len[:j])
            e.dimension_id_len.append(6 - offs[nst - 1])
        e.nuh_layer_id_present = r.flag()
        e.layer_id_in_nuh = [0] * n
        e.dimension_id = [[0] * nst for _ in range(n)]
        for i in range(1, n):
            e.layer_id_in_nuh[i] = r.u(6) if e.nuh_layer_id_present else i
            if not e.splitting_flag:
                for j in range(nst):
                    e.dimension_id[i][j] = r.u(e.dimension_id_len[j])
        # NumViews (only used to size view_id_val)
        num_views = 1
        view_order = {0: 0}
        for i in range(1, n):
            scal_view = 0
            j = 0
            for sm in range(16):
                if e.scalability_mask[sm]:
                    if sm == 1:
                        scal_view = e.dimension_id[i][j]
                    j += 1
            if scal_view not in view_order.values():
                num_views += 1
            view_order[e.layer_id_in_nuh[i]] = scal_view
        e.view_id_len = r.u(4)
        if e.view_id_len:
            for i in range(num_views):
                e.view_id_val[i] = r.u(e.view_id_len)
        e.direct_dependency_flag = [[0] * n for _ in range(n)]
        for i in range(1, n):
            for j in range(i):
                e.direct_dependency_flag[i][j] = r.flag()
        e.derive(n)
        # NumIndependentLayers (layers with no direct refs)
        n_indep = sum(1 for i in range(n)
                      if e.num_direct_ref_layers[e.layer_id_in_nuh[i]] == 0)
        num_add_layer_sets = 0
        add_lsets = []
        if n_indep > 1:
            num_add_layer_sets = r.ue()
            # F.7.3.2.1.1 additional layer sets: per set, the highest
            # included layer index of every independent-layer subtree
            # (TreePartitionList); the set is the union of those trees
            # up to the signalled index (ref hevc_ps.c
            # parse_vps_extension; previously a NotImplementedError)
            indep = [i for i in range(n)
                     if e.num_direct_ref_layers[e.layer_id_in_nuh[i]]
                     == 0]
            trees = []
            for root in indep:
                tree = {root}
                grew = True
                while grew:
                    grew = False
                    for k in range(n):
                        if k not in tree and any(
                                e.direct_dependency_flag[k][m]
                                for m in tree if m < k):
                            tree.add(k)
                            grew = True
                trees.append(sorted(tree))
            for _a in range(num_add_layer_sets):
                members = list(trees[0])  # tree partition 0: all layers
                for j in range(1, n_indep):
                    # u(v), v = ceil(log2(NumLayersInTreePartition[j]+1))
                    nbits = max(1, (len(trees[j])).bit_length())
                    hi = r.u(nbits)  # highest_layer_idx_plus1[a][j]
                    members += trees[j][:hi]
                add_lsets.append(sorted(
                    e.layer_id_in_nuh[m] for m in members))
        num_layer_sets = v.num_layer_sets + num_add_layer_sets
        e.add_layer_sets = add_lsets
        if r.flag():  # vps_sub_layers_max_minus1_present_flag
            e.sub_layers_vps_max_minus1 = [r.u(3) for _ in range(n)]
        else:
            e.sub_layers_vps_max_minus1 = [v.max_sub_layers - 1] * n
        # MaxSubLayersInLayerSet per layer set
        lsets = [[0]] + [
            [m for m in range(v.max_layer_id + 1) if incl[m]]
            for incl in v.layer_id_included] + add_lsets
        max_sl_in_ls = []
        for ls in lsets:
            msl = 0
            for lid in ls:
                msl = max(msl,
                          e.sub_layers_vps_max_minus1[e.layer_id_in_vps[lid]])
            max_sl_in_ls.append(msl + 1)
        if r.flag():  # max_tid_ref_present_flag
            for i in range(n - 1):
                for j in range(i + 1, n):
                    if e.direct_dependency_flag[j][i]:
                        e.max_tid_il_ref_pics_plus1[i][j] = r.u(3)
        e.default_ref_layers_active = r.flag()
        e.num_ptl = r.ue() + 1
        for i in range(2 if v.base_layer_internal else 1, e.num_ptl):
            pp = r.flag()  # vps_profile_present_flag
            ProfileTierLevel.parse(r, v.max_sub_layers, profile_present=pp)
        if num_layer_sets > 1:
            e.num_add_olss = r.ue()
            e.default_output_layer_idc = min(2, r.u(2))
        num_ols = num_layer_sets + e.num_add_olss
        import math
        output_layer_flag = {}
        for i in range(1, num_ols):
            if num_layer_sets > 2 and i >= num_layer_sets:
                nb = max(1, math.ceil(math.log2(num_layer_sets - 1)))
                ls_idx = r.u(nb) + 1
            else:
                ls_idx = i
            nl = len(lsets[ls_idx])
            if i > v.num_layer_sets - 1 or e.default_output_layer_idc == 2:
                flags = [r.flag() for _ in range(nl)]
            elif e.default_output_layer_idc == 0:
                flags = [1] * nl
            else:
                mx = max(max(ls) for ls in lsets)
                flags = [1 if lsets[ls_idx][j] == mx else 0
                         for j in range(nl)]
            output_layer_flag[i] = (ls_idx, flags)
            necessary = list(flags)
            for j in range(nl):
                if flags[j]:
                    for k in range(j):
                        if e.direct_dependency_flag[
                                e.layer_id_in_vps[lsets[ls_idx][j]]][
                                e.layer_id_in_vps[lsets[ls_idx][k]]]:
                            necessary[k] = 1
            if e.num_ptl > 1:
                nb = max(1, math.ceil(math.log2(e.num_ptl)))
                for j in range(nl):
                    if necessary[j]:
                        r.u(nb)  # profile_tier_level_idx
            n_out = sum(flags)
            highest = max((lsets[ls_idx][j] for j in range(nl) if flags[j]),
                          default=0)
            if n_out == 1 and e.num_direct_ref_layers[highest] > 0:
                r.flag()  # alt_output_layer_flag
        n_rep = r.ue() + 1
        e.rep_formats = [RepFormat.parse(r) for _ in range(n_rep)]
        rep_idx_present = r.flag() if n_rep > 1 else 0
        e.rep_format_idx = [min(i, n_rep - 1) for i in range(64)]
        if rep_idx_present:
            nb = max(1, math.ceil(math.log2(n_rep)))
            for i in range(1 if v.base_layer_internal else 0, n):
                e.rep_format_idx[e.layer_id_in_nuh[i]] = r.u(nb)
        else:
            for i in range(1 if v.base_layer_internal else 0, n):
                e.rep_format_idx[e.layer_id_in_nuh[i]] = min(i, n_rep - 1)
        e.max_one_active_ref_layer = r.flag()
        e.poc_lsb_aligned = r.flag()
        for i in range(1, n):
            if e.num_direct_ref_layers[e.layer_id_in_nuh[i]] == 0:
                r.flag()  # poc_lsb_not_present_flag
        # dpb_size()
        for i in range(1, num_ols):
            ls_idx = output_layer_flag[i][0] if i in output_layer_flag else i
            sub_info = r.flag()
            _, flags = output_layer_flag[i]
            necessary = list(flags)
            nl = len(lsets[ls_idx])
            for j in range(nl):
                if flags[j]:
                    for k in range(j):
                        if e.direct_dependency_flag[
                                e.layer_id_in_vps[lsets[ls_idx][j]]][
                                e.layer_id_in_vps[lsets[ls_idx][k]]]:
                            necessary[k] = 1
            for j in range(max_sl_in_ls[ls_idx]):
                present = 1 if j == 0 else (r.flag() if sub_info else 0)
                if present:
                    for k in range(nl):
                        if necessary[k] and (v.base_layer_internal
                                             or lsets[ls_idx][k]):
                            r.ue()  # max_vps_dec_pic_buffering_minus1
                    r.ue()  # max_vps_num_reorder_pics
                    r.ue()  # max_vps_latency_increase_plus1
        e.direct_dep_type_len = r.ue() + 2
        if r.flag():  # direct_dependency_all_layers_flag
            e.direct_dep_all_type = r.u(e.direct_dep_type_len)
        else:
            for i in range(1 if v.base_layer_internal else 2, n):
                for j in range(0 if v.base_layer_internal else 1, i):
                    if e.direct_dependency_flag[i][j]:
                        r.u(e.direct_dep_type_len)
        non_vui_len = r.ue()
        for _ in range(non_vui_len):
            r.u(8)
        if r.flag():  # vps_vui_present_flag
            pass  # vps_vui ignored (trailing data)
        return e


# ---------------------------------------------------------------------------
# SPS (7.3.2.2)
# ---------------------------------------------------------------------------

@dataclass
class SPS:
    sps_id: int = 0
    vps_id: int = 0
    max_sub_layers: int = 1
    temporal_id_nesting: int = 1
    ptl: ProfileTierLevel = field(default_factory=ProfileTierLevel)
    chroma_format_idc: int = 1  # 1=4:2:0, 2=4:2:2, 3=4:4:4
    separate_colour_plane: int = 0
    width: int = 0  # pic_width_in_luma_samples
    height: int = 0
    conf_win: tuple = (0, 0, 0, 0)  # left, right, top, bottom (in chroma units)
    bit_depth_luma: int = 8
    bit_depth_chroma: int = 8
    log2_max_poc_lsb: int = 8
    max_dec_pic_buffering: List[int] = field(default_factory=lambda: [5])
    num_reorder_pics: List[int] = field(default_factory=lambda: [0])
    max_latency_increase: List[int] = field(default_factory=lambda: [0])
    log2_min_cb_size: int = 3  # log2_min_luma_coding_block_size
    log2_ctb_size: int = 6  # min_cb + diff
    log2_min_tb_size: int = 2
    log2_max_tb_size: int = 5
    max_transform_hierarchy_depth_inter: int = 0
    max_transform_hierarchy_depth_intra: int = 0
    scaling_list_enabled: int = 0
    # parsed/authored scaling_list_data (coding/scaling.py); None with
    # scaling_list_enabled means the default matrices
    scaling_list: object = None
    amp_enabled: int = 0
    sao_enabled: int = 0
    pcm_enabled: int = 0
    pcm_bit_depth_luma: int = 8
    pcm_bit_depth_chroma: int = 8
    log2_min_pcm_cb_size: int = 3
    log2_max_pcm_cb_size: int = 3
    pcm_loop_filter_disabled: int = 0
    st_rps: List[ShortTermRPS] = field(default_factory=list)
    long_term_ref_pics_present: int = 0
    # SPS-level long-term candidates (lt_ref_pic_poc_lsb_sps /
    # used_by_curr_pic_lt_sps_flag, 7.4.3.2.1)
    lt_ref_pocs_sps: List[int] = field(default_factory=list)
    lt_used_sps: List[int] = field(default_factory=list)
    temporal_mvp_enabled: int = 0
    strong_intra_smoothing: int = 0
    # range extension
    range_ext: int = 0
    transform_skip_rotation: int = 0
    transform_skip_context: int = 0
    implicit_rdpcm: int = 0
    explicit_rdpcm: int = 0
    extended_precision: int = 0
    intra_smoothing_disabled: int = 0
    high_precision_offsets: int = 0
    persistent_rice_adaptation: int = 0
    cabac_bypass_alignment: int = 0
    # SHVC (F.7.3.2.2): multi-layer extension SPS state
    nuh_layer_id: int = 0
    is_multi_layer_ext: int = 0
    update_rep_format: int = 0
    sps_rep_format_idx: int = 0

    # ---- derived (computed on finalize/parse) ----
    def derive(self):
        self.ctb_size = 1 << self.log2_ctb_size
        self.ctb_w = -(-self.width // self.ctb_size)
        self.ctb_h = -(-self.height // self.ctb_size)
        self.min_cb_size = 1 << self.log2_min_cb_size
        self.min_cb_w = self.width // self.min_cb_size
        self.min_cb_h = self.height // self.min_cb_size
        self.min_tb_w = self.width // (1 << self.log2_min_tb_size)
        self.min_tb_h = self.height // (1 << self.log2_min_tb_size)
        self.log2_diff_ctb_min_tb = self.log2_ctb_size - self.log2_min_tb_size
        self.qp_bd_offset = 6 * (self.bit_depth_luma - 8)
        if self.chroma_format_idc == 1:
            self.sub_w, self.sub_h = 2, 2
        elif self.chroma_format_idc == 2:
            self.sub_w, self.sub_h = 2, 1
        else:
            self.sub_w, self.sub_h = 1, 1
        self.max_poc_lsb = 1 << self.log2_max_poc_lsb
        return self

    def write_rbsp(self) -> bytes:
        w = BitWriter()
        w.u(self.vps_id, 4)
        w.u(self.max_sub_layers - 1, 3)
        w.u(self.temporal_id_nesting, 1)
        self.ptl.write(w, self.max_sub_layers)
        w.ue(self.sps_id)
        w.ue(self.chroma_format_idc)
        if self.chroma_format_idc == 3:
            w.flag(self.separate_colour_plane)
        w.ue(self.width)
        w.ue(self.height)
        has_win = any(self.conf_win)
        w.flag(has_win)
        if has_win:
            for v in self.conf_win:
                w.ue(v)
        w.ue(self.bit_depth_luma - 8)
        w.ue(self.bit_depth_chroma - 8)
        w.ue(self.log2_max_poc_lsb - 4)
        w.flag(1)  # sps_sub_layer_ordering_info_present_flag
        for i in range(self.max_sub_layers):
            w.ue(self.max_dec_pic_buffering[i] - 1)
            w.ue(self.num_reorder_pics[i])
            w.ue(self.max_latency_increase[i])
        w.ue(self.log2_min_cb_size - 3)
        w.ue(self.log2_ctb_size - self.log2_min_cb_size)
        w.ue(self.log2_min_tb_size - 2)
        w.ue(self.log2_max_tb_size - self.log2_min_tb_size)
        w.ue(self.max_transform_hierarchy_depth_inter)
        w.ue(self.max_transform_hierarchy_depth_intra)
        w.flag(self.scaling_list_enabled)
        if self.scaling_list_enabled:
            if self.scaling_list is not None:
                w.flag(1)  # sps_scaling_list_data_present_flag
                self.scaling_list.write(w)
            else:
                w.flag(0)  # default lists
        w.flag(self.amp_enabled)
        w.flag(self.sao_enabled)
        w.flag(self.pcm_enabled)
        if self.pcm_enabled:
            w.u(self.pcm_bit_depth_luma - 1, 4)
            w.u(self.pcm_bit_depth_chroma - 1, 4)
            w.ue(self.log2_min_pcm_cb_size - 3)
            w.ue(self.log2_max_pcm_cb_size - self.log2_min_pcm_cb_size)
            w.flag(self.pcm_loop_filter_disabled)
        w.ue(len(self.st_rps))
        for i, rps in enumerate(self.st_rps):
            rps.write(w, i, len(self.st_rps))
        w.flag(self.long_term_ref_pics_present)
        if self.long_term_ref_pics_present:
            w.ue(len(self.lt_ref_pocs_sps))
            for lsb, used in zip(self.lt_ref_pocs_sps, self.lt_used_sps):
                w.u(lsb, self.log2_max_poc_lsb)
                w.flag(used)
        w.flag(self.temporal_mvp_enabled)
        w.flag(self.strong_intra_smoothing)
        w.flag(0)  # vui_parameters_present_flag
        if self.range_ext:
            w.flag(1)  # sps_extension_present_flag
            w.flag(1)  # sps_range_extension_flag
            w.u(0, 7)  # other extension flags
            w.flag(self.transform_skip_rotation)
            w.flag(self.transform_skip_context)
            w.flag(self.implicit_rdpcm)
            w.flag(self.explicit_rdpcm)
            w.flag(self.extended_precision)
            w.flag(self.intra_smoothing_disabled)
            w.flag(self.high_precision_offsets)
            w.flag(self.persistent_rice_adaptation)
            w.flag(self.cabac_bypass_alignment)
        else:
            w.flag(0)
        w.rbsp_trailing_bits()
        return w.getvalue()

    @classmethod
    def parse_rbsp(cls, rbsp: bytes, nuh_layer_id: int = 0,
                   vps_map=None) -> "SPS":
        """Parse an SPS RBSP.  For nuh_layer_id > 0 handles the
        multi-layer-extension path (F.7.3.2.2: sps_ext_or_max_sub_layers,
        rep_format inference — reference: hevc_ps.c:1906-2090)."""
        r = BitReader(rbsp)
        s = cls()
        s.nuh_layer_id = nuh_layer_id
        s.vps_id = r.u(4)
        vps = (vps_map or {}).get(s.vps_id)
        if nuh_layer_id == 0:
            s.max_sub_layers = r.u(3) + 1
        else:
            ext_or_max = r.u(3) + 1
            s.is_multi_layer_ext = (ext_or_max - 1) == 7
            if s.is_multi_layer_ext:
                s.max_sub_layers = vps.max_sub_layers if vps else 1
            else:
                s.max_sub_layers = ext_or_max
        if not s.is_multi_layer_ext:
            s.temporal_id_nesting = r.u(1)
            s.ptl = ProfileTierLevel.parse(r, s.max_sub_layers)
        s.sps_id = r.ue()
        if s.is_multi_layer_ext:
            s.update_rep_format = r.flag()
            if s.update_rep_format:
                s.sps_rep_format_idx = r.u(8)
            ext = vps.vps_ext
            if s.update_rep_format:
                rep = ext.rep_formats[s.sps_rep_format_idx]
            else:
                rep = ext.rep_format_of(nuh_layer_id)
            s.width, s.height = rep.width, rep.height
            s.chroma_format_idc = rep.chroma_format_idc
            s.separate_colour_plane = rep.separate_colour_plane
            s.bit_depth_luma = rep.bit_depth_luma
            s.bit_depth_chroma = rep.bit_depth_chroma
            s.conf_win = rep.conf_win
        else:
            s.chroma_format_idc = r.ue()
            if s.chroma_format_idc == 3:
                s.separate_colour_plane = r.flag()
            s.width = r.ue()
            s.height = r.ue()
            if r.flag():
                s.conf_win = (r.ue(), r.ue(), r.ue(), r.ue())
            s.bit_depth_luma = r.ue() + 8
            s.bit_depth_chroma = r.ue() + 8
        s.log2_max_poc_lsb = r.ue() + 4
        if not s.is_multi_layer_ext:
            sub_layer_ordering = r.flag()
            start = 0 if sub_layer_ordering else s.max_sub_layers - 1
            s.max_dec_pic_buffering = [0] * s.max_sub_layers
            s.num_reorder_pics = [0] * s.max_sub_layers
            s.max_latency_increase = [0] * s.max_sub_layers
            for i in range(start, s.max_sub_layers):
                s.max_dec_pic_buffering[i] = r.ue() + 1
                s.num_reorder_pics[i] = r.ue()
                s.max_latency_increase[i] = r.ue()
            if not sub_layer_ordering:
                for i in range(start):
                    s.max_dec_pic_buffering[i] = s.max_dec_pic_buffering[start]
                    s.num_reorder_pics[i] = s.num_reorder_pics[start]
                    s.max_latency_increase[i] = s.max_latency_increase[start]
        s.log2_min_cb_size = r.ue() + 3
        s.log2_ctb_size = s.log2_min_cb_size + r.ue()
        s.log2_min_tb_size = r.ue() + 2
        s.log2_max_tb_size = s.log2_min_tb_size + r.ue()
        s.max_transform_hierarchy_depth_inter = r.ue()
        s.max_transform_hierarchy_depth_intra = r.ue()
        s.scaling_list_enabled = r.flag()
        if s.scaling_list_enabled:
            from ..coding.scaling import ScalingListData
            infer = r.flag() if s.is_multi_layer_ext else 0
            if infer:
                r.u(6)  # sps_scaling_list_ref_layer_id
            elif r.flag():
                s.scaling_list = ScalingListData().parse(
                    r, s.chroma_format_idc)
        s.amp_enabled = r.flag()
        s.sao_enabled = r.flag()
        s.pcm_enabled = r.flag()
        if s.pcm_enabled:
            s.pcm_bit_depth_luma = r.u(4) + 1
            s.pcm_bit_depth_chroma = r.u(4) + 1
            s.log2_min_pcm_cb_size = r.ue() + 3
            s.log2_max_pcm_cb_size = s.log2_min_pcm_cb_size + r.ue()
            s.pcm_loop_filter_disabled = r.flag()
        num_rps = r.ue()
        for i in range(num_rps):
            s.st_rps.append(ShortTermRPS.parse(r, i, s.st_rps, num_rps))
        s.long_term_ref_pics_present = r.flag()
        if s.long_term_ref_pics_present:
            n = r.ue()
            for _ in range(n):
                s.lt_ref_pocs_sps.append(r.u(s.log2_max_poc_lsb))
                s.lt_used_sps.append(r.flag())
        s.temporal_mvp_enabled = r.flag()
        s.strong_intra_smoothing = r.flag()
        if r.flag():  # vui_present
            parse_vui(r, s)
        if r.flag():  # sps_extension_present
            range_ext = r.flag()
            r.u(7)
            if range_ext:
                s.range_ext = 1
                s.transform_skip_rotation = r.flag()
                s.transform_skip_context = r.flag()
                s.implicit_rdpcm = r.flag()
                s.explicit_rdpcm = r.flag()
                s.extended_precision = r.flag()
                s.intra_smoothing_disabled = r.flag()
                s.high_precision_offsets = r.flag()
                s.persistent_rice_adaptation = r.flag()
                s.cabac_bypass_alignment = r.flag()
        return s.derive()


def parse_scaling_list_data(r: BitReader):
    """Parse scaling_list_data (7.3.4); returns the 4 size-class lists."""
    lists = []
    for size_id in range(4):
        n_mat = 6 if size_id != 3 else 2
        for matrix_id in range(n_mat):
            pred_mode = r.flag()
            if not pred_mode:
                r.ue()  # scaling_list_pred_matrix_id_delta
            else:
                coef_num = min(64, 1 << (4 + (size_id << 1)))
                if size_id > 1:
                    r.se()  # dc coef
                for _ in range(coef_num):
                    r.se()
    return lists


def skip_hrd_parameters(r: BitReader, common_inf: bool,
                        max_sub_layers: int) -> None:
    """hrd_parameters() (E.2.2): parse-and-ignore, like the reference —
    broadcast/conformance streams carry HRD in VUI/VPS and must not
    abort the parse (reference: hevc_ps.c decode_hrd; error policy
    hevcdec.c:3907-3910 log-and-continue)."""
    nal_hrd = vcl_hrd = 0
    sub_pic = 0
    if common_inf:
        nal_hrd = r.flag()
        vcl_hrd = r.flag()
        if nal_hrd or vcl_hrd:
            sub_pic = r.flag()
            if sub_pic:
                r.u(8); r.u(5); r.flag(); r.u(5)
            r.u(4); r.u(4)  # bit_rate_scale, cpb_size_scale
            if sub_pic:
                r.u(4)  # cpb_size_du_scale
            r.u(5); r.u(5); r.u(5)  # initial/au removal, dpb output lens
    for _ in range(max_sub_layers):
        fixed_general = r.flag()
        fixed_within_cvs = 1 if fixed_general else r.flag()
        low_delay = 0
        if fixed_within_cvs:
            r.ue()  # elemental_duration_in_tc_minus1
        else:
            low_delay = r.flag()
        cpb_cnt = 1 if low_delay else r.ue() + 1
        for t, present in ((0, nal_hrd), (1, vcl_hrd)):
            if present:
                for _ in range(cpb_cnt):
                    r.ue(); r.ue()  # bit_rate/cpb_size value
                    if sub_pic:
                        r.ue(); r.ue()  # *_du values
                    r.flag()  # cbr_flag


def parse_vui(r: BitReader, sps: SPS):
    """Parse (and discard most of) vui_parameters (E.2.1)."""
    if r.flag():  # aspect_ratio_info
        idc = r.u(8)
        if idc == 255:
            r.u(16); r.u(16)
    if r.flag():  # overscan
        r.flag()
    if r.flag():  # video_signal_type
        r.u(3); r.flag()
        if r.flag():
            r.u(8); r.u(8); r.u(8)
    if r.flag():  # chroma_loc
        r.ue(); r.ue()
    r.flag()  # neutral_chroma
    r.flag()  # field_seq
    r.flag()  # frame_field_info
    if r.flag():  # default_display_window
        r.ue(); r.ue(); r.ue(); r.ue()
    if r.flag():  # vui_timing_info
        r.u(32); r.u(32)
        if r.flag():
            r.ue()
        if r.flag():  # hrd_parameters: parse-and-ignore
            skip_hrd_parameters(r, True, sps.max_sub_layers)
    if r.flag():  # bitstream_restriction
        r.flag(); r.flag(); r.flag()
        r.ue(); r.ue(); r.ue(); r.ue(); r.ue()


# ---------------------------------------------------------------------------
# PPS (7.3.2.3)
# ---------------------------------------------------------------------------

@dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    dependent_slice_segments_enabled: int = 0
    output_flag_present: int = 0
    num_extra_slice_header_bits: int = 0
    sign_data_hiding: int = 0
    cabac_init_present: int = 0
    num_ref_idx_l0_default: int = 1
    num_ref_idx_l1_default: int = 1
    init_qp: int = 26
    constrained_intra_pred: int = 0
    transform_skip_enabled: int = 0
    cu_qp_delta_enabled: int = 0
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    slice_chroma_qp_offsets_present: int = 0
    weighted_pred: int = 0
    weighted_bipred: int = 0
    transquant_bypass_enabled: int = 0
    tiles_enabled: int = 0
    entropy_coding_sync_enabled: int = 0
    num_tile_columns: int = 1
    num_tile_rows: int = 1
    uniform_spacing: int = 1
    column_widths: List[int] = field(default_factory=list)  # in CTBs
    row_heights: List[int] = field(default_factory=list)
    loop_filter_across_tiles: int = 1
    loop_filter_across_slices: int = 0
    deblocking_filter_control_present: int = 0
    deblocking_filter_override_enabled: int = 0
    deblocking_filter_disabled: int = 0
    beta_offset: int = 0  # *2 actually beta_offset_div2*2
    tc_offset: int = 0
    scaling_list_data_present: int = 0
    scaling_list: object = None
    lists_modification_present: int = 0
    log2_parallel_merge_level: int = 2
    slice_header_extension_present: int = 0
    # range extension
    range_ext: int = 0
    log2_max_transform_skip_block_size: int = 2
    cross_component_prediction_enabled: int = 0
    chroma_qp_offset_list_enabled: int = 0
    diff_cu_chroma_qp_offset_depth: int = 0
    cb_qp_offset_list: List[int] = field(default_factory=list)
    cr_qp_offset_list: List[int] = field(default_factory=list)
    log2_sao_offset_scale_luma: int = 0
    log2_sao_offset_scale_chroma: int = 0
    # multilayer extension (F.7.3.2.3.4; reference: hevc_ps.c:2842
    # pps_multilayer_extensions) — the subset with decode semantics:
    # the CGS colour-mapping 3D-LUT (reference: hevc_ps.h:777-804)
    poc_reset_info_present: int = 0
    cgs_lut: object = None            # ops.cgs.CgsLut when enabled
    # emitter-only controls for the LUT payload
    cgs_splits: object = None
    cgs_deltas: object = None

    def write_rbsp(self) -> bytes:
        w = BitWriter()
        w.ue(self.pps_id)
        w.ue(self.sps_id)
        w.flag(self.dependent_slice_segments_enabled)
        w.flag(self.output_flag_present)
        w.u(self.num_extra_slice_header_bits, 3)
        w.flag(self.sign_data_hiding)
        w.flag(self.cabac_init_present)
        w.ue(self.num_ref_idx_l0_default - 1)
        w.ue(self.num_ref_idx_l1_default - 1)
        w.se(self.init_qp - 26)
        w.flag(self.constrained_intra_pred)
        w.flag(self.transform_skip_enabled)
        w.flag(self.cu_qp_delta_enabled)
        if self.cu_qp_delta_enabled:
            w.ue(self.diff_cu_qp_delta_depth)
        w.se(self.cb_qp_offset)
        w.se(self.cr_qp_offset)
        w.flag(self.slice_chroma_qp_offsets_present)
        w.flag(self.weighted_pred)
        w.flag(self.weighted_bipred)
        w.flag(self.transquant_bypass_enabled)
        w.flag(self.tiles_enabled)
        w.flag(self.entropy_coding_sync_enabled)
        if self.tiles_enabled:
            w.ue(self.num_tile_columns - 1)
            w.ue(self.num_tile_rows - 1)
            w.flag(self.uniform_spacing)
            if not self.uniform_spacing:
                for cw in self.column_widths[:-1]:
                    w.ue(cw - 1)
                for rh in self.row_heights[:-1]:
                    w.ue(rh - 1)
            w.flag(self.loop_filter_across_tiles)
        w.flag(self.loop_filter_across_slices)
        w.flag(self.deblocking_filter_control_present)
        if self.deblocking_filter_control_present:
            w.flag(self.deblocking_filter_override_enabled)
            w.flag(self.deblocking_filter_disabled)
            if not self.deblocking_filter_disabled:
                w.se(self.beta_offset // 2)
                w.se(self.tc_offset // 2)
        w.flag(self.scaling_list_data_present)
        if self.scaling_list_data_present:
            self.scaling_list.write(w)
        w.flag(self.lists_modification_present)
        w.ue(self.log2_parallel_merge_level - 2)
        w.flag(self.slice_header_extension_present)
        multilayer = self.cgs_lut is not None
        if self.range_ext or multilayer:
            w.flag(1)  # pps_extension_present_flag
            w.flag(1 if self.range_ext else 0)
            w.flag(1 if multilayer else 0)
            w.u(0, 6)
            if self.range_ext:
                if self.transform_skip_enabled:
                    w.ue(self.log2_max_transform_skip_block_size - 2)
                w.flag(self.cross_component_prediction_enabled)
                w.flag(self.chroma_qp_offset_list_enabled)
                if self.chroma_qp_offset_list_enabled:
                    w.ue(self.diff_cu_chroma_qp_offset_depth)
                    w.ue(len(self.cb_qp_offset_list) - 1)
                    for cb, cr in zip(self.cb_qp_offset_list,
                                      self.cr_qp_offset_list):
                        w.se(cb)
                        w.se(cr)
                w.ue(self.log2_sao_offset_scale_luma)
                w.ue(self.log2_sao_offset_scale_chroma)
            if multilayer:
                # pps_multilayer_extension (reference: hevc_ps.c:2842)
                from ..ops.cgs import write_cgs_lut
                w.flag(self.poc_reset_info_present)
                w.flag(0)  # pps_infer_scaling_list_flag
                w.ue(0)    # num_ref_loc_offsets
                w.flag(1)  # colour_mapping_enabled_flag
                write_cgs_lut(w, self.cgs_lut, self.cgs_splits,
                              self.cgs_deltas)
        else:
            w.flag(0)
        w.rbsp_trailing_bits()
        return w.getvalue()

    @classmethod
    def parse_rbsp(cls, rbsp: bytes) -> "PPS":
        r = BitReader(rbsp)
        p = cls()
        p.pps_id = r.ue()
        p.sps_id = r.ue()
        p.dependent_slice_segments_enabled = r.flag()
        p.output_flag_present = r.flag()
        p.num_extra_slice_header_bits = r.u(3)
        p.sign_data_hiding = r.flag()
        p.cabac_init_present = r.flag()
        p.num_ref_idx_l0_default = r.ue() + 1
        p.num_ref_idx_l1_default = r.ue() + 1
        p.init_qp = r.se() + 26
        p.constrained_intra_pred = r.flag()
        p.transform_skip_enabled = r.flag()
        p.cu_qp_delta_enabled = r.flag()
        if p.cu_qp_delta_enabled:
            p.diff_cu_qp_delta_depth = r.ue()
        p.cb_qp_offset = r.se()
        p.cr_qp_offset = r.se()
        p.slice_chroma_qp_offsets_present = r.flag()
        p.weighted_pred = r.flag()
        p.weighted_bipred = r.flag()
        p.transquant_bypass_enabled = r.flag()
        p.tiles_enabled = r.flag()
        p.entropy_coding_sync_enabled = r.flag()
        if p.tiles_enabled:
            p.num_tile_columns = r.ue() + 1
            p.num_tile_rows = r.ue() + 1
            p.uniform_spacing = r.flag()
            if not p.uniform_spacing:
                p.column_widths = [r.ue() + 1 for _ in range(p.num_tile_columns - 1)]
                p.row_heights = [r.ue() + 1 for _ in range(p.num_tile_rows - 1)]
            p.loop_filter_across_tiles = r.flag()
        p.loop_filter_across_slices = r.flag()
        p.deblocking_filter_control_present = r.flag()
        if p.deblocking_filter_control_present:
            p.deblocking_filter_override_enabled = r.flag()
            p.deblocking_filter_disabled = r.flag()
            if not p.deblocking_filter_disabled:
                p.beta_offset = r.se() * 2
                p.tc_offset = r.se() * 2
        p.scaling_list_data_present = r.flag()
        if p.scaling_list_data_present:
            from ..coding.scaling import ScalingListData
            p.scaling_list = ScalingListData().parse(r)
        p.lists_modification_present = r.flag()
        p.log2_parallel_merge_level = r.ue() + 2
        p.slice_header_extension_present = r.flag()
        if r.flag():  # pps_extension_present
            range_ext = r.flag()
            multilayer = r.flag()
            r.u(6)
            if range_ext:
                p.range_ext = 1
                if p.transform_skip_enabled:
                    p.log2_max_transform_skip_block_size = r.ue() + 2
                p.cross_component_prediction_enabled = r.flag()
                p.chroma_qp_offset_list_enabled = r.flag()
                if p.chroma_qp_offset_list_enabled:
                    p.diff_cu_chroma_qp_offset_depth = r.ue()
                    n = r.ue() + 1
                    for _ in range(n):
                        p.cb_qp_offset_list.append(r.se())
                        p.cr_qp_offset_list.append(r.se())
                p.log2_sao_offset_scale_luma = r.ue()
                p.log2_sao_offset_scale_chroma = r.ue()
            if multilayer:
                # pps_multilayer_extension (reference: hevc_ps.c:2842)
                p.poc_reset_info_present = r.flag()
                if r.flag():  # pps_infer_scaling_list_flag
                    r.u(6)    # pps_scaling_list_ref_layer_id
                for _ in range(r.ue()):  # num_ref_loc_offsets
                    r.u(6)  # ref_loc_offset_layer_id
                    if r.flag():  # scaled_ref_layer_offset_present
                        for _ in range(4):
                            r.se()
                    if r.flag():  # ref_region_offset_present
                        for _ in range(4):
                            r.se()
                    if r.flag():  # resample_phase_set_present
                        for _ in range(4):
                            r.ue()
                if r.flag():  # colour_mapping_enabled_flag
                    from ..ops.cgs import parse_cgs_lut
                    p.cgs_lut = parse_cgs_lut(r)
        return p

    # ---- derived tile/address maps (reference: hevc_ps.c setup_pps) ----
    def derive(self, sps: SPS) -> "PPS":
        # PPS scaling lists are parsed before the SPS is known; apply the
        # 4:4:4 32x32-chroma mirror now (7.4.5 note; reference:
        # hevc_ps.c:3128 passes the SPS into scaling_list_data)
        if self.scaling_list_data_present and sps.chroma_format_idc == 3:
            self.scaling_list.remap_444()
        cw, ch = sps.ctb_w, sps.ctb_h
        nc, nr = self.num_tile_columns, self.num_tile_rows
        if self.tiles_enabled:
            if self.uniform_spacing:
                col_bounds = [(i * cw) // nc for i in range(nc + 1)]
                row_bounds = [(i * ch) // nr for i in range(nr + 1)]
                self.column_widths = [col_bounds[i + 1] - col_bounds[i] for i in range(nc)]
                self.row_heights = [row_bounds[i + 1] - row_bounds[i] for i in range(nr)]
            else:
                if len(self.column_widths) == nc - 1:
                    self.column_widths = list(self.column_widths) + [cw - sum(self.column_widths)]
                if len(self.row_heights) == nr - 1:
                    self.row_heights = list(self.row_heights) + [ch - sum(self.row_heights)]
        else:
            self.column_widths = [cw]
            self.row_heights = [ch]
        col_bd = np.cumsum([0] + self.column_widths)
        row_bd = np.cumsum([0] + self.row_heights)
        self.col_bd, self.row_bd = col_bd, row_bd
        # per-CTB tile index
        xs = np.arange(cw)
        ys = np.arange(ch)
        tile_x = np.searchsorted(col_bd, xs, side="right") - 1
        tile_y = np.searchsorted(row_bd, ys, side="right") - 1
        self.tile_of_ctb = (tile_y[:, None] * nc + tile_x[None, :]).astype(np.int32)
        # raster→tile-scan map (ctb_addr_rs_to_ts): tiles in raster order,
        # CTBs raster within each tile
        rs_to_ts = np.zeros(cw * ch, np.int32)
        ts = 0
        order = []
        for ty in range(nr):
            for tx in range(nc):
                for y in range(row_bd[ty], row_bd[ty + 1]):
                    for x in range(col_bd[tx], col_bd[tx + 1]):
                        rs = y * cw + x
                        rs_to_ts[rs] = ts
                        order.append(rs)
                        ts += 1
        self.ctb_addr_rs_to_ts = rs_to_ts
        self.ctb_addr_ts_to_rs = np.array(order, np.int32)
        self.tile_id_of_ts = np.array(
            [self.tile_of_ctb[rs // cw, rs % cw] for rs in order], np.int32)
        # first ctb (rs addr) of each tile
        self.tile_first_rs = np.zeros(nc * nr, np.int32)
        for ty in range(nr):
            for tx in range(nc):
                self.tile_first_rs[ty * nc + tx] = row_bd[ty] * cw + col_bd[tx]
        return self
