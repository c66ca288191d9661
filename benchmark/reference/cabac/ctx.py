"""CABAC context models: layout + initialization (H.265 clause 9.3.2.2).

The per-syntax-element context counts and initValue constants are the
standard's Tables 9-5 through 9-32 (the same constants appear in the
reference at libavcodec/hevc_cabac.c:55-398).  Layout here is our own:
elements are named, offsets derived programmatically.

initType selection (9.3.2.2): I-slice → 0; P-slice → cabac_init_flag ? 2 : 1;
B-slice → cabac_init_flag ? 1 : 2.

Frozen copy of ``hevc_tpu_torch/cabac/ctx.py`` at ee5ffe9.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

CNU = 154

# (element, number of contexts, (initType0, initType1, initType2))
_LAYOUT: List[Tuple[str, int, tuple]] = [
    ("sao_merge_flag", 1, ((153,), (153,), (153,))),
    ("sao_type_idx", 1, ((200,), (185,), (160,))),
    ("split_cu_flag", 3, ((139, 141, 157), (107, 139, 126), (107, 139, 126))),
    ("cu_transquant_bypass_flag", 1, ((154,), (154,), (154,))),
    ("cu_skip_flag", 3, ((CNU,) * 3, (197, 185, 201), (197, 185, 201))),
    ("cu_qp_delta", 3, ((154,) * 3, (154,) * 3, (154,) * 3)),
    ("pred_mode_flag", 1, ((CNU,), (149,), (134,))),
    ("part_mode", 4, ((184, CNU, CNU, CNU), (154, 139, 154, 154),
                      (154, 139, 154, 154))),
    ("prev_intra_luma_pred_flag", 1, ((184,), (154,), (183,))),
    ("intra_chroma_pred_mode", 2, ((63, 139), (152, 139), (152, 139))),
    ("merge_flag", 1, ((CNU,), (110,), (154,))),
    ("merge_idx", 1, ((CNU,), (122,), (137,))),
    ("inter_pred_idc", 5, ((CNU,) * 5, (95, 79, 63, 31, 31),
                           (95, 79, 63, 31, 31))),
    ("ref_idx_l0", 2, ((CNU, CNU), (153, 153), (153, 153))),
    ("ref_idx_l1", 2, ((CNU, CNU), (153, 153), (153, 153))),
    ("abs_mvd_greater0_flag", 2, ((CNU, CNU), (140, 198), (169, 198))),
    ("abs_mvd_greater1_flag", 2, ((CNU, CNU), (140, 198), (169, 198))),
    ("mvp_lx_flag", 1, ((CNU,), (168,), (168,))),
    ("no_residual_data_flag", 1, ((CNU,), (79,), (79,))),
    ("split_transform_flag", 3, ((153, 138, 138), (124, 138, 94),
                                 (224, 167, 122))),
    ("cbf_luma", 2, ((111, 141), (153, 111), (153, 111))),
    ("cbf_cbcr", 4, ((94, 138, 182, 154), (149, 107, 167, 154),
                     (149, 92, 167, 154))),
    ("transform_skip_flag", 2, ((139, 139), (139, 139), (139, 139))),
    ("explicit_rdpcm_flag", 2, ((139, 139), (139, 139), (139, 139))),
    ("explicit_rdpcm_dir_flag", 2, ((139, 139), (139, 139), (139, 139))),
    ("last_sig_coeff_x_prefix", 18, (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93))),
    ("last_sig_coeff_y_prefix", 18, (
        (110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143, 127,
         111, 79, 108, 123, 63),
        (125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111, 95,
         94, 108, 123, 108),
        (125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111, 111,
         79, 108, 123, 93))),
    ("coded_sub_block_flag", 4, ((91, 171, 134, 141), (121, 140, 61, 154),
                                 (121, 140, 61, 154))),
    ("sig_coeff_flag", 44, (
        (111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179,
         153, 125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
         125, 140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111,
         136, 139, 111, 141, 111),
        (155, 154, 139, 153, 139, 123, 123, 63, 153, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 123, 123, 107, 121, 107, 121, 167, 151, 183, 140,
         151, 183, 140, 140, 140),
        (170, 154, 139, 153, 139, 123, 123, 63, 124, 166, 183, 140, 136,
         153, 154, 166, 183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 170, 153, 138, 138, 122, 121, 122, 121, 167, 151, 183, 140,
         151, 183, 140, 140, 140))),
    ("coeff_abs_level_greater1_flag", 24, (
        (140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139,
         107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197),
        (154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182),
        (154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136, 153,
         121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182))),
    ("coeff_abs_level_greater2_flag", 6, (
        (138, 153, 136, 167, 152, 152),
        (107, 167, 91, 122, 107, 167),
        (107, 167, 91, 107, 107, 167))),
    ("log2_res_scale_abs", 8, ((154,) * 8, (154,) * 8, (154,) * 8)),
    ("res_scale_sign_flag", 2, ((154, 154), (154, 154), (154, 154))),
    ("cu_chroma_qp_offset_flag", 1, ((154,), (154,), (154,))),
    ("cu_chroma_qp_offset_idx", 1, ((154,), (154,), (154,))),
]

CTX_OFFSET: Dict[str, int] = {}
CTX_COUNT: Dict[str, int] = {}
_off = 0
for _name, _n, _vals in _LAYOUT:
    CTX_OFFSET[_name] = _off
    CTX_COUNT[_name] = _n
    for _v in _vals:
        assert len(_v) == _n, _name
    _off += _n
TOTAL_CONTEXTS = _off

INIT_VALUES = []
for t in range(3):
    flat = []
    for _name, _n, _vals in _LAYOUT:
        flat.extend(_vals[t])
    INIT_VALUES.append(tuple(flat))


def _clip3(lo, hi, v):
    return lo if v < lo else hi if v > hi else v


def init_context_states(init_type: int, qp: int) -> list:
    """Derive the initial (pStateIdx<<1|valMps) per context (9.3.2.2)."""
    qp = _clip3(0, 51, qp)
    states = []
    for init_value in INIT_VALUES[init_type]:
        slope = (init_value >> 4) * 5 - 45
        offset = ((init_value & 15) << 3) - 16
        pre = _clip3(1, 126, ((slope * qp) >> 4) + offset)
        if pre <= 63:
            states.append(((63 - pre) << 1) | 0)
        else:
            states.append(((pre - 64) << 1) | 1)
    return states


class ContextModel:
    """Holds the live context-state array for one entropy segment.

    Slots are addressed as (states, absolute_index); helper `at` resolves
    element name + sub-index.
    """

    __slots__ = ("states", "stat_coeff")

    def __init__(self, init_type: int, qp: int):
        self.states = init_context_states(init_type, qp)
        # persistent Rice statistics (rext persistent_rice_adaptation)
        self.stat_coeff = [0, 0, 0, 0]

    def at(self, name: str, idx: int = 0):
        assert 0 <= idx < CTX_COUNT[name], (name, idx)
        return (self.states, CTX_OFFSET[name] + idx)

    def save(self):
        return (list(self.states), list(self.stat_coeff))

    def load(self, snapshot):
        states, stat = snapshot
        self.states[:] = states
        self.stat_coeff[:] = stat
