"""Per-quantization-group luma QP derivation (H.265 8.6.1).

Shared by the decoder (deriving QP from cu_qp_delta) and the encoder
(mirroring the decoder's state machine so the emitted deltas land on the
intended QPs).  Faithful to the reference's state machine
(reference: hevc_filter.c:94-147 get_qPy_pred/ff_hevc_set_qPy;
hevcdec.c:2727-2730 QG reset, :2692/:2769 end-of-CU + QG-aligned
qPy_pred updates, :2808/:2814 first_qp_group at WPP-row/tile starts).

Frozen copy of ``hevc_tpu_torch/coding/qp.py`` at ee5ffe9.
"""
from __future__ import annotations


class QpState:
    """lc->qp_y / qPy_pred / first_qp_group / tu.cu_qp_delta mirror."""

    __slots__ = ("slice_qp", "cur_qp", "qp_pred_state", "first_qp_group",
                 "is_cu_qp_delta_coded", "cu_qp_delta_val",
                 "is_cu_chroma_qp_offset_coded", "cu_qp_offset_cb",
                 "cu_qp_offset_cr")

    def __init__(self, slice_qp: int, first_qp_group: bool = True):
        self.slice_qp = slice_qp
        self.cur_qp = slice_qp
        self.qp_pred_state = slice_qp
        self.first_qp_group = first_qp_group
        self.is_cu_qp_delta_coded = False
        self.cu_qp_delta_val = 0
        # rext per-chroma-QG offsets (7.3.8.10 cu_chroma_qp_offset; the
        # offsets persist across QGs until re-coded — reference:
        # hevcdec.c:2729/1380)
        self.is_cu_chroma_qp_offset_coded = False
        self.cu_qp_offset_cb = 0
        self.cu_qp_offset_cr = 0


def qg_mask(sps, pps) -> int:
    """MinCuQpDeltaSize - 1 (the reference's qp_block_mask)."""
    return (1 << (sps.log2_ctb_size - pps.diff_cu_qp_delta_depth)) - 1


def qp_pred(st: QpState, pic, sps, pps, x_base: int, y_base: int) -> int:
    """qPY_PRED for the CU at (x_base, y_base) (8.6.1 steps 1-3)."""
    ctb_mask = (1 << sps.log2_ctb_size) - 1
    m = qg_mask(sps, pps)
    xqg = x_base - (x_base & m)
    yqg = y_base - (y_base & m)
    if st.first_qp_group or (xqg == 0 and yqg == 0):
        st.first_qp_group = not st.is_cu_qp_delta_coded
        pred = st.slice_qp
    else:
        pred = st.qp_pred_state
    # availability = not at the CTB's left/top edge (same-CTB rule)
    avail_a = (x_base & ctb_mask) and (xqg & ctb_mask)
    avail_b = (y_base & ctb_mask) and (yqg & ctb_mask)
    qpa = int(pic.qp_y[yqg >> 2, (xqg - 1) >> 2]) if avail_a else pred
    qpb = int(pic.qp_y[(yqg - 1) >> 2, xqg >> 2]) if avail_b else pred
    return (qpa + qpb + 1) >> 1


def set_qpy(st: QpState, pic, sps, pps, x_base: int, y_base: int) -> None:
    """Derive QpY for the current CU into st.cur_qp (8.6.1 step 4)."""
    pred = qp_pred(st, pic, sps, pps, x_base, y_base)
    if st.cu_qp_delta_val != 0:
        off = sps.qp_bd_offset
        st.cur_qp = ((pred + st.cu_qp_delta_val + 52 + 2 * off)
                     % (52 + off)) - off
    else:
        st.cur_qp = pred


def end_of_cu(st: QpState, pic, sps, pps, x0: int, y0: int,
              log2_size: int) -> None:
    """End-of-CU bookkeeping: late QP derivation when no delta was coded,
    QP-map fill, and qPy_pred update at QG-aligned completions
    (reference: hevcdec.c:2692-2771)."""
    size = 1 << log2_size
    if not st.is_cu_qp_delta_coded:
        set_qpy(st, pic, sps, pps, x0, y0)
    gq = size >> 2
    pic.qp_y[y0 >> 2:(y0 >> 2) + gq, x0 >> 2:(x0 >> 2) + gq] = st.cur_qp
    m = qg_mask(sps, pps)
    if ((x0 + size) & m) == 0 and ((y0 + size) & m) == 0:
        st.qp_pred_state = st.cur_qp
