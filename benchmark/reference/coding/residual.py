"""residual_coding() syntax — decode and encode mirrors (H.265 7.3.8.11).

Context derivations follow clauses 9.3.4.2.3 (last position),
9.3.4.2.4 (coded_sub_block_flag), 9.3.4.2.5 (sig_coeff_flag) and
9.3.4.2.6 (greater1/greater2), with coeff_abs_level_remaining binarized
per 9.3.3.13.  Capability parity with the reference's
ff_hevc_hls_coefficients_coding (reference: libavcodec/hevc_cabac.c:2408);
re-derived from the specification, and with an encoder mirror the
reference does not have.

Levels arrays are [y][x] int32 of TransCoeffLevel.

Range-extension tools (7.3.8.11 + 9.3.3.13 rext rows; behaviour matched
against the reference's April-2014-draft implementation,
reference: libavcodec/hevc_cabac.c:2085-2700):
  * persistent Rice adaptation — per-(plane-kind, skip-kind) StatCoeff
    seeding the sub-block Rice parameter, updated once per sub-block on
    the first coeff_abs_level_remaining;
  * transform-skip sig-coeff contexts — skipped/bypassed blocks use one
    flat context per plane kind: 42 (luma) / 43 (chroma) at every scan
    position (base 40/41 + the all-2 default ctx map row);
  * explicit RDPCM — inter TU flag + direction, decoded after
    transform_skip_flag; disables sign-data hiding;
  * implicit RDPCM — intra hor/ver skipped/bypassed TUs; disables SDH.

Frozen copy of ``hevc_tpu_torch/coding/residual.py`` at ee5ffe9.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..cabac.engine import CabacDecoder, CabacEncoder
from ..cabac.ctx import ContextModel
from .scans import SCAN_DIAG, SCAN_VERT, block_scan


@dataclass
class RextCtx:
    """Active range-extension residual-coding state for one slice."""
    persistent_rice: bool = False
    ts_context: bool = False
    implicit_rdpcm: bool = False
    explicit_rdpcm: bool = False
    # StatCoeff[sb_type]: (chroma, chroma-skip, luma, luma-skip) —
    # reset at CABAC init like the context states (reference:
    # hevc_cabac.c:609)
    stats: list = field(default_factory=lambda: [0, 0, 0, 0])

# 9.3.4.2.5: ctxIdxMap for 4x4 blocks
_CTX_IDX_MAP_4x4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)


def _sig_ctx(log2_size: int, c_idx: int, xc: int, yc: int, scan_idx: int,
             csbf: np.ndarray, nsb: int) -> int:
    if log2_size == 2:
        s = _CTX_IDX_MAP_4x4[(yc << 2) + xc]
    elif xc + yc == 0:
        s = 0
    else:
        xs, ys = xc >> 2, yc >> 2
        prev = 0
        if xs < nsb - 1 and csbf[ys, xs + 1]:
            prev += 1
        if ys < nsb - 1 and csbf[ys + 1, xs]:
            prev += 2
        xp, yp = xc & 3, yc & 3
        if prev == 0:
            s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
        elif prev == 1:
            s = 2 if yp == 0 else (1 if yp == 1 else 0)
        elif prev == 2:
            s = 2 if xp == 0 else (1 if xp == 1 else 0)
        else:
            s = 2
        if c_idx == 0:
            if xs + ys > 0:
                s += 3
            if log2_size == 3:
                s += 9 if scan_idx == SCAN_DIAG else 15
            else:
                s += 21
        else:
            s += 9 if log2_size == 3 else 12
    return s + (27 if c_idx else 0)


def _last_ctx_params(log2_size: int, c_idx: int):
    if c_idx == 0:
        return 3 * (log2_size - 2) + ((log2_size - 1) >> 2), (log2_size + 1) >> 2
    return 15, log2_size - 2


def decode_remaining(d: CabacDecoder, rice: int) -> int:
    """coeff_abs_level_remaining (9.3.3.13): TR prefix + EGk escape."""
    prefix = 0
    while prefix < 24 and d.decode_bypass():
        prefix += 1
    if prefix < 3:
        return (prefix << rice) + d.decode_bypass_bits(rice)
    nbits = prefix - 3 + rice
    return (((1 << (prefix - 3)) + 2) << rice) + d.decode_bypass_bits(nbits)


def encode_remaining(e: CabacEncoder, value: int, rice: int) -> None:
    if value < (3 << rice):
        prefix = value >> rice
        for _ in range(prefix):
            e.encode_bypass(1)
        e.encode_bypass(0)
        e.encode_bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        v = value - (3 << rice)
        length = rice
        while v >= (1 << length):
            v -= 1 << length
            length += 1
        for _ in range(3 + length - rice):
            e.encode_bypass(1)
        e.encode_bypass(0)
        e.encode_bypass_bits(v, length)


def decode_residual(d: CabacDecoder, cm: ContextModel, log2_size: int,
                    c_idx: int, scan_idx: int, *,
                    sign_data_hiding: bool = False,
                    transform_skip_allowed: bool = False,
                    tq_bypass: bool = False,
                    rext: RextCtx | None = None,
                    pred_inter: bool = False,
                    intra_mode: int = -1):
    """Returns (levels[n,n] int32, transform_skip_flag,
    explicit_rdpcm_flag, explicit_rdpcm_dir)."""
    size = 1 << log2_size
    ts_flag = 0
    if transform_skip_allowed and not tq_bypass:
        ts_flag = d.decode_bin(cm.at("transform_skip_flag", 1 if c_idx else 0))
    rdpcm_flag = rdpcm_dir = 0
    skip_like = bool(ts_flag or tq_bypass)
    if rext is not None and rext.explicit_rdpcm and pred_inter and skip_like:
        rdpcm_flag = d.decode_bin(cm.at("explicit_rdpcm_flag",
                                        1 if c_idx else 0))
        if rdpcm_flag:
            rdpcm_dir = d.decode_bin(cm.at("explicit_rdpcm_dir_flag",
                                           1 if c_idx else 0))
    ts_ctx = bool(rext is not None and rext.ts_context and skip_like)
    # SDH is off for bypass / rdpcm blocks (reference: sign_always_hidden,
    # hevc_cabac.c:2180/2520)
    sdh_off = bool(tq_bypass or rdpcm_flag
                   or (rext is not None and rext.implicit_rdpcm
                       and not pred_inter and ts_flag
                       and intra_mode in (10, 26)))
    use_price = bool(rext is not None and rext.persistent_rice)
    sb_type = (2 if c_idx == 0 else 0) + (1 if skip_like else 0)

    # ---- last significant coefficient position --------------------------
    off, shift = _last_ctx_params(log2_size, c_idx)
    cmax = (log2_size << 1) - 1
    px = 0
    while px < cmax and d.decode_bin(cm.at("last_sig_coeff_x_prefix",
                                           off + (px >> shift))):
        px += 1
    py = 0
    while py < cmax and d.decode_bin(cm.at("last_sig_coeff_y_prefix",
                                           off + (py >> shift))):
        py += 1
    # both prefixes precede both suffixes in the bitstream
    if px > 3:
        nbits = (px >> 1) - 1
        last_x = ((2 + (px & 1)) << nbits) + d.decode_bypass_bits(nbits)
    else:
        last_x = px
    if py > 3:
        nbits = (py >> 1) - 1
        last_y = ((2 + (py & 1)) << nbits) + d.decode_bypass_bits(nbits)
    else:
        last_y = py
    if scan_idx == SCAN_VERT:
        last_x, last_y = last_y, last_x

    sub_scan, coef_scan, pos_of_xy = block_scan(scan_idx, log2_size)
    last_pos = int(pos_of_xy[last_y, last_x])
    last_sb, last_n = last_pos >> 4, last_pos & 15
    nsb = max(1, size >> 2)
    csbf = np.zeros((nsb, nsb), np.uint8)
    levels = np.zeros((size, size), np.int32)

    c1 = 1  # greater1 state, persists across sub-blocks
    for i in range(last_sb, -1, -1):
        xs, ys = int(sub_scan[i][0]), int(sub_scan[i][1])
        infer_dc = 0
        if 0 < i < last_sb:
            right = int(csbf[ys, xs + 1]) if xs + 1 < nsb else 0
            below = int(csbf[ys + 1, xs]) if ys + 1 < nsb else 0
            ctx = min(1, right + below) + (2 if c_idx else 0)
            sbf = d.decode_bin(cm.at("coded_sub_block_flag", ctx))
            infer_dc = 1
        else:
            sbf = 1
        csbf[ys, xs] = sbf
        if not sbf:
            continue

        # significant_coeff_flag, processing order = descending scan pos
        sig_pos = []
        if i == last_sb:
            sig_pos.append(last_n)
            n_start = last_n - 1
        else:
            n_start = 15
        for n in range(n_start, 0, -1):
            xp, yp = int(coef_scan[n][0]), int(coef_scan[n][1])
            if ts_ctx:  # dedicated skip context (flat: the reference's
                # default ctx map adds 2 to the 40/41 base for every
                # position — hevc_cabac.c:1981 + ctx_idx_map line 4)
                ctx = 42 if c_idx == 0 else 43
            else:
                ctx = _sig_ctx(log2_size, c_idx, (xs << 2) + xp,
                               (ys << 2) + yp, scan_idx, csbf, nsb)
            if d.decode_bin(cm.at("sig_coeff_flag", ctx)):
                sig_pos.append(n)
                infer_dc = 0
        if n_start >= 0:
            if infer_dc:
                sig_pos.append(0)  # inferred significant DC
            else:
                if ts_ctx:
                    ctx = 42 if c_idx == 0 else 43
                else:
                    ctx = _sig_ctx(log2_size, c_idx, xs << 2, ys << 2,
                                   scan_idx, csbf, nsb)
                if d.decode_bin(cm.at("sig_coeff_flag", ctx)):
                    sig_pos.append(0)
        nsig = len(sig_pos)
        if nsig == 0:
            continue

        # greater1 flags (first 8 significant coeffs)
        ctx_set = (2 if (i > 0 and c_idx == 0) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        gt1 = {}
        gt2_target = -1
        for n in sig_pos[:8]:
            base = (16 if c_idx else 0) + 4 * ctx_set + c1
            f = d.decode_bin(cm.at("coeff_abs_level_greater1_flag", base))
            gt1[n] = f
            if f:
                if gt2_target < 0:
                    gt2_target = n
                c1 = 0
            elif 0 < c1 < 3:
                c1 += 1
        gt2 = 0
        if gt2_target >= 0:
            gt2 = d.decode_bin(cm.at("coeff_abs_level_greater2_flag",
                                     (4 if c_idx else 0) + ctx_set))

        # signs (bypass; possibly one hidden)
        first_nz, last_nz = sig_pos[-1], sig_pos[0]
        hidden = (sign_data_hiding and not sdh_off
                  and (last_nz - first_nz) >= 4)
        nsigns = nsig - 1 if hidden else nsig
        signs = [d.decode_bypass() for _ in range(nsigns)]

        # remaining levels
        rice = (rext.stats[sb_type] >> 2) if use_price else 0
        stat_pending = use_price
        sum_abs = 0
        lvls = []
        for m, n in enumerate(sig_pos):
            lvl = 1
            if m < 8:
                lvl += gt1[n]
                if n == gt2_target:
                    lvl += gt2
                threshold = 3 if n == gt2_target else 2
            else:
                threshold = 1
            if lvl == threshold:
                rem = decode_remaining(d, rice)
                lvl += rem
                if use_price:
                    if lvl > (3 << rice):
                        rice += 1  # persistent: unclamped in-CG growth
                    if stat_pending:
                        # first remaining of the CG adapts StatCoeff
                        # (reference: update_rice_statistics)
                        init = rext.stats[sb_type] >> 2
                        if rem >= (3 << init):
                            rext.stats[sb_type] += 1
                        elif 2 * rem < (1 << init) \
                                and rext.stats[sb_type] > 0:
                            rext.stats[sb_type] -= 1
                        stat_pending = False
                elif lvl > (3 << rice):
                    rice = min(rice + 1, 4)
            lvls.append(lvl)
            sum_abs += lvl
        for m, n in enumerate(sig_pos):
            xp, yp = int(coef_scan[n][0]), int(coef_scan[n][1])
            if hidden and m == nsig - 1:
                sgn = -1 if (sum_abs & 1) else 1
            else:
                sgn = -1 if signs[m] else 1
            levels[(ys << 2) + yp, (xs << 2) + xp] = sgn * lvls[m]
    return levels, ts_flag, rdpcm_flag, rdpcm_dir


def _encode_last_component(e: CabacEncoder, cm: ContextModel, name: str,
                           value: int, off: int, shift: int, cmax: int):
    if value <= 3:
        prefix, nbits, suffix = value, 0, 0
    else:
        msb = value.bit_length() - 1
        nbits = msb - 1
        group = (value >> nbits) & 1
        prefix = 2 * nbits + group + 2
        suffix = value - ((2 + group) << nbits)
    for i in range(prefix):
        e.encode_bin(cm.at(name, off + (i >> shift)), 1)
    if prefix < cmax:
        e.encode_bin(cm.at(name, off + (prefix >> shift)), 0)
    return nbits, suffix


def encode_residual(e: CabacEncoder, cm: ContextModel, levels: np.ndarray,
                    log2_size: int, c_idx: int, scan_idx: int, *,
                    sign_data_hiding: bool = False,
                    transform_skip_allowed: bool = False,
                    ts_flag: int = 0,
                    tq_bypass: bool = False,
                    rext: RextCtx | None = None,
                    pred_inter: bool = False,
                    intra_mode: int = -1,
                    rdpcm_flag: int = 0,
                    rdpcm_dir: int = 0) -> None:
    """Exact mirror of decode_residual.  levels must contain >=1 nonzero.

    With sign_data_hiding, the caller must pre-adjust levels so the hidden
    sign equals the parity of the sub-block level sum (quantizer's job).
    """
    size = 1 << log2_size
    if transform_skip_allowed and not tq_bypass:
        e.encode_bin(cm.at("transform_skip_flag", 1 if c_idx else 0), ts_flag)
    skip_like = bool(ts_flag or tq_bypass)
    if rext is not None and rext.explicit_rdpcm and pred_inter and skip_like:
        e.encode_bin(cm.at("explicit_rdpcm_flag", 1 if c_idx else 0),
                     rdpcm_flag)
        if rdpcm_flag:
            e.encode_bin(cm.at("explicit_rdpcm_dir_flag",
                               1 if c_idx else 0), rdpcm_dir)
    ts_ctx = bool(rext is not None and rext.ts_context and skip_like)
    sdh_off = bool(tq_bypass or rdpcm_flag
                   or (rext is not None and rext.implicit_rdpcm
                       and not pred_inter and ts_flag
                       and intra_mode in (10, 26)))
    use_price = bool(rext is not None and rext.persistent_rice)
    sb_type = (2 if c_idx == 0 else 0) + (1 if skip_like else 0)

    sub_scan, coef_scan, pos_of_xy = block_scan(scan_idx, log2_size)
    nz = levels != 0
    assert nz.any(), "encode_residual requires a nonzero block (cbf=1)"
    last_pos = int(pos_of_xy[nz].max())
    last_sb, last_n = last_pos >> 4, last_pos & 15
    ly, lx = np.argwhere(pos_of_xy == last_pos)[0]
    last_x, last_y = int(lx), int(ly)
    if scan_idx == SCAN_VERT:
        last_x, last_y = last_y, last_x

    off, shift = _last_ctx_params(log2_size, c_idx)
    cmax = (log2_size << 1) - 1
    nb_x, suf_x = _encode_last_component(
        e, cm, "last_sig_coeff_x_prefix", last_x, off, shift, cmax)
    nb_y, suf_y = _encode_last_component(
        e, cm, "last_sig_coeff_y_prefix", last_y, off, shift, cmax)
    if nb_x:
        e.encode_bypass_bits(suf_x, nb_x)
    if nb_y:
        e.encode_bypass_bits(suf_y, nb_y)

    nsb = max(1, size >> 2)
    csbf = np.zeros((nsb, nsb), np.uint8)
    # precompute which sub-blocks have nonzeros
    for i in range(last_sb, -1, -1):
        xs, ys = int(sub_scan[i][0]), int(sub_scan[i][1])
        blk = levels[ys << 2:(ys << 2) + 4, xs << 2:(xs << 2) + 4]
        csbf[ys, xs] = 1 if (blk != 0).any() else 0
    # last and DC sub-blocks have inferred csbf == 1
    csbf[int(sub_scan[last_sb][1]), int(sub_scan[last_sb][0])] = 1
    csbf[int(sub_scan[0][1]), int(sub_scan[0][0])] = 1
    csbf_dec = np.zeros_like(csbf)  # decoder-visible state during the scan

    c1 = 1
    for i in range(last_sb, -1, -1):
        xs, ys = int(sub_scan[i][0]), int(sub_scan[i][1])
        blk = levels[ys << 2:(ys << 2) + 4, xs << 2:(xs << 2) + 4]
        sbf = int(csbf[ys, xs])
        infer_dc = 0
        if 0 < i < last_sb:
            right = int(csbf_dec[ys, xs + 1]) if xs + 1 < nsb else 0
            below = int(csbf_dec[ys + 1, xs]) if ys + 1 < nsb else 0
            ctx = min(1, right + below) + (2 if c_idx else 0)
            e.encode_bin(cm.at("coded_sub_block_flag", ctx), sbf)
            infer_dc = 1
        csbf_dec[ys, xs] = sbf
        if not sbf:
            continue

        sig_pos = []
        if i == last_sb:
            sig_pos.append(last_n)
            n_start = last_n - 1
        else:
            n_start = 15
        for n in range(n_start, 0, -1):
            xp, yp = int(coef_scan[n][0]), int(coef_scan[n][1])
            sig = 1 if blk[yp, xp] != 0 else 0
            if ts_ctx:
                ctx = 42 if c_idx == 0 else 43
            else:
                ctx = _sig_ctx(log2_size, c_idx, (xs << 2) + xp,
                               (ys << 2) + yp, scan_idx, csbf_dec, nsb)
            e.encode_bin(cm.at("sig_coeff_flag", ctx), sig)
            if sig:
                sig_pos.append(n)
                infer_dc = 0
        if n_start >= 0:
            dc_sig = 1 if blk[0, 0] != 0 else 0
            if infer_dc:
                assert dc_sig, "csbf=1 sub-block with all-zero coeffs"
                sig_pos.append(0)
            else:
                if ts_ctx:
                    ctx = 42 if c_idx == 0 else 43
                else:
                    ctx = _sig_ctx(log2_size, c_idx, xs << 2, ys << 2,
                                   scan_idx, csbf_dec, nsb)
                e.encode_bin(cm.at("sig_coeff_flag", ctx), dc_sig)
                if dc_sig:
                    sig_pos.append(0)
        nsig = len(sig_pos)
        if nsig == 0:
            continue

        def coef(n):
            xp, yp = int(coef_scan[n][0]), int(coef_scan[n][1])
            return int(blk[yp, xp])

        ctx_set = (2 if (i > 0 and c_idx == 0) else 0) + (1 if c1 == 0 else 0)
        c1 = 1
        gt2_target = -1
        for n in sig_pos[:8]:
            f = 1 if abs(coef(n)) > 1 else 0
            base = (16 if c_idx else 0) + 4 * ctx_set + c1
            e.encode_bin(cm.at("coeff_abs_level_greater1_flag", base), f)
            if f:
                if gt2_target < 0:
                    gt2_target = n
                c1 = 0
            elif 0 < c1 < 3:
                c1 += 1
        if gt2_target >= 0:
            g2 = 1 if abs(coef(gt2_target)) > 2 else 0
            e.encode_bin(cm.at("coeff_abs_level_greater2_flag",
                               (4 if c_idx else 0) + ctx_set), g2)

        first_nz, last_nz = sig_pos[-1], sig_pos[0]
        hidden = (sign_data_hiding and not sdh_off
                  and (last_nz - first_nz) >= 4)
        sum_abs = sum(abs(coef(n)) for n in sig_pos)
        for m, n in enumerate(sig_pos):
            if hidden and m == nsig - 1:
                want = -1 if (sum_abs & 1) else 1
                assert (coef(n) < 0) == (want < 0), \
                    "sign-data-hiding parity not satisfied by quantizer"
                continue
            e.encode_bypass(1 if coef(n) < 0 else 0)

        rice = (rext.stats[sb_type] >> 2) if use_price else 0
        stat_pending = use_price
        for m, n in enumerate(sig_pos):
            lvl = abs(coef(n))
            if m < 8:
                g1 = 1 if lvl > 1 else 0
                if n == gt2_target:
                    g2 = 1 if lvl > 2 else 0
                    base = 1 + g1 + g2
                    threshold = 3
                else:
                    base = 1 + g1
                    threshold = 2
            else:
                base = 1
                threshold = 1
            if base == threshold:
                encode_remaining(e, lvl - base, rice)
                if use_price:
                    if lvl > (3 << rice):
                        rice += 1
                    if stat_pending:
                        init = rext.stats[sb_type] >> 2
                        rem = lvl - base
                        if rem >= (3 << init):
                            rext.stats[sb_type] += 1
                        elif 2 * rem < (1 << init) \
                                and rext.stats[sb_type] > 0:
                            rext.stats[sb_type] -= 1
                        stat_pending = False
                elif lvl > (3 << rice):
                    rice = min(rice + 1, 4)
            else:
                assert lvl == base
