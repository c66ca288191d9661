"""Column bands of a tile-coded frame: the host side of the banded decode.

The host half of ``hevc_tpu/tpu/band.py`` (copied at 7a00da0; its
``unify_bands``, which pads every band to one shape for ``shard_map``, is
not ported: each band keeps its own shapes).  A stream coded with N
column tiles splits into N equal column bands.  Intra prediction,
residuals and the wavefront never cross a tile edge, so each band's
records pack on their own; MC does cross band edges, so each band's
reference windows are its columns extended by a halo of ``halo_l`` luma /
``halo_c`` chroma columns (``required_halo``: the stream's own MV bound).

``prepare_gop_banded`` runs stage A (``Decoder(recon_backend="plan")``,
whose NumPy planes are the oracle) and packs every picture's bands;
``iter_gop_banded`` does the same picture by picture from a worker
thread, widening the halo as the MV bound grows.  ``sharded`` runs the
bands on their devices.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .pack import PAD_REF, filter_inputs, pack_frame_plan
from .recon import pack_sao_params


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class BandHaloExceeded(Exception):
    """A frame's MV bound exceeds the current band halo (or a whole band):
    streaming consumers catch this and re-shard with a wider halo."""


class _BandSPS:
    """SPS view of one column band (width replaced, rest forwarded)."""

    def __init__(self, sps, band_w):
        self._sps = sps
        self.width = band_w

    def __getattr__(self, name):
        return getattr(self._sps, name)


class _BandPic:
    """PictureState view of one column band for ``pack_frame_plan``:
    availability queries translate band-local luma coordinates to frame
    coordinates."""

    def __init__(self, pic, band_x0, band_w):
        self._pic = pic
        self._x0 = band_x0
        self.sps = _BandSPS(pic.sps, band_w)
        self.scaling = getattr(pic, "scaling", None)
        self.ref_list_l0 = getattr(pic, "ref_list_l0", []) or []
        self.ref_list_l1 = getattr(pic, "ref_list_l1", []) or []

    def available(self, xl, yl, xn, yn):
        return self._pic.available(xl + self._x0, yl, xn + self._x0, yn)


def check_band_layout(pic, n_bands):
    """Raise ValueError unless the picture's tile columns are the n_bands
    bands (or there is one band): intra prediction and availability stop
    at a tile edge, so no record then reads across a band edge, and every
    band is a whole number of CTBs."""
    if n_bands == 1:
        return
    sps, pps = pic.sps, pic.pps
    band_w = sps.width // n_bands
    cols = [int(c) << sps.log2_ctb_size for c in pps.col_bd]
    if band_w * n_bands != sps.width or \
            cols != [k * band_w for k in range(n_bands + 1)]:
        raise ValueError(
            f"banded decode: the tile columns (luma edges {cols}) are not "
            f"the {n_bands} bands of {sps.width} columns")


def split_plan_bands(pic, plan, n_bands):
    """Partition a frame's BlockRecords into column bands, band-local x.
    The tile columns must be the bands (``check_band_layout``), so that no
    intra record predicts across a band edge."""
    check_band_layout(pic, n_bands)
    sps = pic.sps
    band_w = sps.width // n_bands
    out = [[] for _ in range(n_bands)]
    for r in plan:
        sx = sps.sub_w if r.plane else 1
        k = r.x * sx // band_w
        out[k].append(dataclasses.replace(r, x=r.x - k * band_w // sx))
    return out, band_w


def pack_frame_bands(pic, plan, n_bands, halo_l=32, halo_c=16, bands=None):
    """{band: PackedFrame} of the bands in ``bands`` (all by default), MC
    rows rebased to each band's reference window; and the band width."""
    band_plans, band_w = split_plan_bands(pic, plan, n_bands)
    sps = pic.sps
    pfs = {}
    for k in range(n_bands) if bands is None else bands:
        bp = _BandPic(pic, k * band_w, band_w)
        pf = pack_frame_plan(bp, band_plans[k])
        pfs[k] = _rebase_band_refs(pf, sps, band_w, halo_l, halo_c)
    return pfs, band_w


def _rebase_band_refs(pf, sps, band_w, halo_l, halo_c):
    """Rebase MC row x coordinates from PAD_REF- to halo-relative: a band's
    reference window is its columns with ``halo`` more on each side and
    PAD_REF rows above and below.  Raises BandHaloExceeded where a window
    leaves it."""
    if not pf.mc_groups:
        return pf
    widths = (band_w + 2 * halo_l, band_w // sps.sub_w + 2 * halo_c)
    groups = []
    for is_ch, bi, w, h, wp, fields in pf.mc_groups:
        f = fields.copy()
        shift = PAD_REF - (halo_c if is_ch else halo_l)
        ext = 3 if is_ch else 7
        for col in (2, 7) if bi else (2,):
            f[:, col] -= shift
            if not ((f[:, col] >= 0).all()
                    and (f[:, col] + w + ext <= widths[is_ch]).all()):
                raise BandHaloExceeded("MV exceeds band halo")
        groups.append((is_ch, bi, w, h, wp, f))
    return dataclasses.replace(pf, mc_groups=tuple(groups))


def mc_rows(mc_groups):
    """``PackedFrame.mc_groups`` ((is_chroma, bi, w, h, wp, fields); fields
    int32 [N, 7] uni or [N, 12] bi, 5 columns more with weighted
    prediction) -> the groups of ``mc_cuda.mc`` / ``mc.mc_plain``: (is_ch,
    bi, wp, 3, w, h, rows int32 [N, 17]) with the columns (sel, by, bx, fx,
    fy, sel1, by1, bx1, fx1, fy1, cy, cx, w0, o0, w1, o1, log2wd)."""
    out = []
    for is_ch, bi, w, h, wp, f in mc_groups:
        rows = np.zeros((f.shape[0], 17), np.int32)
        if bi:
            rows[:, :f.shape[1]] = f
        else:
            rows[:, :5] = f[:, :5]
            rows[:, 10:10 + f.shape[1] - 5] = f[:, 5:]
        out.append((bool(is_ch), bool(bi), bool(wp), 3, w, h, rows))
    return out


def required_halo_frame(plan, sps, n_bands):
    """``required_halo`` of one picture's records, for streaming consumers
    that cannot walk the whole GOP first."""
    return required_halo([plan], sps, n_bands)


def required_halo(plans, sps, n_bands):
    """The band reference-window halo of the stream's own MV bound: for
    every MC record, how far its qpel/epel read window overhangs its band
    (max |MV| plus the 7/3-tap extension).  Returns (halo_l, halo_c) in
    luma/chroma columns, 8/4-aligned."""
    band_w = sps.width // n_bands
    hl, hc = 8, 4  # floors: keep the exchanged slices non-trivial
    for plan in plans:
        for r in plan:
            if r.kind != "mc":
                continue
            mvs = [r.mv] + ([r.mv1] if r.bi else [])
            if r.plane == 0:
                x0b = (r.x // band_w) * band_w
                for mv in mvs:
                    rx = r.x + (mv[0] >> 2) - 3
                    hl = max(hl, x0b - rx, rx + r.size + 7 - (x0b + band_w))
            else:
                hs = sps.sub_w - 1
                bwc = band_w // sps.sub_w
                x0b = (r.x // bwc) * bwc
                for mv in mvs:
                    rx = r.x + (mv[0] >> (2 + hs)) - 1
                    hc = max(hc, x0b - rx, rx + r.size + 3 - (x0b + bwc))
    hl = _round_up(hl, 8)
    hc = _round_up(hc, 4)
    if hl > band_w or hc > band_w // sps.sub_w:
        raise BandHaloExceeded(
            "MV range exceeds one band: need more halo than a neighbour "
            "has; use fewer, wider bands")
    return hl, hc


def _has_sao(pic):
    return bool(getattr(pic, "has_sao", False)) \
        or bool(getattr(pic, "sao_map", None))


def check_banded(pic, n_bands):
    """Raise ValueError where the tile columns are not the bands
    (``check_band_layout``), and NotImplementedError for the pictures the
    JAX package's banded decode (``hevc_tpu.tpu.band`` /
    ``hevc_tpu.tpu.sharded``) raises on too: 4:0:0 with references, or
    with both deblocking and SAO; 4:2:2 with deblocking or SAO.  Several
    slices, tiles without loop filtering across them, the PCM/TQB filter
    exemption and the other 4:0:0 and 4:2:2 pictures decode."""
    check_band_layout(pic, n_bands)
    cf = pic.sps.chroma_format_idc
    sao = _has_sao(pic)
    if cf == 0 and (getattr(pic, "ref_list_l0", None)
                    or getattr(pic, "ref_list_l1", None)):
        raise NotImplementedError(
            "banded decode: a 4:0:0 picture with references (the JAX "
            "banded decode raises IndexError at hevc_tpu/tpu/pack.py:274, "
            "packing the chroma reference planes 4:0:0 has not)")
    deblock = getattr(pic, "deblock_params", None) is not None
    if cf == 0 and deblock and sao:
        raise NotImplementedError(
            "banded decode: 4:0:0 with deblocking and SAO (the JAX banded "
            "decode raises TypeError at hevc_tpu/tpu/sharded.py:72, its "
            "_sao_local on the placeholder chroma its deblocking cut)")
    if cf == 2 and deblock:
        raise NotImplementedError(
            "banded decode: 4:2:2 with deblocking (the JAX banded decode "
            "raises TypeError at hevc_tpu/tpu/filters.py:107, its chroma "
            "filter taking one subsampling factor)")
    if cf == 2 and sao:
        raise NotImplementedError(
            "banded decode: 4:2:2 with SAO (the JAX banded decode raises "
            "TypeError at hevc_tpu/tpu/sharded.py:72, _sao_local taking "
            "one chroma CTB size for both axes)")


def _capture_entry(pic, plan, dpb_pocs):
    return dict(pic=pic, plan=list(plan), dpb_pocs=tuple(dpb_pocs),
                ref_pocs_l0=[e[0] for e in
                             (getattr(pic, "ref_list_l0", []) or [])],
                ref_pocs_l1=[e[0] for e in
                             (getattr(pic, "ref_list_l1", []) or [])])


def capture_plans(stream: bytes):
    """Decode a stream with ``Decoder(recon_backend="plan")`` (native stage
    A, NumPy stage B and filters) and capture every picture's records.
    Returns (the decoded frames, in output order; one ``_capture_entry``
    dict a picture, in decode order)."""
    from .decoder.core import Decoder

    captured = []
    decoded = Decoder(recon_backend="plan", plan_hook=lambda *a: captured
                      .append(_capture_entry(*a))).decode_bytes(stream)
    if len(decoded) != len(captured):
        raise RuntimeError(f"{len(decoded)} pictures out, {len(captured)} "
                           "through stage B")
    return decoded, captured


def prepare_gop_banded(stream: bytes, n_bands, halo_l="auto", halo_c="auto",
                       bands=None):
    """Decode a stream's stage A on the host and bundle every picture for
    ``sharded.decode_gop_banded``.

    halo_l / halo_c: reference-window halo columns; "auto" takes them from
    the stream's MV bound (``required_halo``).  bands: the bands to pack
    (this process's; all by default).  Returns (frames, ref_planes, (halo_l,
    halo_c)): the bundles in decode order, each with ``md5_ok`` (the SEI
    MD5 check of the host decode: True, False, or None without an SEI), and
    the host decode's planes in the same order: the oracle, at the coded
    size (before conformance cropping), which the SEI MD5 covers."""
    decoded, captured = capture_plans(stream)
    for ent in captured:
        check_banded(ent["pic"], n_bands)
    if halo_l == "auto" or halo_c == "auto":
        hl, hc = required_halo([e["plan"] for e in captured],
                               captured[0]["pic"].sps, n_bands)
        halo_l = hl if halo_l == "auto" else halo_l
        halo_c = hc if halo_c == "auto" else halo_c
    # decoded is in output order, captured in decode order
    by_poc = {fr.poc: fr for fr in decoded}
    frames = []
    for ent in captured:
        fb = _bundle_frame(ent, n_bands, halo_l, halo_c, bands)
        fb["md5_ok"] = by_poc[fb["poc"]].md5_ok
        frames.append(fb)
    ref_planes = [[np.asarray(p) for p in ent["pic"].planes]
                  for ent in captured]
    return frames, ref_planes, (halo_l, halo_c)


def _bundle_frame(ent, n_bands, halo_l, halo_c, bands=None):
    """One picture's bundle for ``sharded.decode_gop_banded``: the packed
    bands, the picture-wide filter inputs (``pack.filter_inputs``, what
    the single-device pack ships: QP, gated boundary strengths, offsets or
    per-4x4 offset maps, SAO edge restrictions, PCM/TQB exemption) and SAO
    maps, the picture's reference POCs, and the POCs its DPB keeps
    (``dpb_pocs``: the device DPB drops every other picture)."""
    pic = ent["pic"]
    check_banded(pic, n_bands)
    sps = pic.sps
    pfs, band_w = pack_frame_bands(pic, ent["plan"], n_bands, halo_l,
                                   halo_c, bands)
    return dict(
        bands=pfs, n_bands=n_bands, band_w=band_w, poc=pic.poc,
        ref_pocs_l0=ent["ref_pocs_l0"], ref_pocs_l1=ent["ref_pocs_l1"],
        dpb_pocs=ent["dpb_pocs"], filters=filter_inputs(pic),
        sao=tuple(np.asarray(a) for a in pack_sao_params(pic)),
        do_sao=_has_sao(pic), mono=sps.chroma_format_idc == 0,
        bit_depth=sps.bit_depth_luma, ctb_log2=sps.log2_ctb_size,
        sub_w=sps.sub_w, sub_h=sps.sub_h)


def iter_gop_banded(stream: bytes, n_bands, margin_l=16, margin_c=8,
                    bands=None):
    """Streaming stage A: yield (bundle, (halo_l, halo_c)) per picture as
    stage A finishes it, from a worker thread feeding a queue, so the
    consumer's device work overlaps the parsing.  The halo comes from each
    picture's own MV bound (``required_halo_frame``) and widens, with a
    margin, whenever a picture outgrows it; the consumer re-shards its
    reference windows then (``sharded.decode_stream_banded``).  A consumer
    that stops early (or raises) stops the worker at its next picture."""
    import queue
    import threading

    from .decoder.core import Decoder

    q = queue.Queue(maxsize=4)
    done = object()
    stop = threading.Event()

    class Stopped(Exception):
        pass

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                pass
        raise Stopped

    def produce():
        dec = Decoder(recon_backend="plan",
                      plan_hook=lambda *a: put(_capture_entry(*a)))
        try:
            dec.decode_bytes(stream)
            put(done)
        except Stopped:
            pass
        except BaseException as e:  # noqa: BLE001 — surface to the consumer
            try:
                put(e)
            except Stopped:
                pass
        finally:
            dec.close()

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    halo_l = halo_c = 0
    try:
        while True:
            ent = q.get()
            if ent is done:
                break
            if isinstance(ent, BaseException):
                raise ent
            sps = ent["pic"].sps
            check_banded(ent["pic"], n_bands)
            hl, hc = required_halo_frame(ent["plan"], sps, n_bands)
            if hl > halo_l or hc > halo_c:
                band_w = sps.width // n_bands
                halo_l = min(_round_up(max(hl + margin_l, halo_l), 8),
                             band_w)
                halo_c = min(_round_up(max(hc + margin_c, halo_c), 4),
                             band_w // sps.sub_w)
            yield _bundle_frame(ent, n_bands, halo_l, halo_c, bands), \
                (halo_l, halo_c)
    finally:
        stop.set()
        t.join()
