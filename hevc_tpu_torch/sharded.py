"""Column-band stage B over several devices, with halo exchange.

Port of ``hevc_tpu/tpu/sharded.py``: the reference's tile parallelism
(per-tile jobs, then a seam pass for the cross-tile filters) re-expressed
for several devices.  A tile-coded frame splits into equal column bands;
each band runs the whole of stage B on its device — residuals, MC (the
Hopper ``mc_kernel`` reading the band's reference windows), the residual
add (``resid_add_kernel``), the intra wavefront (``intra_chunk_kernel``),
deblocking and SAO — and neighbours exchange halo columns:

- deblocking: 16 luma columns of the unfiltered plane (``16 // sub_w``
  chroma, ``16 // 4`` of the per-4x4 maps: QP, boundary strength, and
  where the picture has them the slices' beta/tc offsets and the PCM/TQB
  exemption); the horizontal edges then filter on the band's interior
  alone;
- SAO: 1 column of the deblocked planes, validity and the slice/tile edge
  restrictions in frame coordinates;
- reference windows: ``halo_l`` / ``halo_c`` columns of each decoded band,
  so that the next pictures' MC reads only its own band's window.

Where the JAX package has a mesh and ``shard_map``, this module has a
``BandLayout``: the bands this process owns, each on an explicit device,
and optionally a ``torch.distributed`` group for the neighbours other
processes own.  A neighbour in the same process is a ``.to(device)`` copy
(over NVLink between cards); one in another process goes through
``dist.batch_isend_irecv`` (NCCL on cards, gloo on the CPU).  Bands at the
frame's edges receive zeros, which nothing reads: edges there carry bs = 0
and SAO validity is global.

Every band's device DPB entry is its halo-extended, PAD_REF-padded window,
kept while the pictures' RPS keeps it; no reference comes from the host: a
reference missing from the device DPB is an error.  The frame step of
``pgop_frame`` is this band step with one band.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import mc_cuda
from .band import mc_rows
from .filters import _chroma_pass, _keep, _luma_pass, _t, sao_plane
from .intra import chunk_counts
from .intra_cuda import reconstruct_wavefront
from .pack import PAD_REF
from .resid_cuda import residuals
from .tables import edge_pad, tables_from_reference, upload


class BandLayout:
    """The column bands this process runs, and where.

    devices: one device per local band, in band order (bands may share a
    device; on the CPU they all share ``cpu``).  distributed: the bands of
    a frame are spread over the ranks of the default ``torch.distributed``
    group, rank r owning bands r * L .. r * L + L - 1 for L = len(devices)
    (every rank owns as many)."""

    def __init__(self, devices, distributed=False):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a layout needs at least one band")
        self.rank = dist.get_rank() if distributed else 0
        self.world = dist.get_world_size() if distributed else 1
        self.n = len(self.devices) * self.world
        self.first = self.rank * len(self.devices)

    @classmethod
    def over(cls, n_bands, devices):
        """n_bands bands of one process over ``devices`` in contiguous
        blocks, so that most neighbours share a device."""
        devices = list(devices)
        return cls([devices[k * len(devices) // n_bands]
                    for k in range(n_bands)])

    @property
    def bands(self):
        return range(self.first, self.first + len(self.devices))


def _edge_cols(x, hw, right):
    """The hw columns at the left or right edge of x."""
    w = x.shape[1]
    return x[:, w - hw:] if right else x[:, :hw]


def _exchange(layout, fields):
    """Halo exchange of several fields at once.

    fields: (tensors of the local bands, width) pairs.  Returns, per field,
    per local band, (left, right): the ``width`` columns of the band's left
    neighbour's right edge and of its right neighbour's left edge, on the
    band's device; zeros at the frame's edges.  Neighbours in other ranks
    exchange in one ``batch_isend_irecv`` (tag = the field's index)."""
    nloc = len(layout.devices)
    ops, out = [], []
    for f, (xs, hw) in enumerate(fields):
        res = []
        for i, x in enumerate(xs):
            dev = layout.devices[i]
            k = layout.first + i
            sides = []
            for side in (0, 1):        # 0: left neighbour, 1: right
                nb = i - 1 if side == 0 else i + 1
                if 0 <= nb < nloc:
                    sides.append(_edge_cols(xs[nb], hw, side == 0).to(dev))
                    continue
                buf = torch.zeros((x.shape[0], hw), dtype=x.dtype,
                                  device=dev)
                kn = k - 1 if side == 0 else k + 1
                if 0 <= kn < layout.n:  # owned by the neighbouring rank
                    peer = layout.rank + (-1 if side == 0 else 1)
                    ops.append(dist.P2POp(
                        dist.isend, _edge_cols(x, hw, side == 1).contiguous(),
                        peer, tag=f))
                    ops.append(dist.P2POp(dist.irecv, buf, peer, tag=f))
                sides.append(buf)
            res.append(tuple(sides))
        out.append(res)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _cat(lr, x):
    return torch.cat([lr[0], x, lr[1]], 1)


def _nf_masks(nf4, sub_w, sub_h):
    """A per-4x4 PCM/TQB exemption map -> its luma and chroma pixel masks
    (as ``pipeline.frame_program`` derives them)."""
    if nf4 is None:
        return None, None
    nf_l = (nf4 != 0).repeat_interleave(4, 0).repeat_interleave(4, 1)
    return nf_l, nf_l[::sub_h, ::sub_w]


def _deblock_band(i, dev, ex, ys, cbs, crs, maps, scal, bd, sub_w, sub_h,
                  mono):
    """Deblocking of local band i: each plane's vertical edges on its halo
    extension (``ex``: the exchanged columns of the planes and the per-4x4
    maps), then its horizontal edges on the band alone; exempt samples
    restored after each pass, as ``filters.deblock`` does."""
    hl = 16
    hc = hl // sub_w
    tables = tables_from_reference(dev)
    qpc_tab = tables["qpc"] if sub_w == sub_h == 2 else None
    band = {k: m[i] for k, m in maps.items()}
    ext = {k: _cat(ex[k][i], m) for k, m in band.items() if k in ex}
    beta_e, tc_e = (ext.get(k, scal[k]) for k in ("beta", "tc"))
    beta_b, tc_b = (band.get(k, scal[k]) for k in ("beta", "tc"))
    nf_e = _nf_masks(ext.get("nf"), sub_w, sub_h)
    nf_b = _nf_masks(band.get("nf"), sub_w, sub_h)
    qt, bt = band["qp4"].t(), band["bs_h"].t()
    y_in, y_e = ys[i], _cat(ex["y"][i], ys[i])
    y = _keep(_luma_pass(y_e, ext["qp4"], ext["bs_v"], beta_e, tc_e, bd,
                         tables), y_e, nf_e[0])[:, hl:-hl]
    y = _luma_pass(y.t(), qt, bt, _t(beta_b), _t(tc_b), bd, tables).t()
    ys[i] = _keep(y, y_in, nf_b[0]).contiguous()
    if mono:
        return
    for name, cs, off in (("cb", cbs, scal["cb"]), ("cr", crs, scal["cr"])):
        c_in, c_e = cs[i], _cat(ex[name][i], cs[i])
        c = _keep(_chroma_pass(c_e, ext["qp4"], ext["bs_v"], tc_e, off, bd,
                               sub_h, sub_w, qpc_tab, tables),
                  c_e, nf_e[1])[:, hc:-hc]
        c = _chroma_pass(c.t(), qt, bt, _t(tc_b), off, bd, sub_w, sub_h,
                         qpc_tab, tables).t()
        cs[i] = _keep(c, c_in, nf_b[1]).contiguous()


def _filters(layout, ys, cbs, crs, maps, scal, sao, *, bd, ctb_log2, sub_w,
             sub_h, do_deblock, do_sao, mono=False):
    """Deblocking + SAO of the local bands (lists of int32 tensors, one per
    band, each on its device): vertical edges on a 16-luma-column halo of
    the unfiltered planes, horizontal edges on the band alone, then SAO on
    a 1-column halo of the deblocked planes.

    maps: per-4x4 maps, each a list over the bands: ``qp4``, ``bs_v``,
    ``bs_h`` (slice- and tile-gated), and where the picture has them the
    offset maps ``beta`` / ``tc`` and the PCM/TQB exemption ``nf``; scal:
    ``beta`` / ``tc`` (picture-wide offsets, where there are no maps),
    ``cb`` / ``cr`` (the chroma QP offsets) and ``sao_flags`` (per band the
    per-CTB SAO edge restrictions, or None).  sao: (type, band_pos, offs4,
    eo_class), each a list over the bands of per-plane maps [3, cty,
    band's ctx (, 4)].  4:0:0 (``mono``) filters the luma plane alone.
    Returns the three lists of filtered planes."""
    ys, cbs, crs = list(ys), list(cbs), list(crs)
    planes = [ys] if mono else [ys, cbs, crs]
    if do_deblock:
        hl = 16                   # luma halo (8-grid aligned)
        fields = {"y": (ys, hl)}
        fields.update((k, (maps[k], hl // 4)) for k in maps if k != "bs_h")
        if not mono:
            fields.update(cb=(cbs, hl // sub_w), cr=(crs, hl // sub_w))
        ex = dict(zip(fields, _exchange(layout, list(fields.values()))))
        for i, dev in enumerate(layout.devices):
            _deblock_band(i, dev, ex, ys, cbs, crs, maps, scal, bd, sub_w,
                          sub_h, mono)
    if do_sao:
        ex = _exchange(layout, [(ps, 1) for ps in planes])
        for p, ps in enumerate(planes):
            sub = (1, 1) if p == 0 else (sub_h, sub_w)
            lg = (ctb_log2 - sub[0].bit_length() + 1,
                  ctb_log2 - sub[1].bit_length() + 1)
            for i, x in enumerate(ps):
                wb = x.shape[1]
                nf = _nf_masks(maps["nf"][i], sub_w, sub_h)[min(p, 1)] \
                    if "nf" in maps else None
                ps[i] = sao_plane(
                    x, sao[0][i][p], sao[1][i][p], sao[2][i][p],
                    sao[3][i][p], lg, bd,
                    edge_flags=None if scal["sao_flags"] is None
                    else scal["sao_flags"][i],
                    nf=None if nf is None else nf[:x.shape[0], :wb],
                    halo=ex[p][i], x0=(layout.first + i) * wb,
                    w_frame=wb * layout.n)
    return ys, cbs, crs


def _cols(a, k, n, dev):
    """Columns k * n .. (k + 1) * n (axis 1) of a NumPy array, int32 on
    ``dev``."""
    return upload(np.asarray(a, np.int32)[:, k * n:(k + 1) * n], dev)


def _band_maps(layout, maps, n):
    """Per local band, ``maps``' columns of the band (n per band)."""
    return [_cols(maps, k, n, dev)
            for k, dev in zip(layout.bands, layout.devices)]


def _band_sao(layout, sao, ctb_cols):
    """(type, band_pos, offs4, eo_class), each 3 per-plane per-CTB maps ->
    the same, each a list over the local bands of 3 per-plane maps of the
    band's CTB columns."""
    return [[[_cols(m[p], k, ctb_cols, dev) for p in range(3)]
             for k, dev in zip(layout.bands, layout.devices)] for m in sao]


def _filter_maps(layout, band_w, ctb_log2, qp4, bs_v, bs_h, beta, tc,
                 cb_qp_off, cr_qp_off, sao_flags, no_filter):
    """The frame's filter inputs -> (maps, scal) of ``_filters``, each map
    cut into the local bands' columns on their devices."""
    quarter = band_w // 4
    named = dict(qp4=qp4, bs_v=bs_v, bs_h=bs_h, nf=no_filter)
    if np.ndim(beta) == 2:
        named.update(beta=beta, tc=tc)
    maps = {k: _band_maps(layout, a, quarter) for k, a in named.items()
            if a is not None}
    scal = dict(beta=beta, tc=tc, cb=cb_qp_off, cr=cr_qp_off,
                sao_flags=None if sao_flags is None else _band_maps(
                    layout, sao_flags, band_w >> ctb_log2))
    return maps, scal


def filter_frame_sharded(layout, y, cb, cr, qp4, bs_v, bs_h, beta_off,
                         tc_off, cb_qp_off, cr_qp_off, sao_type,
                         sao_band_pos, sao_offs4, sao_eo_class, *,
                         bit_depth, ctb_log2, sub_w=2, sub_h=2,
                         do_deblock=True, do_sao=True, edge_flags=None,
                         no_filter=None):
    """Deblocking + SAO of one frame in column bands over ``layout``.

    Planes are int32 NumPy [h, w] (luma) and subsampled (chroma); qp4 /
    bs_* the per-4x4 maps of the frame; beta_off / tc_off ints, or per-4x4
    maps of each 4x4's slice offsets; sao_* 3 per-plane per-CTB maps each
    (``recon.pack_sao_params``); edge_flags: optional per-CTB SAO edge
    restrictions (``ops.boundaries.SAO_*`` bits); no_filter: optional
    per-4x4 bool map of PCM/TQB samples no filter modifies.  Each band must
    be a whole number of CTBs.  Returns (y, cb, cr): the local bands'
    columns of the filtered planes, on the first local band's device."""
    w = np.shape(y)[1]
    if w % (layout.n << ctb_log2):
        raise ValueError(f"band width {w}/{layout.n} is not a multiple of "
                         "the CTB size")
    bw = w // layout.n
    maps, scal = _filter_maps(layout, bw, ctb_log2, qp4, bs_v, bs_h,
                              beta_off, tc_off, cb_qp_off, cr_qp_off,
                              edge_flags, no_filter)
    ys, cbs, crs = _filters(
        layout, _band_maps(layout, y, bw), _band_maps(layout, cb, bw // sub_w),
        _band_maps(layout, cr, bw // sub_w), maps, scal,
        _band_sao(layout, (sao_type, sao_band_pos, sao_offs4, sao_eo_class),
                  bw >> ctb_log2),
        bd=bit_depth, ctb_log2=ctb_log2, sub_w=sub_w, sub_h=sub_h,
        do_deblock=do_deblock, do_sao=do_sao)
    dev = layout.devices[0]
    return tuple(torch.cat([p.to(dev) for p in ps], 1)
                 for ps in (ys, cbs, crs))


# ---------------------------------------------------------------------------
# the banded stage B: residuals + MC + residual add + intra + filters
# ---------------------------------------------------------------------------

def _ref_windows(layout, planes, halos):
    """Each local band's decoded planes -> its reference windows: ``halo``
    columns of both neighbours (the MC-window exchange), replicated at the
    frame's edges, and PAD_REF replicated rows above and below.  planes:
    per plane, the local bands' tensors.  Returns per band a tuple of the
    three windows."""
    ex = _exchange(layout, list(zip(planes, halos)))
    out = []
    for i in range(len(layout.devices)):
        k = layout.first + i
        wins = []
        for p, ps in enumerate(planes):
            x, hw = ps[i], halos[p]
            left, right = ex[p][i]
            if k == 0:
                left = x[:, :1].expand(-1, hw)
            if k == layout.n - 1:
                right = x[:, -1:].expand(-1, hw)
            wins.append(edge_pad(torch.cat([left, x, right], 1), PAD_REF,
                                 PAD_REF, 0, 0))
        out.append(tuple(wins))
    return out


def band_recon(pf, refs, bd, dev):
    """Residuals, MC, residual add and the intra wavefront of one band's
    ``PackedFrame`` on ``dev``.  refs: (luma windows [R, H, W], chroma
    windows [2R, h, w]) or None.  Returns the band's unfiltered (y, cb,
    cr)."""
    tables = tables_from_reference(dev)
    canvas = upload(pf.canvas, dev)
    levels = [upload(np.asarray(v, np.int16), dev) for v in pf.levels]
    rmeta = [upload(m, dev) for m in pf.rmeta]
    bank = [upload(b, dev) for b in pf.scale_bank]
    resids = residuals(levels, rmeta, bd, bank, tables)
    if pf.mc_groups:
        mc_cuda.mc(canvas, refs[0], refs[1], mc_rows(pf.mc_groups), bd)
    mc_cuda.resid_add(canvas, [upload(g, dev) for g in pf.resid_groups],
                      resids, bd)
    out = reconstruct_wavefront(
        canvas, [upload(s, dev) for s in pf.scal],
        [upload(a, dev) for a in pf.avail], resids, bd, tables,
        chunk_counts(pf.scal))
    return [out[oy:oy + h, ox:ox + w]
            for oy, ox, h, w in (pf.region[p] for p in range(3))]


def band_step(layout, fb, halo_l, halo_c, dpb):
    """Stage B of one picture's bundle (``band._bundle_frame``) over the
    local bands: each band's recon reading its reference windows from
    ``dpb`` ({poc: [windows per local band]}, from which the pictures the
    picture's RPS no longer keeps are dropped first), the halo filters,
    then the picture's own windows into ``dpb``.  Returns [(y, cb, cr)] per
    local band, int32 on the band's device.  Raises KeyError for a
    reference that is not in ``dpb``."""
    if fb["n_bands"] != layout.n:
        raise ValueError(f"a bundle of {fb['n_bands']} bands on a layout "
                         f"of {layout.n}")
    bd, band_w, sub_w = fb["bit_depth"], fb["band_w"], fb["sub_w"]
    halos = (halo_l, halo_c, halo_c)
    for poc in [p for p in dpb if p not in fb["dpb_pocs"]]:
        del dpb[poc]
    pocs = list(fb["ref_pocs_l0"]) + list(fb["ref_pocs_l1"])
    missing = [p for p in pocs if p not in dpb]
    if missing:
        raise KeyError(f"POC {fb['poc']}: reference POC(s) {missing} not in "
                       "the device DPB (never decoded here)")
    recon = []
    for i, (k, dev) in enumerate(zip(layout.bands, layout.devices)):
        pf = fb["bands"][k]
        refs = None
        if pf.mc_groups:
            wins = [dpb[poc][i] for poc in pocs]
            refs = (torch.stack([w[0] for w in wins]),
                    torch.stack([w[1] for w in wins]
                                + [w[2] for w in wins]))
        recon.append(band_recon(pf, refs, bd, dev))

    fi, mono = fb["filters"], fb["mono"]
    maps, scal = _filter_maps(layout, band_w, fb["ctb_log2"], fi.qp4,
                              fi.bs_v, fi.bs_h, fi.beta, fi.tc, fi.cb_qp_off,
                              fi.cr_qp_off, fi.sao_flags, fi.no_filter)
    sao = _band_sao(layout, fb["sao"], band_w >> fb["ctb_log2"])
    ys, cbs, crs = _filters(
        layout, *zip(*recon), maps, scal, sao, bd=bd,
        ctb_log2=fb["ctb_log2"], sub_w=sub_w, sub_h=fb["sub_h"],
        do_deblock=fi.do_deblock, do_sao=fb["do_sao"], mono=mono)
    if mono:
        # 4:0:0: the luma windows stand in for the chroma ones, which no
        # MC row reads (as in the frame program's device DPB)
        wins = _ref_windows(layout, (ys,), (halo_l,))
        dpb[fb["poc"]] = [w * 3 for w in wins]
        return [(y,) for y in ys]
    dpb[fb["poc"]] = _ref_windows(layout, (ys, cbs, crs), halos)
    return list(zip(ys, cbs, crs))


def decode_gop_banded(layout, frames, halo_l=32, halo_c=16, dpb=None):
    """Decode bundles (``band.prepare_gop_banded``) with every stage-B phase
    in column bands over ``layout``.

    The device DPB (``dpb``: {poc: [per local band (y, cb, cr) windows]},
    new if None) holds each band's halo-extended reference windows of the
    pictures the RPS keeps; each picture's MC reads only its band's
    windows, and the windows refresh with one halo exchange per picture
    after the filters.  Returns, per picture, [(y, cb, cr)] of the local
    bands (``stitch`` joins them): every picture's planes, so a long
    stream goes through ``decode_stream_banded``."""
    dpb = {} if dpb is None else dpb
    return [band_step(layout, fb, halo_l, halo_c, dpb) for fb in frames]


def stitch(bands):
    """[(y, cb, cr)] (4:0:0: [(y,)]) of adjacent bands -> the planes of
    their columns as NumPy arrays."""
    return [np.concatenate([b[p].cpu().numpy() for b in bands], 1)
            for p in range(len(bands[0]))]


def _rewiden_dpb(layout, dpb, old_halo, new_halo):
    """The device DPB's reference windows at a wider halo: each window cut
    back to its band and exchanged again at the new width, on the
    devices."""
    ol, oc = old_halo
    out = {}
    for poc, per_band in dpb.items():
        planes = [[w[p][PAD_REF:w[p].shape[0] - PAD_REF,
                        oh:w[p].shape[1] - oh] for w in per_band]
                  for p, oh in enumerate((ol, oc, oc))]
        out[poc] = _ref_windows(layout, planes,
                                (new_halo[0], new_halo[1], new_halo[1]))
    return out


def decode_stream_banded(layout, frame_iter):
    """Streaming banded decode: consume ``band.iter_gop_banded``'s (bundle,
    halo) pairs as stage A produces them, re-sharding the device DPB (the
    references the RPS keeps) whenever a picture's MV bound widens the
    halo.  Yields, per picture in decode order, [(y, cb, cr)] of the local
    bands; nothing of a picture stays once the RPS drops it."""
    dpb = {}
    cur = None
    for fb, halo in frame_iter:
        if cur is not None and halo != cur:
            dpb = _rewiden_dpb(layout, dpb, cur, halo)
        cur = halo
        yield band_step(layout, fb, halo[0], halo[1], dpb)
