"""The port's device-resident frame program and its host plumbing.

Port of ``hevc_tpu/tpu/pipeline.py``: ``frame_program`` is
``_pipeline_frame`` (residual kernel -> MC kernel -> residual-add kernel
-> intra wavefront kernel -> deblocking kernels -> SAO kernel, then
edge-padding of the planes into the device DPB and one fused output
buffer), ``finish_frame`` is ``finish_frame_pipeline``, ``LazyPlanes`` the
deferred host fetch and ``pad_dev_refs`` seeds a device DPB from device
planes (the SHVC inter-layer reference).  Reference planes stay on the
device between frames; only the packed metadata goes up and only the fused
output comes back.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from . import mc_cuda
from . import native as N
from . import trace
from . import upsample as UP
from .coding.picture import crop_conf_win
from .filters_cuda import deblock_planes, sao_planes
from .intra import chunk_counts
from .intra_cuda import reconstruct_wavefront
from .pack import PAD_REF, pack_frame
from .resid_cuda import residuals
from .tables import (dpb_from_numpy, pad_refs, tables_from_reference,
                     upload)

I32 = torch.int32

# references ``finish_frame`` took from host planes because the device DPB
# lacked them (a concealed or never-decoded picture); every decoded
# reference, the SHVC inter-layer one included, resolves on the device
host_refs = {"count": 0}

# spec features the frame program leaves out on purpose
_UNPORTED = (
    ("pallas", "the TPU-aligned pack layout is a TPU workaround the port "
               "leaves out (ROADMAP, 'Hopper, not TPU'); pack unaligned"),
)


def _check_spec(S):
    for key, why in _UNPORTED:
        if S.get(key):
            raise NotImplementedError(f"hevc_tpu_torch: {why}")


def scatter_levels(idx, val, total):
    """The dense int16 level pool of ``total`` entries from its (idx, val)
    pairs on their device (``pack.coo_pairs``).  The padding pairs carry
    the index ``total``: they land in one spare entry that is cut off, as
    torch drops no out-of-range index (JAX's ``mode="drop"`` does)."""
    dense = torch.zeros(total + 1, dtype=torch.int16, device=idx.device)
    dense[idx.long()] = val
    return dense[:total]


def host_views(meta, meta16, S):
    """Host views of a pack's buffers in the frame program's layout:
    (intra records [n_chunks, B_c, 8], residual rows [N_c, 9], inter
    residual rows [R_c, 3]) per class from ``meta`` (int32, in that
    order), and the MC groups (is_ch, bi, wp, kind, w, h, rows [n, 17])
    from ``meta16``; ``S`` is the pack's spec as a dict."""
    pos = 0

    def take(n, shape):
        nonlocal pos
        out = meta[pos:pos + n].reshape(shape)
        pos += n
        return out

    nc = S["n_chunks"]
    scal = [take(nc * S["B"][c] * 8, (nc, S["B"][c], 8)) for c in range(4)]
    rmeta = [take(S["nlv"][c] * 9, (S["nlv"][c], 9)) for c in range(4)]
    fields = [take(S["resid_rows"][c] * 3, (S["resid_rows"][c], 3))
              for c in range(4)]
    meta16 = np.asarray(meta16)
    groups, pos16 = [], 0
    for is_ch, bi, wp, kind, w, h, nrow in S["mc_groups"]:
        groups.append((is_ch, bi, wp, kind, w, h,
                       meta16[pos16:pos16 + nrow * 17].reshape(nrow, 17)))
        pos16 += nrow * 17
    return scal, rmeta, fields, groups


def frame_program(meta, meta16, meta8, avail_u8, levels16, scale_bank,
                  canvas0, refs_y, refs_cb, refs_cr, spec, device):
    """One frame's stage B on ``device`` from the packed host buffers.

    meta/meta16/meta8/avail_u8/levels16: NumPy buffers from a pack (this
    package's or the JAX package's unaligned one), levels16 the (idx, val)
    pairs where the spec's ``coo`` says so; scale_bank: per class
    [7, s, s] int32 (NumPy or tensors); canvas0: the canvas shape, or a
    host canvas (PCM samples); refs_*: PAD_REF-padded int32 reference
    planes on ``device``.  Returns (fused output buffer, pad_y, pad_cb,
    pad_cr): the buffer is uint8 (8-bit) or int16 (deeper) planes back to
    back (the luma plane alone for 4:0:0), the pads int32 PAD_REF
    replication-padded references (4:0:0: luma in all three)."""
    S = dict(spec)
    _check_spec(S)
    tables = tables_from_reference(device)
    bd = S["bd"]
    n_chunks = S["n_chunks"]
    h4, w4 = S["h4"], S["w4"]
    cth, ctw = S["ctb_h"], S["ctb_w"]

    # host side: which wavefront chunks hold intra records, per class; the
    # MC rows stay on the host: mc_cuda builds the kernel's one row table
    # from them and uploads it
    meta = np.asarray(meta, np.int32)
    scal_np, _rmeta, _fields, mc_groups = host_views(meta, meta16, S)
    counts = chunk_counts(scal_np)

    with trace.span("dispatch.upload"):
        meta_d = upload(meta, device)
        meta8_d = upload(meta8, device)
        avail_d = upload(avail_u8, device)
        coo_n, total = S["coo"]
        if coo_n:
            # sparse upload: the dense pool is rebuilt on the device
            levels_d = scatter_levels(upload(levels16[0], device),
                                      upload(levels16[1], device), total)
        else:
            levels_d = upload(levels16, device)

    pos = 0

    def take(n, shape):
        nonlocal pos
        out = meta_d[pos:pos + n].view(shape)
        pos += n
        return out

    scal = [take(n_chunks * S["B"][c] * 8, (n_chunks, S["B"][c], 8))
            for c in range(4)]
    rmeta = [take(S["nlv"][c] * 9, (S["nlv"][c], 9)) for c in range(4)]
    resid_fields = [take(S["resid_rows"][c] * 3, (S["resid_rows"][c], 3))
                    for c in range(4)]
    sao_t = take(3 * cth * ctw, (3, cth, ctw))
    sao_b = take(3 * cth * ctw, (3, cth, ctw))
    sao_e = take(3 * cth * ctw, (3, cth, ctw))
    sao_o = take(3 * cth * ctw * 4, (3, cth, ctw, 4))
    pos8 = 0

    def take8(n, shape):
        nonlocal pos8
        out = meta8_d[pos8:pos8 + n].view(shape).to(I32)
        pos8 += n
        return out

    qp4, bs_v, bs_h = (take8(h4 * w4, (h4, w4)) for _ in range(3))
    dboff = take(4, (4,))
    beta_off, tc_off = dboff[0], dboff[1]
    sao_flags = nf4 = None
    if S["per_slice"]:
        beta_off = take8(h4 * w4, (h4, w4))
        tc_off = take8(h4 * w4, (h4, w4))
        sao_flags = take8(cth * ctw, (cth, ctw)) & 0xFF
    if S["nf"]:
        # PCM/TQB loop-filter exemption, per 4x4 (8.7.2/8.7.3)
        nf4 = take8(h4 * w4, (h4, w4))

    apos = 0
    avail = []
    for c in range(4):
        n = n_chunks * S["B"][c] * 128
        avail.append(avail_d[apos:apos + n].view(n_chunks, S["B"][c], 128)
                     != 0)
        apos += n
    # the int16 pool's classes as views: the residual kernel reads them
    lpos = 0
    levels = []
    for c, s in enumerate((4, 8, 16, 32)):
        n = S["nlv"][c] * s * s
        levels.append(levels_d[lpos:lpos + n].view(S["nlv"][c], s, s))
        lpos += n

    with trace.span("dispatch.residuals"):
        bank = [torch.as_tensor(b, device=device).to(I32)
                for b in scale_bank]
        resids = residuals(levels, rmeta, bd, bank, tables)

    with trace.span("dispatch.mc"):
        if isinstance(canvas0, tuple):
            canvas = torch.zeros(canvas0, dtype=I32, device=device)
        else:
            canvas = upload(canvas0, device).to(I32)
        mono = S["mono"]
        if S["n_refs"]:
            refs_l = torch.stack(list(refs_y))
            # 4:0:0 has no chroma MC rows: the luma stack stands in for the
            # chroma operand, which is never read
            refs_c = refs_l if mono else torch.stack(list(refs_cb)
                                                     + list(refs_cr))
            mc_cuda.mc(canvas, refs_l, refs_c, mc_groups, bd)
        mc_cuda.resid_add(canvas, resid_fields, resids, bd)
    with trace.span("dispatch.intra"):
        out = reconstruct_wavefront(canvas, scal, avail, resids, bd, tables,
                                    counts)
    regions = S["regions"][:1] if mono else S["regions"]
    planes = [out[oy:oy + h, ox:ox + w] for oy, ox, h, w in regions]
    # deblocking filters these views of ``out`` in place (on every device):
    # from here ``out`` holds the deblocked picture; SAO writes new planes
    with trace.span("dispatch.deblock"):
        if S["do_deblock"]:
            planes = deblock_planes(planes, qp4, bs_v, bs_h, beta_off,
                                    tc_off, (dboff[2], dboff[3]), tables, bd,
                                    S["sub_w"], S["sub_h"], nf4)
    with trace.span("dispatch.sao"):
        if S["do_sao"]:
            planes = sao_planes(planes, sao_t, sao_b, sao_o, sao_e,
                                S["ctb_log2"], bd, S["sub_w"], S["sub_h"],
                                sao_flags, nf4)
    with trace.span("dispatch.output"):
        odt = torch.uint8 if bd <= 8 else torch.int16
        flat = torch.cat([p.to(odt).reshape(-1) for p in planes])
        return (flat, *pad_refs(planes))


_FLAT_BANKS = {}


def _scale_bank_dev(pic, device):
    """Device copies of the picture's scaling-matrix banks, cached on the
    active ScalingListData (flat banks: per device)."""
    key = str(device)
    scaling = getattr(pic, "scaling", None)
    cache = _FLAT_BANKS if scaling is None else \
        scaling.__dict__.setdefault("_torch_banks", {})
    got = cache.get(key)
    if got is None:
        got = cache[key] = tuple(upload(b, device)
                                 for b in N._scale_bank(pic))
    return got


def pad_dev_refs(planes, aligned=False):
    """Device planes -> PAD_REF-padded int32 reference planes on their
    device, with no host round trip (the SHVC inter-layer reference seeds
    the EL's device DPB this way); the twin of ``tables.dpb_from_numpy``.
    ``aligned`` is the reference's TPU layout, which the port refuses as
    ``_UNPORTED``'s ``pallas``."""
    if aligned:
        raise NotImplementedError(f"hevc_tpu_torch: {_UNPORTED[0][1]}")
    return pad_refs(planes)


def inter_layer_ref(bl_dpb_dev, el_dpb_dev, bl_poc, cgs, el_sps, bl_bd):
    """The SHVC inter-layer reference of one EL picture, device to device.

    Runs on the decoder's ordered pack worker, after the base layer's frame
    program for ``bl_poc``: takes the interior of that picture's padded
    planes in ``bl_dpb_dev`` (its coded size), colour-maps them through
    the PPS 3D-LUT ``cgs`` if there is one, upsamples them to the EL's
    coded size and seeds ``el_dpb_dev[bl_poc]`` with the padded result.
    Returns the unpadded inter-layer planes."""
    pads = bl_dpb_dev.get(bl_poc)
    if pads is None:
        raise RuntimeError(
            f"hevc_tpu_torch: base-layer picture poc {bl_poc} is not in the "
            "base layer's device DPB; the inter-layer reference is built "
            "on the device only")
    planes = [p[PAD_REF:-PAD_REF, PAD_REF:-PAD_REF] for p in pads]
    if cgs is not None:
        with trace.span("il_color_map"):
            planes = UP.color_map_frame(cgs, planes)
        bl_bd = cgs.out_bd_y
    with trace.span("il_upsample"):
        il = UP.upsample_frame(planes, el_sps.width, el_sps.height,
                               sub_w=el_sps.sub_w, sub_h=el_sps.sub_h,
                               bl_bit_depth=bl_bd,
                               el_bit_depth=el_sps.bit_depth_luma)
    with trace.span("il_pad"):
        el_dpb_dev[bl_poc] = pad_dev_refs(il)
    return il


def _fused(dev):
    """Whether ``dev`` is the frame program's ``(flat, ((h, w), ...))``
    form rather than a sequence of planes."""
    return (len(dev) == 2 and isinstance(dev[1], tuple) and bool(dev[1])
            and isinstance(dev[1][0], tuple))


def _job(dev) -> dict:
    """The picture id and parent of a span about ``dev``'s pack job: that
    job's span (the future's ``handoff``), or none for a plain value."""
    h = getattr(dev, "handoff", None)
    return {} if h is None else {"pic": h.pic, "parent": h.id}


class LazyPlanes:
    """List-like deferred fetch of a frame's device planes.

    Wraps the fused ``(flat_buffer, ((h, w), ...))`` form, a sequence of
    device planes (the SHVC inter-layer reference), or a Future resolving
    to either (the pack worker's handle).  The planes are fetched to NumPy
    (the fused buffer as uint8, or uint16 past 8 bits) on first element
    access and cached; ``crop`` is the SPS for conformance-window cropping
    and ``dtype`` converts on materialisation (the DPB wants int32)."""

    __slots__ = ("_dev", "_np", "_crop", "_dtype", "_lock")

    def __init__(self, dev_out, crop=None, dtype=None):
        self._dev = dev_out
        self._np = None
        self._crop = crop
        self._dtype = dtype
        self._lock = threading.Lock()

    def _resolved(self):
        dev = self._dev
        if not hasattr(dev, "result"):
            return dev
        if not dev.done():
            # the caller blocked on the pack worker, apart from the copy
            with trace.span("output_wait", **_job(dev)):
                return dev.result()
        return dev.result()

    def device_ready(self):
        """Block until the frame's device work is enqueued and done, moving
        no pixels to the host (the benchmarks' synchronisation point): waits
        on the pack worker's future, then on the card."""
        dev = self._resolved()
        if dev is None:
            return  # already materialised
        t = dev[0]
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def device_planes(self):
        """The planes as device tensors (views of the fused buffer), or
        None once materialised."""
        dev = self._resolved()
        if dev is None:
            return None
        if not _fused(dev):
            return list(dev)
        planes, off = [], 0
        for h, w in dev[1]:
            planes.append(dev[0][off:off + h * w].view(h, w))
            off += h * w
        return planes

    def _mat(self):
        with self._lock:
            if self._np is None:
                job = _job(self._dev)
                dev = self._resolved()
                if _fused(dev):
                    with trace.span("fetch", **job):
                        buf = dev[0].cpu().numpy()
                    trace.count("d2h_bytes", buf.nbytes)
                    if buf.dtype == np.int16:
                        buf = buf.view(np.uint16)
                    planes, off = [], 0
                    for h, w in dev[1]:
                        planes.append(buf[off:off + h * w].reshape(h, w))
                        off += h * w
                else:
                    with trace.span("fetch", **job):
                        planes = [d.cpu().numpy() for d in dev]
                    trace.count("d2h_bytes", sum(p.nbytes for p in planes))
                if self._dtype is not None:
                    planes = [p.astype(self._dtype) for p in planes]
                if self._crop is not None:
                    planes = crop_conf_win(planes, self._crop)
                self._np = planes
                self._dev = None
            return self._np

    def __getitem__(self, i):
        return self._mat()[i]

    def __len__(self):
        if self._np is not None:
            return len(self._np)
        dev = self._resolved()
        return len(dev[1]) if _fused(dev) else len(dev)

    def __iter__(self):
        return iter(self._mat())


def finish_frame(pic, lay, poc, device):
    """Pack one picture and launch its frame program on ``device``.

    Runs on the decoder's ordered pack worker, which owns ``lay.dpb_dev``:
    every earlier frame's device references exist by the time this one
    packs.  Returns the fused ``(flat, shapes)`` output for LazyPlanes."""
    with trace.span("pack_native"):
        meta, meta16, meta8, avail_u8, levels16, canvas0, spec = \
            pack_frame(pic)
    dpb_dev = lay.dpb_dev
    refs_y, refs_cb, refs_cr = [], [], []
    for lst in (getattr(pic, "ref_list_l0", []) or [],
                getattr(pic, "ref_list_l1", []) or []):
        for entry in lst:
            pads = dpb_dev.get(entry[0])
            if pads is None:  # concealed / never-decoded reference
                host_refs["count"] += 1
                pads = dpb_from_numpy([np.asarray(p) for p in entry[1]],
                                      device)
            refs_y.append(pads[0])
            refs_cb.append(pads[1])
            refs_cr.append(pads[2])
    with trace.span("device_dispatch"):
        flat, pad_y, pad_cb, pad_cr = frame_program(
            meta, meta16, meta8, avail_u8, levels16,
            _scale_bank_dev(pic, device), canvas0, refs_y, refs_cb,
            refs_cr, spec, device)
    dpb_dev[poc] = (pad_y, pad_cb, pad_cr)
    # filters ran on the device
    pic.deblock_params = None
    if hasattr(pic, "sao_map"):
        pic.sao_map = {}
    pic.has_sao = False
    pic.sao_arrays = None
    S = dict(spec)
    regions = S["regions"][:1] if S["mono"] else S["regions"]
    shapes = tuple((h, w) for _oy, _ox, h, w in regions)
    return (flat, shapes)
